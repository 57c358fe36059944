"""Run one cell of the benchmark that ``BENCHMARK.json`` defines:

    python3 benchmark/run.py --workload kitti00-stereo.explore --seed 7 --seconds 51 --trace 0

from the root of a checkout on a machine with the cell's cards.  The last
line of standard output is the run's result as one JSON object.  With
``--trace 1`` its metrics are the cell's per-layer ones.  ``--control <name>``
(``stale``, ``scale`` or ``bf16``) judges that control of the reference in
the program's place (see ``benchmark/reference``); the benchmark's own runs
never pass it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# the benchmark's own packages, then the checkout's root, where the program is
for _path in (os.path.dirname(HERE), HERE):
    if _path not in sys.path:
        sys.path.insert(0, _path)


def main(argv=None) -> int:
    from harness import cell

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=cell.CONTROLS, default=None)
    args = p.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(HERE, "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    try:
        import opendlv_perception_vision_orbslam2_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program is not in this checkout: {exc}", file=sys.stderr)
        return 4

    return cell.run(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS,
                    control=args.control)


if __name__ == "__main__":
    sys.exit(main())
