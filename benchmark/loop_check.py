"""Hold every loop correction the program applies in a cell against the plain
reference (``reference/loop.py``):

    python3 benchmark/loop_check.py --workload kitti00-stereo.revisit --seed 7 --seconds 51

The run is the benchmark's own (``harness/cell.py``), with its result as the
last line of standard output.  :func:`capture` wraps the engine's
``apply_loop``, the dispatch of a verified correction, and keeps references
to its inputs and its output; nothing is copied or waited for until the run
has ended.  :func:`judge_loops` then makes each applied correction's edge set
again from the same inputs (``build_essential_edges``), solves it with the
reference in float64 on the CPU, and compares the program's corrected
keyframe poses and points with it (``reference.loop.compare``: rotation in
degrees, translation over the graph's extent, point distance), and so the
reference's own solve on the edges rounded to bfloat16 (the control
``bf16``).  One line on standard error a loop; ``--out`` writes them all as
JSON; ``--limits`` (JSON) judges each against limits.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
for _path in (os.path.dirname(HERE), HERE):
    if _path not in sys.path:
        sys.path.insert(0, _path)

_GRAPH = ("kf_valid", "kf_id", "kf_T_cw", "covis", "loop_i", "loop_j", "loop_T", "loop_s",
          "loop_valid", "pt_pos", "pt_ref_kf", "pt_valid")


def capture(slam):
    """Wrap ``apply_loop`` in the engine's module ``slam``; returns the list
    the wrapper fills, one entry a dispatched correction, and a function that
    undoes the wrap."""
    kept, apply = [], slam.apply_loop

    def apply_kept(m, cur_slot, cand_slot, cur_id, cand_id, lm, valid, fix_scale=True):
        out = apply(m, cur_slot, cand_slot, cur_id, cand_id, lm, valid, fix_scale)
        kept.append(dict(graph={f: getattr(m, f) for f in _GRAPH}, cur=cur_slot, cand=cand_slot,
                         T_loop=lm.T_rel, s_loop=lm.s_rel, fix_scale=fix_scale,
                         T_out=out[0].kf_T_cw, pt_out=out[0].pt_pos, valid=out[1]))
        return out

    slam.apply_loop = apply_kept

    def undo():
        slam.apply_loop = apply
    return kept, undo


def judge_loops(kept, limits=None) -> list:
    """Each applied correction of ``kept`` against the reference, and the
    reference's bf16 control against it; with ``limits``, each judged."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models.loop_closing import (
        build_essential_edges,
    )
    from reference import loop as ref

    out = []
    for c in kept:
        if not bool(c["valid"]):
            continue
        g = c["graph"]
        m = SimpleNamespace(kf_capacity=g["kf_valid"].shape[0], **g)
        e = build_essential_edges(m, c["cur"], c["cand"], c["T_loop"], c["s_loop"])
        inputs = dict(T_cw=g["kf_T_cw"], kf_valid=g["kf_valid"], fixed=c["cand"], e_i=e.e_i,
                      e_j=e.e_j, e_T=e.e_T, e_s=e.e_s, e_w=e.e_w, e_valid=e.e_valid,
                      fix_scale=c["fix_scale"], pt_pos=g["pt_pos"], pt_ref_kf=g["pt_ref_kf"],
                      pt_valid=g["pt_valid"])
        t = time.perf_counter()
        solved = ref.correct(inputs)
        bf = ref.control("bf16", inputs)
        row = {"kf_ids": [int(g["kf_id"][c["cur"]]), int(g["kf_id"][c["cand"]])],
               "iters": solved["iters"], "cost0": solved["cost0"], "cost": solved["cost"],
               "program": ref.compare(c["T_out"], c["pt_out"], solved, g["kf_valid"],
                                      g["pt_valid"]),
               "moved": ref.compare(g["kf_T_cw"], g["pt_pos"], solved, g["kf_valid"],
                                    g["pt_valid"]),
               "bf16": ref.compare(bf["T_cw"], bf["pt_pos"], solved, g["kf_valid"],
                                   g["pt_valid"]),
               "reference_s": time.perf_counter() - t}
        if limits:
            row["program_ok"], _ = ref.judge(row["program"], limits)
            row["bf16_ok"], _ = ref.judge(row["bf16"], limits)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--limits", default=None, help="JSON: limits of the comparison")
    args = p.parse_args(argv)
    cache = os.path.join(HERE, "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")

    from harness import cell

    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam

    kept, undo = capture(slam)
    try:
        rc = cell.run(args.workload, args.seed, args.seconds, False, T_PROCESS)
    finally:
        undo()
    rows = judge_loops(kept, json.loads(args.limits) if args.limits else None)
    cell.log(f"loop check: {len(kept)} corrections dispatched, {len(rows)} applied")
    for r in rows:
        cell.log("loop check: " + json.dumps(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seed": args.seed, "loops": rows}, f)
    return rc


if __name__ == "__main__":
    sys.exit(main())
