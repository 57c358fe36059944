#!/usr/bin/env python3
"""The two CUDA kernels at each of their main-path call sites on one NVIDIA
card: device time, bound, plain version and the one-call PyTorch yardstick,
and, with a baseline, the package's kernels against an earlier build of them.

    python3 kernel_ab.py [--baseline DIR] [--out FILE]

The inputs are the main path's own: one ``process_stereo`` call on frame 0
of the KITTI-size sequence that ``chip_smoke.py`` renders, with the kernel
wrappers' arguments recorded (``chip_smoke.record_sites``).  Sites: FAST+NMS on each pyramid level (both
eyes) and on the whole pyramid; the window gather at the ORB atlas (45x45),
the SAD left windows (11x11) and right strips (11x21) each alone, and the
SAD pair in one ``gather_patches_multi`` launch.

``--baseline DIR``: DIR holds an earlier ``fast_nms.cu`` and
``gather_patches.cu`` with the one-launch-per-image C interface
(``fast_nms_launch``, ``gather_patches_launch``).  They are built with the
package's nvcc flags into ``DIR/_build/`` and each site is timed in turns
baseline, package, package, baseline, on the same inputs; every output is
checked bit for bit against the plain version.

Device times come from CUDA-graph replay (``chip_smoke.graph_ms``) of the
raw calls.  One line per site (``chip_smoke.fmt_site``), then the
nvidia-smi line; with ``--out FILE`` the full record is written there as
JSON.  Imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs


def build_baseline(src_dir: Path):
    """Build the earlier sources in ``src_dir``; returns ``(fast, gather)``
    callables with the package wrappers' signatures."""
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.ops import cuda_build

    out_dir = src_dir / "_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("fast_nms", "gather_patches"):
        so = out_dir / f"lib{name}_baseline.so"
        cmd = [cuda_build._find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
               str(src_dir / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for baseline {name}.cu:\n{res.stdout}{res.stderr}")
        libs[name] = ctypes.CDLL(str(so))
    fast_lib, gather_lib = libs["fast_nms"], libs["gather_patches"]

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def fast(img, th):
        x = img.contiguous()
        out = torch.empty_like(x)
        B = 1 if x.dim() == 2 else x.shape[0]
        H, W = x.shape[-2:]
        err = fast_lib.fast_nms_launch(ctypes.c_void_p(x.data_ptr()),
                                       ctypes.c_void_p(out.data_ptr()), ctypes.c_int(B),
                                       ctypes.c_int(H), ctypes.c_int(W),
                                       ctypes.c_float(th), stream())
        if err:
            raise RuntimeError(f"baseline fast_nms launch failed: {err}")
        return out

    def gather(img, y0, x0, ph, pw):
        ys = y0.to(torch.int32).contiguous()
        xs = x0.to(torch.int32).contiguous()
        out = torch.empty((ys.shape[0], ph, pw), dtype=torch.float32, device=img.device)
        H, W = img.shape
        err = gather_lib.gather_patches_launch(
            ctypes.c_void_p(img.contiguous().data_ptr()), ctypes.c_void_p(ys.data_ptr()),
            ctypes.c_void_p(xs.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(ys.shape[0]), ctypes.c_int(H), ctypes.c_int(W),
            ctypes.c_int(ph), ctypes.c_int(pw), stream())
        if err:
            raise RuntimeError(f"baseline gather_patches launch failed: {err}")
        return out

    return fast, gather


def turns(package, baseline):
    """Device ms per call of ``package`` and ``baseline`` (None: not run),
    in turns baseline, package, package, baseline; each value is the mean
    of its two turns."""
    if baseline is None:
        return cs.graph_ms(package), None
    acc = {"baseline": 0.0, "package": 0.0}
    for k in ("baseline", "package", "package", "baseline"):
        acc[k] += cs.graph_ms(baseline if k == "baseline" else package) / 2
    return acc["package"], acc["baseline"]


def flat(out):
    import torch

    return torch.cat([o.reshape(-1) for o in out]) if isinstance(out, list) else out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1

    from opendlv_perception_vision_orbslam2_tpu_torch.ops import fast_kernel, gather_kernel
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import SystemConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    base = build_baseline(args.baseline) if args.baseline else None
    cfg = SystemConfig()
    lefts, rights, _, _ = synthetic.render_stereo_sequence(cfg, n_frames=1, n_points=900,
                                                           seed=0, step=0.6)
    dev = torch.device("cuda", 0)
    levels, th, orb_job, sad_jobs = cs.record_sites(
        cfg, torch.from_numpy(lefts[0]).to(dev), torch.from_numpy(rights[0]).to(dev))
    rows = []

    def site(kernel, name, launches, launches_base, package, baseline, plain, n_bytes, n_ops,
             library=None, **extra):
        ref = flat(plain())
        for fn in (package, baseline):
            if fn is not None and not torch.equal(flat(fn()), ref):
                raise AssertionError(f"{kernel} {name}: kernel differs from plain version")
        ms, base_ms = turns(package, baseline)
        row = cs.site_row(name, launches, ms, cs.graph_ms(plain), n_bytes, n_ops,
                          cs.graph_ms(library) if library is not None else None,
                          baseline_ms=base_ms, baseline_launches=launches_base, **extra)
        rows.append(dict(kernel=kernel, **row))
        print(cs.fmt_site(kernel, row), flush=True)

    # -- FAST+NMS per level and per frame -----------------------------------
    for lvl, lv in enumerate(levels):
        n_bytes, n_ops, share = cs.fast_work([lv], th)
        site("fast_nms", f"level {lvl} {lv.shape[-1]}x{lv.shape[-2]} x2 alone", 0, 1,
             lambda lv=lv: fast_kernel.fast_nms(lv, th),
             (lambda lv=lv: base[0](lv, th)) if base else None,
             lambda lv=lv: fast_kernel.fast_nms_plain(lv, th), n_bytes, n_ops,
             candidate_share=round(share[0], 4))
    n_bytes, n_ops, shares = cs.fast_work(levels, th)
    site("fast_nms", "pyramid (per frame)", 1, len(levels),
         lambda: fast_kernel.fast_nms_pyramid(levels, th),
         (lambda: [base[0](lv, th) for lv in levels]) if base else None,
         lambda: [fast_kernel.fast_nms_plain(lv, th) for lv in levels], n_bytes, n_ops,
         candidate_share=[round(x, 4) for x in shares])

    # -- gather per site and per frame --------------------------------------
    for name, job, n in zip(("ORB atlas", "SAD left alone", "SAD right alone"),
                            (orb_job, *sad_jobs), (1, 0, 0)):
        site("gather_patches", f"{name} {job[3]}x{job[4]} N={job[1].shape[0]}", n, 1,
             lambda job=job: gather_kernel.gather_patches(*job),
             (lambda job=job: base[1](*job)) if base else None,
             lambda job=job: gather_kernel.gather_patches_plain(*job),
             cs.gather_bytes([job]), 0, library=cs.unfold_gather(*job))
    yardsticks = [cs.unfold_gather(*job) for job in sad_jobs]
    site("gather_patches", "SAD pair (gather_patches_multi)", 1, 2,
         lambda: gather_kernel.gather_patches_multi(sad_jobs),
         (lambda: [base[1](*job) for job in sad_jobs]) if base else None,
         lambda: gather_kernel.gather_patches_multi_plain(sad_jobs),
         cs.gather_bytes(sad_jobs), 0, library=lambda: [f() for f in yardsticks])

    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(device=torch.cuda.get_device_name(0), smi=smi,
                                            torch=torch.__version__, sites=rows), indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
