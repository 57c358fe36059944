#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failed check raises, so the exit code is non-zero
and the final line is not printed:

1. device: requires CUDA, prints nvidia-smi's name and power limit;
2. build: builds both CUDA kernels from ``csrc/`` with nvcc;
3. the fast_nms kernel vs its plain version, bit for bit: one
   ``fast_nms_pyramid`` launch over all 8 levels of both eyes of a rendered
   KITTI-size frame, of uniform random and of integer-valued 376x1241
   pairs, at thresholds 0, 7 and 20, and ``fast_nms`` on one image; then,
   per level and per frame, the device time (CUDA-graph replay), the bound,
   the share of it, the plain version's time and the share of candidates
   (pixels that pass the compass test);
4. the gather_patches kernel vs its plain version, bit for bit, at the
   frame's main-path sites: ORB atlas (45x45, N = 4000), SAD windows 11x11
   and strips 11x21 (N = 2048, ``gather_patches`` and one
   ``gather_patches_multi`` launch), and out-of-range starts that must
   clip; then per site the device time, bound, share, the one-call
   ``unfold`` yardstick (``library``) and the plain version's time;
5. the VO slice at KITTI size (1241x376, 2000 features, 8 levels) over the
   24-frame sequence bench.py renders: never lost, and the launch counters
   show 1 FAST (``fast_nms_pyramid``) and 2 gather launches
   (``gather_patches``, ``gather_patches_multi``) per frame;
6. where the VO time goes: front end vs tracking per frame, and the
   device's busy time and idle share from torch.profiler;
7. the KITTI-size ATE over EPnP-RANSAC draws (the constant per-frame seed
   set to 0-7), reported, not gated;
8. the accuracy gate: ATE < 0.10 m on the 512x256 12-frame fixture;
9. stereo SLAM (``StereoSlam`` without loop closing or relocalization) at
   KITTI size over the same 24 frames, in the production asynchronous
   mode: never lost, finite poses, >= 5 keyframes (so local BA and keyframe
   culling ran), and 1 FAST + 2 gather launches per frame; prints frames/s,
   ms/frame, keyframes, map points, capacities, peak device memory and the
   ATE (not gated);
10. where the SLAM time goes: ``track_frame_with_map``, ``insert_stage`` and
    ``mapping_stage`` split into point cull / triangulate / fuse / local BA
    / keyframe cull, with a sync on both sides, and the device busy time and
    idle share from torch.profiler;
11. the SLAM gate on the fixture and bounds of tests/test_slam.py: 14
    frames 512x256, never lost, >= 2 keyframes, > 100 points, ATE < 0.10 m,
    > 30 points triangulated beyond th_far with median relative error < 0.04.

Then one JSON line of kernel results (each kernel's per-frame numbers and
its sites), the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.  Imports no jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPLACES = {
    "fast_nms": "opendlv_perception_vision_orbslam2_tpu/ops/fast_pallas.py:98",
    "gather_patches": "opendlv_perception_vision_orbslam2_tpu/ops/gather_pallas.py:42",
}


# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FAST+NMS operations: every pixel takes the compass test (4 subtract + 8
# compare) and the 3x3 NMS (8 max + 1 compare); every polarity that passes
# the compass test takes 16 subtract and the 9-arc tree (64 min + 15 max).
FAST_OPS_PER_PIXEL = 21
FAST_OPS_PER_POLARITY = 95


def bound_ms(n_bytes: float, n_ops: float):
    """``(ms, "bytes" | "operations")``: the least time the card could take,
    the larger of bytes over the HBM rate and operations over the float32
    rate."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fast_work(levels, threshold: float):
    """``(bytes, ops, candidate share per level)`` of FAST+NMS over
    ``levels`` ``[B, H, W]``: each image read once and each map written
    once; the operations this data needs with the compass early-out
    (``ops/fast.py::compass_test``); the share of pixels that pass it for
    either polarity."""
    from opendlv_perception_vision_orbslam2_tpu_torch.ops.fast import compass_test

    n_bytes = n_ops = 0
    shares = []
    for lv in levels:
        bright, dark = compass_test(lv, threshold)
        n_bytes += 8 * lv.numel()
        n_ops += (FAST_OPS_PER_PIXEL * lv.numel()
                  + FAST_OPS_PER_POLARITY * int(bright.sum() + dark.sum()))
        shares.append(float((bright | dark).float().mean()))
    return n_bytes, n_ops, shares


def gather_bytes(jobs) -> int:
    """Bytes of window gathers ``(img, y0, x0, ph, pw)``: each window
    written once, each image pixel that some (clipped) window covers read
    once, and the int32 starts read once."""
    import torch

    n_bytes = 0
    for img, y0, x0, ph, pw in jobs:
        H, W = img.shape
        y = torch.clamp(y0.long(), 0, H - ph)
        x = torch.clamp(x0.long(), 0, W - pw)
        corners = torch.zeros((H + 1) * (W + 1), dtype=torch.int64, device=img.device)
        for dy, dx, sign in ((0, 0, 1), (0, pw, -1), (ph, 0, -1), (ph, pw, 1)):
            corners.index_add_(0, (y + dy) * (W + 1) + x + dx,
                               torch.full_like(y, sign))
        cover = corners.view(H + 1, W + 1).cumsum(0).cumsum(1)[:H, :W] > 0
        n = y0.shape[0]
        n_bytes += 4 * int(cover.sum()) + 4 * n * ph * pw + 8 * n
    return n_bytes


def unfold_gather(img, y0, x0, ph: int, pw: int):
    """The one-call PyTorch yardstick of a window gather, starts clipped
    first: returns the call (timed) that indexes a double ``unfold`` view."""
    import torch

    H, W = img.shape
    y = torch.clamp(y0.long(), 0, H - ph)
    x = torch.clamp(x0.long(), 0, W - pw)
    view = img.unfold(0, ph, 1).unfold(1, pw, 1)
    return lambda: view[y, x]

FAST_THRESHOLDS = (0.0, 7.0, 20.0)
# each kernel's wrappers, whose launch counters add up to the kernel's
KERNEL_WRAPPERS = {"fast_nms": ("fast_nms", "fast_nms_pyramid"),
                   "gather_patches": ("gather_patches", "gather_patches_multi")}


def _wrappers():
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import fast_kernel, gather_kernel

    mods = {"fast_nms": fast_kernel, "gather_patches": gather_kernel}
    return {w: getattr(mods[k], w) for k, ws in KERNEL_WRAPPERS.items() for w in ws}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def per_frame(counts: dict, n_frames: int) -> str:
    return ", ".join(f"{name} {v / n_frames:g}" for name, v in counts.items())


def kernel_launches(counts: dict, kernel: str) -> int:
    return sum(counts[w] for w in KERNEL_WRAPPERS[kernel])


def record_sites(cfg, left, right):
    """Run ``process_stereo`` once on ``left``/``right`` and return the main
    path's kernel inputs ``(levels, threshold, orb_job, sad_jobs)``, a job
    being ``(img, y0, x0, ph, pw)``."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import extractor, frontend
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import stereo

    rec = {}
    hooks = (
        (extractor, "fast_nms_pyramid", lambda levels, th: rec.update(levels=levels, th=th)),
        (extractor, "gather_patches", lambda *job: rec.update(orb=job)),
        (stereo, "gather_patches_multi", lambda jobs: rec.update(sad=list(jobs))),
    )
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in hooks]
    for (mod, name, fn), (_, _, hook) in zip(saved, hooks):
        setattr(mod, name, lambda *a, _fn=fn, _hook=hook: (_hook(*a), _fn(*a))[1])
    try:
        frontend.process_stereo(left, right, cfg, 0.0)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return list(rec["levels"]), rec["th"], tuple(rec["orb"]), [tuple(j) for j in rec["sad"]]


def site_row(site: str, launches: int, ms: float, plain_ms: float, n_bytes: int, n_ops: int,
             library_ms, **extra) -> dict:
    """One call site's numbers: device ms, its bound and share of it, the
    plain version's and the one-call yardstick's device ms."""
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return dict(site=site, launches_per_frame=launches, ms=ms, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes=n_bytes, ops=n_ops, **extra)


def kernel_fields(row: dict) -> dict:
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}


def fmt_site(kernel: str, row: dict) -> str:
    lib = f"{row['library_ms']:.4f} ms" if row["library_ms"] is not None else "none"
    extra = f" | candidate share {row['candidate_share']}" if "candidate_share" in row else ""
    if row.get("baseline_ms") is not None:
        extra += (f" | baseline {row['baseline_ms']:.4f} ms in {row['baseline_launches']} "
                  f"launch(es)")
    return (f"  {kernel} {row['site']}: {row['ms']:.4f} ms device, "
            f"{row['launches_per_frame']} launch(es) a frame | bound "
            f"{1e3 * row['bound_ms']:.2f} us ({row['bound_by']}; {row['bytes'] / 1e6:.2f} MB, "
            f"{row['ops'] / 1e6:.1f} M ops) | share of bound {row['share_of_bound']:.3f} | "
            f"library {lib} | plain {row['plain_ms']:.4f} ms{extra}")


def wall_ms(fn, iters: int = 20) -> float:
    """Mean ms per call of ``fn`` between CUDA events around ``iters``
    back-to-back calls, after a warm-up.  Where the host enqueues a call
    faster than the card runs it, this is device time; otherwise it is the
    host's time per call (Python, dispatch, ctypes)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph after a warm-up, its replays timed with CUDA events.  The host
    adds no time between the kernels of a replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def device_busy(fn, calls: int):
    """``(ms, ops)`` per call over ``calls`` calls of ``fn``: the durations
    of the kernels, copies and fills they put on the card, summed from
    torch.profiler's CUPTI trace.  Raises when the trace holds no device
    work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("torch.profiler traced no device work")
    return sum(e.time_range.elapsed_us() for e in dev) / calls / 1e3, len(dev) / calls


def timed_pair(kernel_fn, plain_fn):
    """Device ms (CUDA-graph replay) and wall ms per call of a kernel and of
    its plain version, measured in turns plain, kernel, kernel, plain; each
    value is the mean of its two turns."""
    acc = {"kernel": [0.0, 0.0], "plain": [0.0, 0.0]}
    for tag, fn in (("plain", plain_fn), ("kernel", kernel_fn),
                    ("kernel", kernel_fn), ("plain", plain_fn)):
        acc[tag][0] += graph_ms(fn) / 2
        acc[tag][1] += wall_ms(fn) / 2
    return {tag: dict(zip(("device_ms", "wall_ms"), v)) for tag, v in acc.items()}


def fmt_pair(t) -> str:
    k, p = t["kernel"], t["plain"]
    return (f"kernel {k['device_ms']:.4f} ms device, {k['wall_ms']:.4f} ms wall | "
            f"plain {p['device_ms']:.4f} ms device, {p['wall_ms']:.4f} ms wall")


def check_equal(name, out, ref):
    """Bit-for-bit check of a kernel's output against its plain version;
    returns the measured max abs difference (0.0)."""
    import torch

    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    if not torch.equal(out, ref):
        raise AssertionError(f"{name}: kernel differs from plain version (max abs err {err})")
    return err


SLAM_OFF = dict(enable_loop_closing=False, enable_relocalization=False)
# the mapping stage's passes, in the order mapping_stage runs them
MAPPING_PASSES = ("cull_points", "create_new_map_points", "run_fusion",
                  "local_mapping_step", "cull_keyframes")


def drive_slam(slam, lefts, rights, fps, start: int = 0):
    """Feed frames ``start..`` to ``slam``; a sync after each frame (a user
    reads each pose).  Raises if initialization fails, tracking is lost or a
    pose is not finite.  Returns seconds per frame."""
    import numpy as np
    import torch

    lat = []
    for i in range(start, start + lefts.shape[0]):
        t = time.perf_counter()
        T = slam.process(lefts[i - start], rights[i - start], timestamp=i / fps)
        if T is not None and T.is_cuda:
            torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        if T is None:
            raise AssertionError(f"SLAM: stereo initialization failed at frame {i}")
        if slam.lost:
            raise AssertionError(f"SLAM: tracking lost at frame {i}")
        if not np.isfinite(T.cpu().numpy()).all():
            raise AssertionError(f"SLAM: non-finite pose at frame {i}")
    return lat


def timed_layers(module, names, sink):
    """Wrap ``module.<name>`` for each name with a sync on both sides,
    appending seconds to ``sink[name]``; returns a restore function."""
    import torch

    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def inner(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            sink.setdefault(name, []).append(time.perf_counter() - t)
            return out
        return inner

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    return lambda: [setattr(module, n, fn) for n, fn in saved.items()]


def far_point_check(slam, world, th_far):
    """``(n_far, median relative error)`` of the map points beyond
    ``th_far`` + 1 m against the nearest world point (tests/test_slam.py)."""
    import numpy as np

    pts = slam.map.pt_pos.cpu().numpy()[slam.map.pt_valid.cpu().numpy()]
    far = pts[:, 2] > th_far + 1.0
    if not far.any():
        return 0, float("inf")
    d = np.linalg.norm(pts[far][:, None, :] - np.asarray(world.points)[None, :, :], axis=-1)
    return int(far.sum()), float(np.median(d.min(axis=1) / pts[far][:, 2]))


def main() -> int:
    import numpy as np
    import torch

    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.models import tracking
    from opendlv_perception_vision_orbslam2_tpu_torch.models.tracking import (
        StereoVisualOdometry,
    )
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import (
        cuda_build, fast_kernel, gather_kernel, image,
    )
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic, trajectory
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import (
        CameraConfig, OrbConfig, SystemConfig, TrackingConfig,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # one nvcc per source, both at once
        list(pool.map(cuda_build.load, ("fast_nms", "gather_patches")))
    build_s = time.perf_counter() - t0
    ptxas = []
    for name in ("fast_nms", "gather_patches"):
        log = Path(str(cuda_build.library_path(name)) + ".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines() if "Used" in ln]
    print(f"build: {build_s:.2f} s for 2 kernels (nvcc sm_90a); ptxas: {' / '.join(ptxas)}",
          flush=True)

    cfg = SystemConfig()  # KITTI-00 geometry, 2000 features, 8 levels
    cam, orb = cfg.camera, cfg.orb
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=24, n_points=900, seed=0, step=0.6
    )
    both = torch.from_numpy(np.stack([lefts[0], rights[0]])).to(dev)
    results = {}

    # -- 3. FAST+NMS kernel vs plain ----------------------------------------
    levels, th, orb_job, sad_jobs = record_sites(cfg, both[0], both[1])
    g = np.random.default_rng(0)
    noise = g.uniform(0, 255, (2, cam.height, cam.width)).astype(np.float32)
    pyramids = {"frame": levels}
    for kind, pair in (("random", noise), ("integer", np.round(noise))):
        pyramids[kind] = image.build_pyramid(torch.from_numpy(pair).to(dev), orb.n_levels,
                                             orb.scale_factor)
    err = 0.0
    for kind, lvls in pyramids.items():
        for t in FAST_THRESHOLDS:
            maps = fast_kernel.fast_nms_pyramid(lvls, t)
            for lvl, (m, lv) in enumerate(zip(maps, lvls)):
                err = max(err, check_equal(f"fast_nms_pyramid {kind} level {lvl} th={t}", m,
                                           fast_kernel.fast_nms_plain(lv, t)))
    for t in (7.0, 20.0):   # the one-image entry point
        err = max(err, check_equal(f"fast_nms random th={t}",
                                   fast_kernel.fast_nms(pyramids["random"][0][0], t),
                                   fast_kernel.fast_nms_plain(pyramids["random"][0][0], t)))
    fast_sites = []
    for lvl, lv in enumerate(levels):
        n_bytes, n_ops, share = fast_work([lv], th)
        fast_sites.append(site_row(   # alone: the path runs it inside the pyramid launch
            f"level {lvl} {lv.shape[-1]}x{lv.shape[-2]} x2 alone", 0,
            graph_ms(lambda lv=lv: fast_kernel.fast_nms(lv, th)),
            graph_ms(lambda lv=lv: fast_kernel.fast_nms_plain(lv, th)),
            n_bytes, n_ops, None, candidate_share=round(share[0], 4)))
    n_bytes, n_ops, shares = fast_work(levels, th)
    pyr = timed_pair(lambda: fast_kernel.fast_nms_pyramid(levels, th),
                     lambda: [fast_kernel.fast_nms_plain(lv, th) for lv in levels])
    frame_row = site_row("pyramid (per frame)", 1, pyr["kernel"]["device_ms"],
                         pyr["plain"]["device_ms"], n_bytes, n_ops, None,
                         candidate_share=[round(x, 4) for x in shares])
    results["fast_nms"] = dict(max_abs_err=err, **kernel_fields(frame_row),
                               wall_ms=pyr["kernel"]["wall_ms"], sites=fast_sites + [frame_row])
    print(f"fast_nms: bit-equal to plain, fast_nms_pyramid on the frame's and on random and "
          f"integer-valued 376x1241 pyramids ({len(levels)} levels x 2 eyes) at th "
          f"{'/'.join(f'{t:g}' for t in FAST_THRESHOLDS)}, fast_nms on a random image at th 7/20 "
          f"| per frame at th {th:g}: {fmt_pair(pyr)}", flush=True)
    for row in fast_sites + [frame_row]:
        print(fmt_site("fast_nms", row), flush=True)

    # -- 4. gather_patches kernel vs plain -----------------------------------
    atlas, ys, xs, side, _ = orb_job
    err = check_equal("gather ORB atlas", gather_kernel.gather_patches(*orb_job),
                      gather_kernel.gather_patches_plain(*orb_job))
    for name, job, out in zip(("SAD left", "SAD right"), sad_jobs,
                              gather_kernel.gather_patches_multi(sad_jobs)):
        err = max(err, check_equal(f"gather_patches_multi {name}", out,
                                   gather_kernel.gather_patches_plain(*job)))
        err = max(err, check_equal(f"gather {name}", gather_kernel.gather_patches(*job),
                                   gather_kernel.gather_patches_plain(*job)))
    oy = torch.tensor([-7, 0, atlas.shape[0], 10**6, -(10**6)], dtype=torch.int32, device=dev)
    ox = torch.tensor([atlas.shape[1], -3, 5, -(10**6), 10**6], dtype=torch.int32, device=dev)
    clipped = gather_kernel.gather_patches(atlas, oy, ox, side, side)
    err = max(err, check_equal("gather clipping", clipped,
                               gather_kernel.gather_patches_plain(atlas, oy, ox, side, side)))
    H, W = atlas.shape
    expect = torch.stack([atlas[0:side, W - side:], atlas[0:side, 0:side],
                          atlas[H - side:, 5:5 + side], atlas[H - side:, 0:side],
                          atlas[0:side, W - side:]])
    err = max(err, check_equal("gather clipping vs slices", clipped, expect))
    far = [(img, y0 + sign * 10**6, x0 - sign * 10**6, ph, pw)
           for sign, (img, y0, x0, ph, pw) in zip((1, -1), sad_jobs)]
    for name, job, out in zip(("SAD left", "SAD right"), far,
                              gather_kernel.gather_patches_multi(far)):
        err = max(err, check_equal(f"gather_patches_multi clipping {name}", out,
                                   gather_kernel.gather_patches_plain(*job)))
    gather_sites = []   # the SAD gathers alone, as a reference: the path launches the pair
    for name, job, n in zip(("ORB atlas", "SAD left alone", "SAD right alone"),
                            (orb_job, *sad_jobs), (1, 0, 0)):
        gather_sites.append(site_row(
            f"{name} {job[3]}x{job[4]} N={job[1].shape[0]}", n,
            graph_ms(lambda job=job: gather_kernel.gather_patches(*job)),
            graph_ms(lambda job=job: gather_kernel.gather_patches_plain(*job)),
            gather_bytes([job]), 0, graph_ms(unfold_gather(*job))))
    yardsticks = [unfold_gather(*job) for job in sad_jobs]
    pair_row = site_row(
        "SAD pair (gather_patches_multi)", 1,
        graph_ms(lambda: gather_kernel.gather_patches_multi(sad_jobs)),
        graph_ms(lambda: gather_kernel.gather_patches_multi_plain(sad_jobs)),
        gather_bytes(sad_jobs), 0, graph_ms(lambda: [f() for f in yardsticks]))
    orb_row = gather_sites[0]
    frame_row = site_row("per frame (ORB + SAD pair)", 2, orb_row["ms"] + pair_row["ms"],
                         orb_row["plain_ms"] + pair_row["plain_ms"],
                         gather_bytes([orb_job, *sad_jobs]), 0,
                         orb_row["library_ms"] + pair_row["library_ms"])
    results["gather_patches"] = dict(max_abs_err=err, **kernel_fields(frame_row),
                                     sites=gather_sites + [pair_row, frame_row])
    print(f"gather_patches: bit-equal to plain on the frame's ORB atlas (N={ys.shape[0]}, "
          f"{side}x{side}), its SAD windows 11x11 and strips 11x21 (gather_patches and one "
          f"gather_patches_multi launch) and clipped starts", flush=True)
    for row in gather_sites + [pair_row, frame_row]:
        print(fmt_site("gather_patches", row), flush=True)
    del pyramids, maps, clipped, expect, far   # out of phase 9's peak device memory

    # -- 5. the VO slice at KITTI size ----------------------------------------
    vo = StereoVisualOdometry(cfg, device=dev)
    n_frames, n_timed = lefts.shape[0], 16
    reset_launches()
    lat, inliers = [], []
    t_timed = None
    for i in range(n_frames):
        if i == n_frames - n_timed:
            torch.cuda.synchronize()
            t_timed = time.perf_counter()
        t1 = time.perf_counter()
        T = vo.process(lefts[i], rights[i], timestamp=i / cam.fps)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
        if T is None:
            raise AssertionError(f"VO: stereo initialization failed at frame {i}")
        if i > 0:
            inliers.append(int(vo.state.n_inliers))
    fps = n_timed / (time.perf_counter() - t_timed)
    launches = read_launches()
    expected = {"fast_nms": 0, "fast_nms_pyramid": n_frames, "gather_patches": n_frames,
                "gather_patches_multi": n_frames}
    if launches != expected:
        raise AssertionError(f"VO: kernel launches {launches}, expected {expected}")
    if min(inliers) < 10:
        raise AssertionError(f"VO: tracking lost (inliers per frame {inliers})")
    poses = [t.cpu().numpy() for t in vo.trajectory]
    if not all(np.isfinite(p).all() for p in poses):
        raise AssertionError("VO: non-finite pose")
    ate_kitti = trajectory.ate_rmse(poses, list(gt), align=False)
    ms_frame = 1e3 * float(np.mean(lat[n_frames - n_timed:]))
    print(f"vo_kitti: {n_frames} frames 1241x376, 2000 features, 8 levels | "
          f"{fps:.2f} frames/s over last {n_timed} | {ms_frame:.2f} ms/frame | "
          f"first frame {1e3 * lat[0]:.1f} ms | ATE {ate_kitti:.4f} m (align=False) | "
          f"inliers min {min(inliers)} | launches/frame {per_frame(launches, n_frames)}",
          flush=True)

    # -- 6. where the time goes: front end vs tracking, device busy share ---
    # The front end is timed by wrapping the process_stereo that tracking
    # calls, with a sync on each side; tracking is the rest of the frame.
    inner, front, frame = tracking.process_stereo, [], []

    def timed_front(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        front.append(time.perf_counter() - t)
        return out

    n_prof = 3
    tracking.process_stereo = timed_front
    try:
        vo = StereoVisualOdometry(cfg, device=dev)
        for i in range(n_frames - n_prof):
            t1 = time.perf_counter()
            vo.process(lefts[i], rights[i], timestamp=i / cam.fps)
            torch.cuda.synchronize()
            frame.append(time.perf_counter() - t1)
    finally:
        tracking.process_stereo = inner
    split = slice(n_frames - n_timed, n_frames - n_prof)
    fe_ms = 1e3 * float(np.median(front[split]))
    tr_ms = 1e3 * float(np.median(np.subtract(frame, front)[split]))
    todo = iter(range(n_frames - n_prof, n_frames))

    def next_frame():
        i = next(todo)
        vo.process(lefts[i], rights[i], timestamp=i / cam.fps)

    busy_ms, ops = device_busy(next_frame, n_prof)
    print(f"vo_kitti_time: median of frames {split.start}-{split.stop - 1}: front end "
          f"{fe_ms:.2f} ms, tracking {tr_ms:.2f} ms (sync between) | device busy "
          f"{busy_ms:.2f} ms/frame in {ops:.0f} device ops (torch.profiler, frames "
          f"{n_frames - n_prof}-{n_frames - 1}) | idle share {1 - busy_ms / ms_frame:.3f} "
          f"of {ms_frame:.2f} ms/frame", flush=True)

    # -- 7. KITTI-size ATE over EPnP-RANSAC draws ----------------------------
    ates, worst = [ate_kitti], [min(inliers)]
    for seed in range(1, 8):
        vo = StereoVisualOdometry(cfg, device=dev)
        vo.seed = seed
        inl = []
        for i in range(n_frames):
            vo.process(lefts[i], rights[i], timestamp=i / cam.fps)
            if i > 0:
                inl.append(int(vo.state.n_inliers))
        ates.append(trajectory.ate_rmse([t.cpu().numpy() for t in vo.trajectory], list(gt),
                                        align=False))
        worst.append(min(inl))
    print("vo_kitti_draws: per-frame seed 0-7: ATE "
          + " / ".join(f"{a:.4f}" for a in ates)
          + " m | inliers min " + " / ".join(map(str, worst)), flush=True)

    # -- 8. accuracy gate on the 512x256 fixture ----------------------------
    small = SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0,
                            width=512, height=256, fps=10.0),
        orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
    )
    sl, sr, sgt, _ = synthetic.render_stereo_sequence(small, n_frames=12, n_points=500,
                                                      seed=5, step=0.25)
    vo = StereoVisualOdometry(small, device=dev)
    for i in range(sl.shape[0]):
        if vo.process(sl[i], sr[i], timestamp=i * 0.1) is None or vo.lost:
            raise AssertionError(f"fixture: tracking lost at frame {i}")
    ate_small = trajectory.ate_rmse([t.cpu().numpy() for t in vo.trajectory], list(sgt),
                                    align=False)
    if not ate_small < 0.10:
        raise AssertionError(f"fixture: ATE {ate_small:.4f} m >= 0.10 m")
    print(f"vo_fixture: 12 frames 512x256, 600 features, 4 levels | ATE {ate_small:.4f} m "
          f"(align=False, bound 0.10 m)", flush=True)

    # -- 9. stereo SLAM at KITTI size ---------------------------------------
    torch.cuda.reset_peak_memory_stats()
    slam = slam_mod.StereoSlam(cfg, device=dev, **SLAM_OFF)
    reset_launches()
    lat = drive_slam(slam, lefts, rights, cam.fps)
    slam_launches = read_launches()
    slam.finish()          # settles the last frame's deferred decision
    if slam.lost:
        raise AssertionError("SLAM: tracking lost at the last frame")
    if slam_launches != expected:
        raise AssertionError(f"SLAM: kernel launches {slam_launches}, expected {expected}")
    if slam.n_keyframes < 5:
        raise AssertionError(f"SLAM: {slam.n_keyframes} keyframes in {n_frames} frames, "
                             "need >= 5 for local BA and keyframe culling")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    slam_ms = 1e3 * float(np.mean(lat[n_frames - n_timed:]))
    slam_fps = 1e3 / slam_ms
    ate_slam = trajectory.ate_rmse([t.cpu().numpy() for t in slam.trajectory], list(gt),
                                   align=False)
    m = slam.map
    print(f"slam_kitti: {n_frames} frames 1241x376, 2000 features, 8 levels, async mapping | "
          f"{slam_fps:.2f} frames/s over last {n_timed} | {slam_ms:.2f} ms/frame | first "
          f"frame {1e3 * lat[0]:.1f} ms | keyframes {slam.n_keyframes} (valid "
          f"{int(m.kf_valid.sum())}) | map points {int(m.pt_valid.sum())} | capacity "
          f"{m.kf_capacity} kf / {m.pt_capacity} pts | peak device memory {peak_gb:.3f} GB | "
          f"ATE {ate_slam:.4f} m (align=False) | launches/frame "
          f"{per_frame(slam_launches, n_frames)}", flush=True)

    # -- 10. where the SLAM time goes ---------------------------------------
    # the layers are timed over frames 0-17; the profiler reads the last 6
    # (steady frames, a keyframe stage among them)
    spans, n_prof_slam = {}, 6
    restore = timed_layers(slam_mod, ("track_frame_with_map", "insert_stage",
                                      "mapping_stage") + MAPPING_PASSES, spans)
    try:
        slam = slam_mod.StereoSlam(cfg, device=dev, **SLAM_OFF)
        drive_slam(slam, lefts[:n_frames - n_prof_slam], rights[:n_frames - n_prof_slam],
                   cam.fps)
    finally:
        restore()
    todo = iter(range(n_frames - n_prof_slam, n_frames))

    def next_slam_frame():
        i = next(todo)
        slam.process(lefts[i], rights[i], timestamp=i / cam.fps)

    busy_ms, ops = device_busy(next_slam_frame, n_prof_slam)
    slam.finish()

    def med(name):
        v = spans.get(name, [])
        return f"{1e3 * float(np.median(v)):.2f} ms x{len(v)}" if v else "not run"

    print("slam_kitti_time: median per call, sync both sides: "
          + " | ".join(f"{n} {med(n)}" for n in ("track_frame_with_map", "insert_stage",
                                                 "mapping_stage"))
          + " | mapping_stage passes: " + ", ".join(f"{n} {med(n)}" for n in MAPPING_PASSES)
          + f" | device busy {busy_ms:.2f} ms/frame in {ops:.0f} device ops (torch.profiler, "
          f"frames {n_frames - n_prof_slam}-{n_frames - 1}) | idle share "
          f"{1 - busy_ms / slam_ms:.3f} of {slam_ms:.2f} ms/frame | peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB (phases 9-10)", flush=True)

    # -- 11. the SLAM gate on the fixture of tests/test_slam.py -------------
    fcfg = SystemConfig(camera=small.camera, orb=small.orb,
                        tracking=TrackingConfig(max_frames=5, th_depth=35.0),
                        max_keyframes=32, max_map_points=16384)
    fl, fr, fgt, world = synthetic.render_stereo_sequence(fcfg, n_frames=14, n_points=500,
                                                          seed=5, step=0.25)
    slam = slam_mod.StereoSlam(fcfg, device=dev, **SLAM_OFF)
    drive_slam(slam, fl, fr, fcfg.camera.fps)
    slam.finish()
    if slam.lost:
        raise AssertionError("slam fixture: tracking lost at the last frame")
    n_pts = int(slam.map.pt_valid.sum())
    ate_fix = trajectory.ate_rmse([t.cpu().numpy() for t in slam.trajectory], list(fgt),
                                  align=False)
    n_far, rel_far = far_point_check(
        slam, world, fcfg.tracking.th_depth * fcfg.camera.baseline_m)
    if slam.n_keyframes < 2 or n_pts <= 100:
        raise AssertionError(f"slam fixture: {slam.n_keyframes} keyframes, {n_pts} points")
    if not ate_fix < 0.10:
        raise AssertionError(f"slam fixture: ATE {ate_fix:.4f} m >= 0.10 m")
    if n_far <= 30 or not rel_far < 0.04:
        raise AssertionError(f"slam fixture: {n_far} far points, median rel err {rel_far:.4f}")
    print(f"slam_fixture: 14 frames 512x256, never lost | keyframes {slam.n_keyframes} | "
          f"map points {n_pts} | ATE {ate_fix:.4f} m (align=False, bound 0.10 m) | far points "
          f"{n_far} (bound > 30), median rel err {rel_far:.4f} (bound 0.04)", flush=True)

    kernels = [
        dict(name=name, route="cuda",
             source=f"opendlv_perception_vision_orbslam2_tpu_torch/csrc/{name}.cu",
             replaces=REPLACES[name], launches=kernel_launches(slam_launches, name),
             launches_vo=kernel_launches(launches, name), **results[name])
        for name in ("fast_nms", "gather_patches")
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
