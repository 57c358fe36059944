#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failed check raises, so the exit code is non-zero
and the final line is not printed:

1. device: requires CUDA, prints nvidia-smi's name and power limit;
2. build: builds both CUDA kernels from ``csrc/`` with nvcc;
3. fast_nms kernel vs its plain version, bit for bit, on all 8 pyramid
   levels of both eyes of a rendered KITTI-size frame and on a uniform
   random 376x1241 image at thresholds 7 and 20, plus both times: device
   time from a CUDA-graph replay, and wall time per call;
4. gather_patches kernel vs its plain version, bit for bit, on the frame's
   ORB atlas (45x45, N = 4000), the two stereo SAD gathers (11x11 and
   11x21, N = 2048) and out-of-range starts that must clip, plus both times;
5. the VO slice at KITTI size (1241x376, 2000 features, 8 levels) over the
   24-frame sequence bench.py renders: never lost, and the launch counters
   show 8 FAST and 3 gather launches per frame;
6. where the VO time goes: front end vs tracking per frame, and the
   device's busy time and idle share from torch.profiler;
7. the KITTI-size ATE over EPnP-RANSAC draws (generator seeds 0-4),
   reported, not gated;
8. the accuracy gate: ATE < 0.10 m on the 512x256 12-frame fixture.

Then one JSON line of kernel results, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.  Imports no jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPLACES = {
    "fast_nms": "opendlv_perception_vision_orbslam2_tpu/ops/fast_pallas.py:98",
    "gather_patches": "opendlv_perception_vision_orbslam2_tpu/ops/gather_pallas.py:42",
}


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


def main() -> int:
    import numpy as np
    import torch

    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from opendlv_perception_vision_orbslam2_tpu_torch.models import extractor, tracking
    from opendlv_perception_vision_orbslam2_tpu_torch.models.tracking import (
        StereoVisualOdometry,
    )
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import (
        cuda_build, fast_kernel, gather_kernel, image, stereo,
    )
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic, trajectory
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import (
        CameraConfig, OrbConfig, SystemConfig,
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
    for name in ("fast_nms", "gather_patches"):
        cuda_build.load(name)
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
    levels = image.build_pyramid(both, orb.n_levels, orb.scale_factor)
    results = {}

    # -- 3. fast_nms kernel vs plain -----------------------------------------
    err = 0.0
    th = float(orb.min_th_fast)
    for lvl, lv in enumerate(levels):
        err = max(err, check_equal(f"fast_nms level {lvl}", fast_kernel.fast_nms(lv, th),
                                   fast_kernel.fast_nms_plain(lv, th)))
    rnd = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (cam.height, cam.width))
                           .astype(np.float32)).to(dev)
    for th in (7.0, 20.0):
        err = max(err, check_equal(f"fast_nms random th={th}", fast_kernel.fast_nms(rnd, th),
                                   fast_kernel.fast_nms_plain(rnd, th)))
    th = float(orb.min_th_fast)
    l0 = timed_pair(lambda: fast_kernel.fast_nms(levels[0], th),
                    lambda: fast_kernel.fast_nms_plain(levels[0], th))
    pyr = timed_pair(lambda: [fast_kernel.fast_nms(lv, th) for lv in levels],
                     lambda: [fast_kernel.fast_nms_plain(lv, th) for lv in levels])
    results["fast_nms"] = dict(max_abs_err=err, ms=pyr["kernel"]["device_ms"],
                               plain_ms=pyr["plain"]["device_ms"])
    print(f"fast_nms: bit-equal to plain on {len(levels)} levels x 2 eyes + random 376x1241 "
          f"at th 7/20 | level 0 (2 eyes): {fmt_pair(l0)} | "
          f"8-level pyramid (2 eyes): {fmt_pair(pyr)}", flush=True)

    # -- 4. gather_patches kernel vs plain -----------------------------------
    _, _, _, _, y0, x0 = extractor._select_pyramid_keypoints(levels, orb)
    atlas, ys, xs = extractor.patch_atlas_starts(levels, y0, x0, orb)
    side = 45
    err = check_equal("gather ORB atlas", gather_kernel.gather_patches(atlas, ys, xs, side, side),
                      gather_kernel.gather_patches_plain(atlas, ys, xs, side, side))
    g = np.random.default_rng(1)
    sad_atlas, _ = stereo.build_atlas([lv[0] for lv in levels])
    lp = image.edge_pad(sad_atlas, 5, 5, 5, 5)
    rp = image.edge_pad(sad_atlas, 5, 5, 10, 10)
    for name, img, ph, pw in (("SAD left 11x11", lp, 11, 11), ("SAD right 11x21", rp, 11, 21)):
        sy = torch.from_numpy(g.integers(0, img.shape[0] - ph + 1, 2048).astype(np.int32)).to(dev)
        sx = torch.from_numpy(g.integers(0, img.shape[1] - pw + 1, 2048).astype(np.int32)).to(dev)
        err = max(err, check_equal(f"gather {name}", gather_kernel.gather_patches(img, sy, sx, ph, pw),
                                   gather_kernel.gather_patches_plain(img, sy, sx, ph, pw)))
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
    gat = timed_pair(lambda: gather_kernel.gather_patches(atlas, ys, xs, side, side),
                     lambda: gather_kernel.gather_patches_plain(atlas, ys, xs, side, side))
    results["gather_patches"] = dict(max_abs_err=err, ms=gat["kernel"]["device_ms"],
                                     plain_ms=gat["plain"]["device_ms"])
    print(f"gather_patches: bit-equal to plain on ORB atlas (N={ys.shape[0]}, 45x45), SAD "
          f"11x11 / 11x21 (N=2048) and clipped starts | ORB gather: {fmt_pair(gat)}",
          flush=True)

    # -- 5. the VO slice at KITTI size ----------------------------------------
    vo = StereoVisualOdometry(cfg, device=dev)
    n_frames, n_timed = lefts.shape[0], 16
    fast_kernel.fast_nms.launches = 0
    gather_kernel.gather_patches.launches = 0
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
    launches = {"fast_nms": fast_kernel.fast_nms.launches,
                "gather_patches": gather_kernel.gather_patches.launches}
    expected = {"fast_nms": orb.n_levels * n_frames, "gather_patches": 3 * n_frames}
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
          f"inliers min {min(inliers)} | launches/frame fast_nms "
          f"{launches['fast_nms'] / n_frames:g}, gather {launches['gather_patches'] / n_frames:g}",
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
    for seed in range(1, 5):
        vo = StereoVisualOdometry(cfg, device=dev)
        vo.generator.manual_seed(seed)
        inl = []
        for i in range(n_frames):
            vo.process(lefts[i], rights[i], timestamp=i / cam.fps)
            if i > 0:
                inl.append(int(vo.state.n_inliers))
        ates.append(trajectory.ate_rmse([t.cpu().numpy() for t in vo.trajectory], list(gt),
                                        align=False))
        worst.append(min(inl))
    print("vo_kitti_draws: generator seeds 0-4: ATE "
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

    kernels = [
        dict(name=name, route="cuda",
             source=f"opendlv_perception_vision_orbslam2_tpu_torch/csrc/{name}.cu",
             replaces=REPLACES[name], launches=launches[name], **results[name])
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
