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
   set to 0-3), reported, not gated;
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
    > 30 points triangulated beyond th_far with median relative error < 0.04;
12. place recognition and relocalization at KITTI size: ``StereoSlam`` with
    relocalization on (its default) over the same 24 frames, async mapping:
    never lost; the vocabulary trained from frame 0 and swapped exactly once,
    at 12 keyframes (the 8-keyframe retrain); after ``finish()`` the database
    has a row exactly for every live keyframe, every keyframe was registered,
    and each stored row and node table equals the one recomputed from the
    map; 1 FAST + 2 gather launches per frame.  Prints ms/frame over frames
    8-17 beside phase 9's over the same frames, host ms per
    ``_register_keyframe``, the retrain thread's host seconds, the swap's
    host and device ms, the device busy time of the run's last 6 frames
    (torch.profiler), idle share and peak device memory;
13. a kidnap on that map (``kidnap_drive``): 3 frames without a feature,
    then frames 6, 7, 8.  Prints every rung tried with its verdict and ms,
    the recovering rung, its inlier count and the pose error against ground
    truth; gate: not lost at frame 8, pose error there < KIDNAP_BOUND_M.
    Then ``relocalize`` and ``relocalize_brute`` on frame 6 against the map,
    on the card and with everything moved to the CPU, from the same RANSAC
    sets (``reloc_card_vs_cpu``): same candidates, same BoW and brute
    matches, per candidate the same verdict, bindings and pose (1e-3) of the
    EPnP + ``refine_pose`` solve, and the same outcome of both rungs;
14. localization-only mode: the two scenarios of tests/test_tracking_only.py
    at 512x256 (map frozen and ATE < 0.2 m; VO mode engages off the map and
    every pose stays finite, over its 24 frames), then at KITTI size on phase
    12's map: a frame without a feature puts the tracker into VO mode,
    frames 12-17 must snap it back by relocalization with the map unchanged
    and a pose error at frame 17 < KIDNAP_BOUND_M.
15. loop closing and global BA: ``StereoSlam(cfg)`` with its defaults (loop
    closing and relocalization on) over bench.py's 260-frame KITTI-size loop
    circuit (``LOOP_CIRCUIT``), async, a sync after each frame.  Gates: the
    launch counters show 1 FAST + 2 gather launches a frame, fewer than 5 %
    of the frames lost, >= 1 loop closed, the map grown past 64 keyframe
    slots, every pose finite, retro-corrected ATE (align=True, as bench.py
    measures it) < ``LOOP_ATE_BOUND_M``.  Prints frames/s and ms/frame
    median, mean and worst over frames 36-259 (what the worst frame ran),
    keyframes, points, lost frames, each closure (frame, keyframe slots and
    ids, n_inliers, n_total), each capacity growth, the GBA's chunks (device
    ms by CUDA events) and merge frame, device busy and idle share over 6
    frames while GBA chunks run (torch.profiler; those frames are left out
    of the ms/frame figures), peak device memory and the host syncs a frame
    (``torch.cuda.set_sync_debug_mode``, by call site); then on the closing
    verification's inputs, synced on both sides: ``loop_candidates``,
    ``_geometric_loop_query``, ``harvest_detect`` (host), ``verify_and_apply``,
    ``correct_loop``, ``optimize_pose_graph``, one
    ``global_bundle_adjust_chunk``, and the card's run-to-run spread of the
    pose graph and the chunk (0: every sum runs in a fixed order);
16. the loop stages on the card against the CPU on that closure, with the
    card's RANSAC sets on both: ``compute_loop_transform`` (the same pairs,
    verdict, n_inliers and n_total, ``T_rel`` within 1e-3), ``correct_loop``
    (keyframe poses within 1e-3 m and 1e-3 rad) and one GBA chunk (cost
    within 1e-3 relative, poses within 1e-3), and that chunk run twice on
    the card, bit for bit;
17. RGB-D SLAM: ``StereoSlam(cfg).process_rgbd`` (loop closing and
    relocalization on, async) over phase 9's world and poses, rendered with
    depth maps, for ``RGBD_FRAMES`` frames.  Gates: never lost, finite
    poses, >= 5 keyframes, 1 FAST + 1 gather launch a frame (no SAD
    gather), ATE (align=True) < ``RGBD_ATE_BOUND_M``.  Prints frames/s,
    median and worst ms/frame, keyframes, points, device busy and idle
    share, peak device memory;
18. monocular SLAM: ``MonocularSlam(cfg)`` with its defaults over
    ``MONO_DRIVE`` (tests/test_mono.py's lateral drive at KITTI size).
    Gates: initialized by frame ``MONO_INIT_BY``, >= 2 keyframes, more than
    ``MONO_MIN_POINTS`` points, translation direction cosine against the
    truth > ``MONO_MIN_COS``, not lost within ``MONO_LOST_AFTER`` frames of
    initialization, every pose finite, 1 FAST + 1 gather launch a frame;
    the successful initializer attempt on the card against the CPU from the
    same sets (same H/F choice, verdict and ``point_ok``, ``T_21`` within
    ``MONO_INIT_POSE_TOL``).  Prints ms/frame before and after
    initialization, the initializer's ms and host syncs, the Sim3-aligned
    ATE (reported, not gated).

19. the service layer at KITTI size: phase 9's 24 frames written as a
    KITTI-layout directory of PNGs; ``__main__.main`` run in process with
    deploy/docker-compose.yml's flags and ``--kittiPath`` (no ``--cid``),
    on one rank on any host (phase 21 runs it on several).
    Gates: exit 0, poses.txt 24 rows of 12 finite numbers, map.txt not
    empty, fps.txt 24 lines, never lost, >= 5 keyframes, 1 FAST + 2 gather
    launches a frame, ATE of poses.txt (align=True) <
    ``SERVICE_ATE_BOUND_M``, no host sync at the service layer's sites
    (``SERVICE_FILES``) inside ``track``.  Prints ms/frame median and worst
    from fps.txt beside phase 12's over the same frames, the PNG decoder,
    the publish lag in frames, peak device memory and the host syncs made
    inside ``track`` by site.  Then ``Selflocalization`` with a recording
    session driven by ``KittiRunner`` over the same directory: one
    Geolocation a frame, in frame order, each ``pose_to_geolocation`` of
    the frame's logged pose; frame 20's OrbslamMap chunks equal
    ``chunk_map_messages`` of that frame's pose and map; every envelope
    encodes.  Then the live loop with rectification (``SERVICE_LIVE_FLAGS``)
    over 6 rendered side-by-side 2560x720 frames handed in: finite poses,
    the rectify maps on the card, ``remap_bilinear`` card against CPU on a
    1280x720 frame within ``SERVICE_REMAP_TOL``.

20. multi-device SLAM over ``torch.distributed``: 2 ranks on ``cuda:0``
    with gloo (spawned; NCCL refuses two ranks on one card), rank 0 runs
    the engine's sharded solves while rank 1 serves (``parallel/serve.py``).
    (a) ``IncrementalGBA(m, cfg)`` sharded on phase 16's closure map (saved
    by phase 16), 10 chunks and the merge, twice, then once more with the
    problem's edges shuffled (both ranks holding live edges); gates against
    the single-device ``IncrementalGBA`` in this process: the first chunk's
    poses and cost within ``MULTI_CHUNK_TOL``, the merged keyframe poses of
    both edge orders within ``MULTI_MERGED_TOL``, both ranks' carries after
    every chunk bit-equal, the repeated run bit-equal.  (b) the local-map
    pose solve of a tracked frame of (c) at full width (2048 slots) on 2
    ranks against the same solver on a one-rank group: T within
    ``MULTI_POSE_TOL``, the same inliers, both ranks' T bit-equal.  (c)
    ``StereoSlam(cfg)`` with its defaults on rank 0 over phase 9's first
    ``MULTI_ENGINE_FRAMES`` frames:
    never lost, >= 5 keyframes, ATE (align=True) < ``MULTI_ATE_BOUND_M``, 1 FAST + 2
    gather launches a frame on rank 0 and none on rank 1; in the synchronous
    schedule (``force_sync_decisions``) sharded against alone, and in the
    default schedule sharded against the split witness (the lone engine
    whose pose solve sums two blocks in one process as the two ranks do,
    ``_split_solver``, bit-checked against the two ranks on (b)'s frame):
    keyframes within ``MULTI_PARITY_KF_GAP``, ATEs within
    ``MULTI_PARITY_ATE_GAP_M`` (the split witness: ``SplitWitness``; the
    engine on ranks over the loop circuit, with its GBA: phase 22).  Every
    rank must exit 0 within ``MULTI_JOIN_TIMEOUT_S``.  Prints the device ms a chunk on
    each rank (CUDA events), the all-reduces a chunk and their host ms, the
    problem's broadcast, ms/frame beside phase 9's, the collectives a frame
    and the host syncs a frame by site.

21. the service CLI on every visible card: ``__main__.main(argv,
    ranks=D)`` in process with D = max(2, cards) over phase 19's directory
    with the deploy flags and ``--cid`` (a recording session): rank 0 here,
    D - 1 ranks spawned by ``parallel/launch.py`` (gloo on one card, NCCL
    one rank a card on a host with several).  Gates: exit 0 and every worker
    exits 0 within ``SERVICE_MULTI_DEADLINE_S``, the plan's backend, the
    engine on the sharded pose solve, complete dumps, never lost, >= 5
    keyframes, ATE (align=True) < ``MULTI_ATE_BOUND_M``, one Geolocation a
    frame equal to its logged pose's, no host sync at the service sites,
    1 + 2 launches a frame on rank 0 and none on the workers (their
    reports), collectives a frame > 0; then the lone CLI whose pose solve
    sums D blocks as the ranks do (``_split_solver``): keyframes within
    ``MULTI_PARITY_KF_GAP``, ATE within ``MULTI_PARITY_ATE_GAP_M``.  On a
    host with two or more cards, ``python -m
    opendlv_perception_vision_orbslam2_tpu_torch --kittiPath=...`` as a
    subprocess must form one NCCL rank a card, exit 0 and pass the ATE
    bound; on one card a line says why NCCL was not run.  Prints the
    backend, ms/frame beside phase 19's, the collectives' calls, their
    device ms (CUDA events) and host ms, and the ops each worker served.

22. a loop closure on every card: ``__main__.main(argv, ranks=D)`` with D
    = max(2, cards) over phase 15's circuit written as PNG pairs with the
    deploy flags (gloo on one card, NCCL one rank a card on several).  The
    first valid verdict inside ``StereoSlam`` on rank 0 starts the GBA
    sharded over the ranks; the workers serve its chunks between frames.
    Gates: exit 0 and every worker exits 0 within ``LOOP_MULTI_DEADLINE_S``,
    the plan's backend, >= 1 loop, every GBA sharded, the workers'
    ``gba_init`` and ``gba_step`` counts equal to rank 0's starts and chunks,
    the last GBA merged, growth past 64 keyframe slots, lost < 5 %, ATE
    (align=True) < ``LOOP_ATE_BOUND_M``, 1 + 2 launches a frame on rank 0
    and none on the workers, no host sync at the service sites; then each
    GBA the engine started, replayed from the map it started from by the
    split witness's GBA (``split_gba``: D edge blocks summed in rank order
    in one process): the carry after every chunk and the merged keyframe
    poses bit for bit (phase 21 holds the CLI's sharded pose solve to its
    lone witness).  Prints ms/frame beside phase 15's, every verification, each
    GBA (its frame, shapes, live edges a rank, the problem broadcast's
    bytes and ms, its chunks' frames and merge), each rank's GBA chunk ms,
    the collectives a frame and a chunk (calls, device ms, host ms), peak
    device memory a rank and the phase's seconds.

23. the vocabulary file: a DBoW2 text vocabulary of ORBvoc's shape (k = 10,
    L = 6, 10^6 words) written once into the git-ignored ``_build/``
    (``orbvoc_file``, keyed by the generator's parameters), then
    (A) ``__main__.main(argv + ["--vocFilePath=<file>"], ranks=1)`` over
    phase 22's PNG pairs of the loop circuit.  Gates: exit 0, complete
    dumps, lost < 5 %, growth past 64 keyframe slots, >= 1 loop, ATE
    (align=True) < ``LOOP_ATE_BOUND_M``, 1 FAST + 2 gather launches a frame,
    no host sync inside ``track`` at the service sites or in the
    place-recognition code
    (``PLACE_FILES``), the file loaded once, the vocabulary never replaced
    (no ``_adopt_vocab``, no retrain) and the database the file's W wide;
    after ``finish()`` every live keyframe's stored row and node table equal
    the ones recomputed from the map with the file, and on that database
    ``loop_candidates``, ``loop_min_score`` and ``common_word_counts`` at
    the closing and the last keyframe give the card's and the CPU's
    counts identical, scores within 1e-6 and the same candidates.  Prints the file's
    bytes, nodes and words, the generator's and the loader's seconds,
    fps.txt's median and worst beside phases 15 and 22, the host ms of
    ``_register_keyframe``, the device ms of ``loop_candidates`` at the last
    64-slot keyframe and after growth, the database's bytes, peak device
    memory, the host syncs by site and each verification with the channel
    that nominated it.  (B) ``StereoSlam(cfg, vocab=<the file>)``,
    relocalization on, over phase 12's 24 frames, then phase 13's kidnap:
    not lost at frame 8, pose error < ``KIDNAP_BOUND_M``, the vocabulary
    never replaced; then ``reloc_card_vs_cpu`` on frame 6 with that
    database.  A missing or unreadable file fails the phase: it never
    trains a vocabulary and never falls back to a smaller one.

Phases 3-4 also check the one-eye kernel cases of phases 17-18: one
``fast_nms_pyramid`` launch over one eye's 8 levels, and the one-eye ORB
atlas gather at N = 2000 and at the monocular initialization's 2048.

Then one JSON line of kernel results (each kernel's per-frame numbers, its
sites, and its launches on phase 15's path (``launches``) and on phases 5,
9, 12, 17, 18, 19's CLI drive, 20's, 21's and 22's rank 0 and 23's CLI
drive), the nvidia-smi
line, and the last line
``{"ok": true, "device": {...}}``.  Imports no jax.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import json
import shutil
import subprocess
import sys
import tempfile
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


def _record(run) -> dict:
    """Call ``run()`` (a front end) with the kernel wrappers' inputs
    recorded: ``levels`` and ``th`` of ``fast_nms_pyramid``, the ORB job
    ``orb`` of ``gather_patches`` and the SAD jobs ``sad`` of
    ``gather_patches_multi``, a job being ``(img, y0, x0, ph, pw)``."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import extractor
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
        run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return rec


def record_sites(cfg, left, right):
    """Run ``process_stereo`` once on ``left``/``right`` and return the main
    path's kernel inputs ``(levels, threshold, orb_job, sad_jobs)``."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import frontend

    rec = _record(lambda: frontend.process_stereo(left, right, cfg, 0.0))
    return list(rec["levels"]), rec["th"], tuple(rec["orb"]), [tuple(j) for j in rec["sad"]]


def record_one_eye(cfg, gray, depth):
    """The one-eye front ends' kernel inputs on one frame: ``(levels,
    threshold, orb_job)`` of ``process_rgbd`` at ``cfg``'s budget and the
    ORB job of ``process_mono`` at the monocular initialization budget
    (twice the features, capped at ``max_keypoints``).  Neither makes a SAD
    gather."""
    import dataclasses

    from opendlv_perception_vision_orbslam2_tpu_torch.models import frontend

    rec = _record(lambda: frontend.process_rgbd(gray, depth, cfg, 0.0))
    orb = cfg.orb
    init_cfg = dataclasses.replace(cfg, orb=dataclasses.replace(
        orb, n_features=min(2 * orb.n_features, orb.max_keypoints)))
    mono = _record(lambda: frontend.process_mono(gray, init_cfg, 0.0))
    if "sad" in rec or "sad" in mono:
        raise AssertionError("a one-eye front end launched the SAD gather")
    return list(rec["levels"]), rec["th"], tuple(rec["orb"]), tuple(mono["orb"])


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
    torch.profiler's CUPTI trace.  Only device activity is traced and the
    trace's own records are read: building ``prof.events()`` for 6 SLAM
    frames took 32 s (85 s with the host's operators traced too) against
    2 s, for the same sums.  Raises when the trace holds no device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev_ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    if not dev_ns:
        raise AssertionError("torch.profiler traced no device work")
    return sum(dev_ns) / calls / 1e6, len(dev_ns) / calls


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


def next_slam_frame_of(slam, todo, lefts, rights, fps):
    """A call that feeds ``slam`` the next frame index of ``todo``."""
    def next_frame():
        i = next(todo)
        slam.process(lefts[i], rights[i], timestamp=i / fps)
    return next_frame


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


# Phases 15-16: bench.py's loop circuit at KITTI size (bench_full_slam): 1.25
# laps of a radius-35 m circle, 36 warm-up frames, the timed window over
# frames 36-259, 15 frames/s timestamps.
LOOP_CIRCUIT = dict(n_frames=260, n_points=3200, seed=1, radius=35.0, laps=1.25,
                    r_off_range=(6.0, 30.0), y_range=(-2.5, 2.0), lateral_range=(-14.0, 14.0))
LOOP_WARM = 36
LOOP_FPS = 15.0
LOOP_INITIAL_KF_SLOTS = 64      # SystemConfig().initial_keyframes: the map must grow past it
# lost frames after initialization: fewer than 5 % (tests/test_long_horizon.py's bound)
LOOP_LOST_SHARE = 0.05
# Phase 15's ATE gate (retro-corrected, align=True, as bench.py measures it).
# The reference package on the same 260 frames on the CPU
# (tests/test_torch_loop_slam.py::test_kitti_loop_reference_run): 0.1788 m,
# closing no loop there (an instrumented second run verified 65 nominations;
# the best, at the revisit, found 19 of the 20 inliers a closure needs); on a
# TPU it closed one loop at 0.141 m
# (BENCH_r05.json).  The bound leaves the CPU run a 40 % margin.
REFERENCE_LOOP_ATE_M = 0.1788
LOOP_ATE_BOUND_M = 0.25


def render_loop_circuit(cfg):
    """``(lefts, rights, gt, world)`` of the loop circuit, numpy."""
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic

    return synthetic.render_loop_sequence(cfg, **LOOP_CIRCUIT)


# Phase 13's gate.  The reference package on the same frames (24 frames, 3
# without a feature, then 6, 7, 8; CPU run of tests/test_torch_reloc.py::
# test_kitti_kidnap_reference_run, PERF.md section 6) is not lost at frame 8
# with a pose error there of REFERENCE_KIDNAP_ERR_M; the bound is the repo's
# ATE bound for its 512x256 fixtures, which leaves that run a wide margin.
KIDNAP_BOUND_M = 0.10
REFERENCE_KIDNAP_ERR_M = 0.0172
RUNGS = {"_track_reference_keyframe": "ref-KF", "_try_relocalize": "BoW",
         "_try_wide_recovery": "wide", "_try_global_reloc": "global"}


def _host(T):
    import numpy as np

    return T.cpu().numpy() if hasattr(T, "cpu") else np.asarray(T)


def pose_err(T, T_gt) -> float:
    import numpy as np

    return float(np.linalg.norm(_host(T)[:3, 3] - np.asarray(T_gt)[:3, 3]))


def wrap_rungs(slam, note, before=None, sync=lambda: None):
    """Wrap the four recovery rungs of ``slam`` (the port's or the reference
    package's ``StereoSlam``): ``before(name)`` runs first, then the rung
    between two ``sync()``s, then ``note(name, recovered, seconds)``.
    ``unwrap_rungs`` gives the class's methods back."""
    for name in RUNGS:
        def wrapped(cur, _fn=getattr(slam, name), _name=name):
            if before is not None:
                before(_name)
            sync()
            t = time.perf_counter()
            ok = _fn(cur)
            sync()
            note(_name, bool(ok), time.perf_counter() - t)
            return ok
        setattr(slam, name, wrapped)


def unwrap_rungs(slam):
    for name in RUNGS:
        delattr(slam, name)


def kidnap_drive(slam, lefts, rights, gt, fps, sync, n_blank: int = 3,
                 revisit=(6, 7, 8)):
    """On a ``StereoSlam`` that has tracked ``lefts``/``rights``: feed ``n_blank``
    frames without a feature (a uniform image; fewer than the 8 lost frames
    that start a new map region), then the frames ``revisit``.  Works on the
    port's and on the reference package's ``StereoSlam`` (``sync()`` waits
    for the device).  Returns ``(tried, frames)``: ``tried`` lists ``(frame
    label, rung, recovered, ms)`` for every rung called, ``frames`` ``(label,
    lost, pose error in m or None)`` for every frame fed."""
    import numpy as np

    tried, frames, label = [], [], [None]
    wrap_rungs(slam, lambda name, ok, sec: tried.append((label[0], RUNGS[name], ok, 1e3 * sec)),
               sync=sync)
    blank = np.full(lefts[0].shape, 100.0, np.float32)
    n = lefts.shape[0]
    feed = [(f"blank{k}", blank, blank, None) for k in range(n_blank)]
    feed += [(f"frame{i}", lefts[i], rights[i], gt[i]) for i in revisit]
    for k, (label[0], left, right, T_gt) in enumerate(feed):
        T = slam.process(left, right, timestamp=(n + k) / fps)
        sync()
        if not np.isfinite(_host(T)).all():
            raise AssertionError(f"kidnap: non-finite pose at {label[0]}")
        frames.append((label[0], bool(slam.lost), None if T_gt is None else pose_err(T, T_gt)))
    unwrap_rungs(slam)
    return tried, frames


def fmt_tried(tried) -> str:
    return ", ".join(f"{label} {rung} {'recovered' if ok else 'declined'} {ms:.1f} ms"
                     for label, rung, ok, ms in tried)


def host_spans(obj, names, sink):
    """Wrap ``obj.<name>`` for each name, appending ``(host seconds, start
    event, end event)`` to ``sink[name]``: the host's time to enqueue the call
    and two CUDA events around it, no sync."""
    import torch

    for name in names:
        def inner(*args, _fn=getattr(obj, name), _name=name, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            t = time.perf_counter()
            out = _fn(*args, **kwargs)
            dt = time.perf_counter() - t
            end.record()
            sink.setdefault(_name, []).append((dt, start, end))
            return out
        setattr(obj, name, inner)


def stage_host_ms(since_ns) -> str:
    """The mapping stages since ``since_ns`` by how each ran (the one
    counter inside each ``slam.mapping`` span): count and host ms."""
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import trace

    recs = trace.records(since_ns=since_ns)
    counts = [r for r in recs if isinstance(r, trace.Count) and r.name.startswith("mapping.")]
    by_path = {}
    for s in recs:
        if isinstance(s, trace.Span) and s.name == "slam.mapping":
            path = [c.name for c in counts if s.start_ns <= c.t_ns <= s.end_ns]
            by_path.setdefault(path[0] if len(path) == 1 else "?", []).append(
                (s.end_ns - s.start_ns) / 1e6)
    return ", ".join(f"{k.removeprefix('mapping.')} x{len(v)} "
                     + "/".join(f"{ms:.1f}" for ms in v) + " ms"
                     for k, v in sorted(by_path.items()))


def to_cpu(tree, device="cpu"):
    """Tensors in nested tuples and NamedTuples, moved to the CPU (or to
    ``device``)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_cpu(x, device) for x in tree))
    if isinstance(tree, tuple):
        return tuple(to_cpu(x, device) for x in tree)
    return tree


def reloc_card_vs_cpu(slam, frame, T_gt, cfg):
    """``relocalize`` and ``relocalize_brute`` on ``frame`` against ``slam``'s
    map, on the card and with everything moved to the CPU, the RANSAC sets
    drawn by one CPU generator (seeded alike before each call) and given to
    both.

    Held exactly: the BoW matches against each of the first 5 candidates and
    the brute matches against all points (integers); per candidate the
    verdict of the EPnP + ``refine_pose`` solve and, where it accepts, its
    bindings; the outcome and bindings of both rungs.  Poses: 1e-3.
    Candidates are ranked by a float sum over each one's covisible group;
    where the groups cover the same keyframes the sums tie and rounding
    orders them, so the scores must agree to 1e-6, a slot that only one side
    lists must tie with the other side's last, and the CPU then visits the
    candidates in the card's order.  ``relocalize`` must recover, within
    ``KIDNAP_BOUND_M`` of ground truth.  Pose optimization over all matches
    of a candidate, which the reference package runs and ``refine_pose``
    replaces, is printed for both devices and not compared (its answer hangs
    on rounding, tests/test_torch_reloc.py)."""
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.models import kfdb, relocalization
    from opendlv_perception_vision_orbslam2_tpu_torch.models import vocabulary as voc
    from opendlv_perception_vision_orbslam2_tpu_torch.models.frame import features_scale_sigma2
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import lie
    from opendlv_perception_vision_orbslam2_tpu_torch.ops.matching import search_by_bow
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp
    from opendlv_perception_vision_orbslam2_tpu_torch.optim.pose_opt import PoseObs, pose_optimize

    cam = cfg.camera
    K = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf)
    card = (slam.map, slam.db, slam.kf_nodes, slam.vocab, frame)
    host = to_cpu(card)

    def candidates(m, db, kf_nodes, vocab, fr):
        words, _ = voc.transform(vocab, fr.features.desc, fr.features.valid)
        slots, scores = kfdb.detect_candidates(db, voc.bow_vector(vocab, words), ~m.kf_valid,
                                               0.0, m.covis)
        return slots, scores

    (slots_card, scores_card), (slots_b, scores_b) = candidates(*card), candidates(*host)
    slots_a, scores_a = slots_card.cpu(), scores_card.cpu()
    only_one = set(slots_a.tolist()) ^ set(slots_b.tolist())
    tied = [sc for slots, scores in ((slots_a, scores_a), (slots_b, scores_b))
            for sl, sc in zip(slots.tolist(), scores.tolist()) if sl in only_one]
    if float((scores_a - scores_b).abs().max()) > 1e-6 or any(
            abs(sc - float(scores_b[-1])) > 1e-6 for sc in tied):
        raise AssertionError(f"reloc: candidates on the card {slots_a} {scores_a} vs CPU "
                             f"{slots_b} {scores_b}")

    def bow_pairs(m, db, kf_nodes, vocab, fr, cand):
        feats = fr.features
        _, nodes = voc.transform(vocab, feats.desc, feats.valid)
        idx_kf, ok = search_by_bow(feats.desc, nodes, feats.valid, feats.angle, m.kf_desc[cand],
                                   kf_nodes[cand], m.kf_feat_valid[cand], m.kf_angle[cand],
                                   max_dist=50, nn_ratio=0.75)
        bind = m.kf_obs_point[cand][idx_kf]
        safe = bind.clamp(0, m.pt_capacity - 1).long()
        return ok & (bind >= 0) & m.pt_valid[safe], bind, m.pt_pos[safe]

    def same_result(what, res_a, res_b):
        """Verdict, bindings and pose (1e-3) of two ``RelocResult``s (or None)."""
        ok_a, ok_b = (r is not None and r.success for r in (res_a, res_b))
        if ok_a != ok_b:
            raise AssertionError(f"reloc: {what} accepts on the card: {ok_a}, on the CPU: {ok_b}")
        if not ok_a:
            return "declined"
        d = float((res_a.T_cw.cpu() - res_b.T_cw).abs().max())
        if not torch.equal(res_a.bindings.cpu(), res_b.bindings) or d > 1e-3:
            n_diff = int((res_a.bindings.cpu() != res_b.bindings).sum())
            raise AssertionError(f"reloc: {what}: {n_diff} bindings differ between card and "
                                 f"CPU, poses differ by {d}")
        return f"{int((res_b.bindings >= 0).sum())} bindings, poses within {d:.1e}"

    inner_sets, inner_detect = pnp.sample_sets, relocalization.detect_candidates

    def sets_from(seed):
        g = torch.Generator().manual_seed(seed)
        return lambda valid, generator=None, n=pnp.N_HYPOTHESES: inner_sets(valid.cpu(), g, n)

    pairs, solves, all_matches = [], [], []
    try:
        for cand in [c for c in slots_a.tolist() if c >= 0][:5]:
            ok_a, bind_a, pw_a = bow_pairs(*card, cand)
            ok_b, bind_b, pw_b = bow_pairs(*host, cand)
            if not torch.equal(ok_a.cpu(), ok_b) or not torch.equal(bind_a.cpu()[ok_b],
                                                                    bind_b[ok_b]):
                raise AssertionError(f"reloc: BoW matches against keyframe slot {cand} differ "
                                     "between card and CPU")
            pairs.append(int(ok_b.sum()))
            out = []
            for fr, p_w, ok, bind in ((card[4], pw_a, ok_a, bind_a), (host[4], pw_b, ok_b, bind_b)):
                pnp.sample_sets = sets_from(100 + cand)
                out.append(relocalization._solve(p_w, ok, bind, fr, cfg, None))
                # the reference package's composition, from the same EPnP pose
                pnp.sample_sets = sets_from(100 + cand)
                feats = fr.features
                sigma2 = features_scale_sigma2(feats, cfg.orb.scale_factor)
                res = pnp.pnp_ransac(p_w, feats.xy, sigma2, ok, None, fx=cam.fx, fy=cam.fy,
                                     cx=cam.cx, cy=cam.cy)
                obs = PoseObs(p_w, feats.xy, feats.u_right, sigma2, ok)
                out.append(int(pose_optimize(lie.make_T(res.R, res.t), obs, **K)[2])
                           if int(res.n_inliers) >= 10 else None)
            solves.append(f"slot {cand}: " + same_result(f"the solve against slot {cand}",
                                                         out[0], out[2]))
            all_matches.append(f"{out[1]}/{out[3]}")

        feats = frame.features
        best_a, okb_a = relocalization._brute_match_points(feats.desc, feats.valid,
                                                           slam.map.pt_desc, slam.map.pt_valid)
        best_b, okb_b = relocalization._brute_match_points(host[4].features.desc,
                                                           host[4].features.valid,
                                                           host[0].pt_desc, host[0].pt_valid)
        if not torch.equal(best_a.cpu(), best_b) or not torch.equal(okb_a.cpu(), okb_b):
            raise AssertionError("reloc: brute matches differ between card and CPU")

        rungs = []
        for name, call in (
                ("relocalize", lambda m, db, kf_nodes, vocab, fr: relocalization.relocalize(
                    m, db, kf_nodes, vocab, fr, cfg, None)),
                ("relocalize_brute", lambda m, db, kf_nodes, vocab, fr:
                    relocalization.relocalize_brute(m, fr, cfg, None))):
            res, ms = [], []
            for state in (card, host):
                pnp.sample_sets = sets_from(11)
                # the CPU visits the candidates in the card's order
                relocalization.detect_candidates = (
                    inner_detect if state is card
                    else lambda *a, **k: (slots_a, scores_a))
                t = time.perf_counter()
                res.append(call(*state))
                ms.append(1e3 * (time.perf_counter() - t))
            verdict = same_result(name, *res)
            if res[0].success:
                err = pose_err(res[0].T_cw, T_gt)
                verdict += f", {err:.4f} m from ground truth"
                if not err < KIDNAP_BOUND_M:
                    raise AssertionError(f"{name} recovered {err:.4f} m from ground truth "
                                         f"(bound {KIDNAP_BOUND_M})")
            elif name == "relocalize":
                raise AssertionError("reloc: relocalize declined on frame 6")
            rungs.append(f"{name}: {verdict} ({ms[0]:.0f} ms on the card, {ms[1]:.0f} on the CPU)")
    finally:
        pnp.sample_sets, relocalization.detect_candidates = inner_sets, inner_detect
    print(f"reloc_card_vs_cpu: frame 6 against the map, same RANSAC sets | candidates on the "
          f"card {[c for c in slots_a.tolist() if c >= 0]}, on the CPU "
          f"{[c for c in slots_b.tolist() if c >= 0]}: scores equal to 1e-6, {len(only_one)} "
          f"slot(s) on one side only, tied with the last | BoW matches against the first 5 "
          f"identical ({'/'.join(map(str, pairs))} pairs) | EPnP + refine_pose, card = CPU: "
          f"{'; '.join(solves)} | brute matches identical ({int(okb_b.sum())} of "
          f"{int(feats.valid.sum())} features) | " + " | ".join(rungs)
          + " | not compared: inliers of pose optimization over all matches, card/CPU per "
          f"candidate: {', '.join(all_matches)}", flush=True)


def reloc_phases(cfg, fcfg, dev, lefts, rights, gt, expected, slam_lat, n_timed,
                 n_prof_slam):
    """Phases 12-14 (see the module's docstring) on the KITTI-size frames
    ``lefts``/``rights`` with ground truth ``gt`` and the 512x256 fixture
    config ``fcfg``; ``expected`` are the launch counts of one pass over the
    frames, ``slam_lat`` phase 9's seconds per frame.  Returns phase 12's
    launch counts and its seconds per frame (frames before the profiled
    ones)."""
    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic, trajectory

    cam = cfg.camera
    n_frames = lefts.shape[0]
    t_phase = [time.perf_counter()]

    # -- 12. place recognition and relocalization at KITTI size --------------
    from opendlv_perception_vision_orbslam2_tpu_torch.models import vocabulary as voc
    from opendlv_perception_vision_orbslam2_tpu_torch.models.frontend import process_stereo

    torch.cuda.reset_peak_memory_stats()
    slam = slam_mod.StereoSlam(cfg, device=dev, enable_loop_closing=False)
    spans, registered, swaps_at, train_s = {}, [], [], []
    host_spans(slam, ("_register_keyframe", "_adopt_vocab"), spans)
    for name, sink in (("_register_keyframe", registered), ("_adopt_vocab", swaps_at)):
        def noted(*args, _fn=getattr(slam, name), _sink=sink):
            _sink.append((slam.n_keyframes,) + args)
            return _fn(*args)
        setattr(slam, name, noted)
    inner_train = slam_mod.train_vocab_from_pool

    def timed_train(*args):       # runs in the retrain's worker thread
        t = time.perf_counter()
        out = inner_train(*args)
        train_s.append(time.perf_counter() - t)
        return out

    slam_mod.train_vocab_from_pool = timed_train
    try:
        reset_launches()
        lat = drive_slam(slam, lefts[:1], rights[:1], cam.fps)
        if slam.vocab is None or slam.vocab.n_words != 10 ** 4:
            raise AssertionError("reloc: no vocabulary was trained from frame 0")
        n_plain = n_frames - n_prof_slam
        lat += drive_slam(slam, lefts[1:n_plain], rights[1:n_plain], cam.fps, start=1)
        # the run's last frames under the profiler: device busy time
        todo = iter(range(n_plain, n_frames))
        busy_ms, ops = device_busy(next_slam_frame_of(slam, todo, lefts, rights, cam.fps),
                                   n_prof_slam)
        reloc_launches = read_launches()
        slam.finish()
    finally:
        slam_mod.train_vocab_from_pool = inner_train
    torch.cuda.synchronize()
    if slam.lost:
        raise AssertionError("reloc: tracking lost at the last frame")
    if not all(np.isfinite(T.cpu().numpy()).all() for T in slam.trajectory):
        raise AssertionError("reloc: non-finite pose")
    if reloc_launches != expected:
        raise AssertionError(f"reloc: kernel launches {reloc_launches}, expected {expected}")
    if [n for n, _ in swaps_at] != [12] or len(train_s) != 1:
        raise AssertionError(f"reloc: vocabulary swaps at keyframe counts "
                             f"{[n for n, _ in swaps_at]}, expected one, at 12, from one "
                             f"retrain (ran {len(train_s)})")
    if slam._next_vocab_refresh != 32 or slam._vocab_thread is not None:
        raise AssertionError("reloc: the retrain schedule is not (next at 32, none in flight)")
    m, db = slam.map, slam.db
    if sorted(kf_id for _, _, kf_id in registered) != list(range(slam.n_keyframes)):
        raise AssertionError(f"reloc: registered keyframes {registered} of {slam.n_keyframes}")
    if not torch.equal(db.has_row, m.kf_valid):
        raise AssertionError("reloc: database rows differ from the live keyframes")
    # (a culled keyframe's row loses has_row and keeps its stale values: inert,
    # every query masks with has_row)
    words, nodes = voc.transform_all(slam.vocab, m.kf_desc, m.kf_feat_valid)
    row_err = float((voc.bow_vectors(slam.vocab, words) - db.bow)[db.has_row].abs().max())
    if row_err > 1e-6 or not torch.equal(nodes[db.has_row], slam.kf_nodes[db.has_row]):
        raise AssertionError(f"reloc: stored BoW rows (max abs err {row_err}) or node tables "
                             "differ from the ones recomputed from the map")
    timed = slice(n_frames - n_timed, n_plain)
    reloc_ms = 1e3 * float(np.mean(lat[timed]))
    reg_ms = [1e3 * dt for dt, _, _ in spans["_register_keyframe"]]
    swap_host, swap_start, swap_end = spans["_adopt_vocab"][0]
    print(f"reloc_kitti: {n_frames} frames 1241x376, relocalization on, async mapping | "
          f"{reloc_ms:.2f} ms/frame over frames {timed.start}-{timed.stop - 1} (phase 9 without "
          f"place recognition, same frames: {1e3 * float(np.mean(slam_lat[timed])):.2f}) | "
          f"keyframes {slam.n_keyframes} (valid {int(m.kf_valid.sum())}) | map "
          f"points {int(m.pt_valid.sum())} | vocabulary from frame 0, retrained at 8 keyframes "
          f"in {train_s[0]:.2f} s host (worker thread), swapped at 12: "
          f"{1e3 * swap_host:.1f} ms host, {swap_start.elapsed_time(swap_end):.1f} ms device | "
          f"_register_keyframe host ms: median {np.median(reg_ms):.2f}, max {max(reg_ms):.1f} "
          f"x{len(reg_ms)} | database rows {int(db.has_row.sum())}, max abs err vs recomputed "
          f"{row_err:.1e} | peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
          f"| launches/frame {per_frame(reloc_launches, n_frames)}", flush=True)
    print(f"reloc_kitti_time: device busy {busy_ms:.2f} ms/frame in {ops:.0f} device ops "
          f"(torch.profiler, frames {n_plain}-{n_frames - 1} of the same run) | idle share "
          f"{1 - busy_ms / reloc_ms:.3f} of {reloc_ms:.2f} ms/frame", flush=True)

    t_phase.append(time.perf_counter())
    # -- 13. a kidnap on phase 12's map ---------------------------------------
    tried, fed = kidnap_drive(slam, lefts, rights, gt, cam.fps, torch.cuda.synchronize)
    recovered = [t for t in tried if t[2]]
    label, lost_end, err_end = fed[-1]
    inl = int(slam.last_stats[0])
    print(f"reloc_kidnap: rungs tried: {fmt_tried(tried)} | per frame (lost, pose error m): "
          + ", ".join(f"{lb} {'lost' if lost else 'ok'}"
                      + (f" {err:.4f}" if err is not None else "") for lb, lost, err in fed)
          + f" | recovered by {recovered[0][1] if recovered else 'no rung'} | inliers at "
          f"{label}: {inl} | bound {KIDNAP_BOUND_M} m (reference package on the CPU: "
          f"{REFERENCE_KIDNAP_ERR_M} m)", flush=True)
    if not recovered or lost_end or not err_end < KIDNAP_BOUND_M:
        raise AssertionError(f"kidnap: at {label} lost={lost_end}, pose error {err_end} m "
                             f"(bound {KIDNAP_BOUND_M}), recovered by {recovered}")
    slam.finish()

    # relocalize / relocalize_brute on frame 6: the card against the CPU
    frame = process_stereo(torch.from_numpy(lefts[6]).to(dev), torch.from_numpy(rights[6]).to(dev),
                           cfg, 0.0)
    reloc_card_vs_cpu(slam, frame, gt[6], cfg)
    kidnapped = slam      # phase 14 goes on from this map

    t_phase.append(time.perf_counter())
    # -- 14. localization-only mode -----------------------------------------
    # the two scenarios of tests/test_tracking_only.py at 512x256
    tl, tr_, tgt, _ = synthetic.render_stereo_sequence(fcfg, n_frames=16, n_points=500, seed=5,
                                                       step=0.25)
    slam = slam_mod.StereoSlam(fcfg, device=dev, enable_loop_closing=False)
    drive_slam(slam, tl[:10], tr_[:10], fcfg.camera.fps)
    slam.finish()
    kfs_before, pts_before = slam.n_keyframes, int(slam.map.pt_valid.sum())
    slam.tracking_only = True
    drive_slam(slam, tl[10:], tr_[10:], fcfg.camera.fps, start=10)
    slam.finish()
    ate_only = trajectory.ate_rmse([t.cpu().numpy() for t in slam.trajectory], list(tgt),
                                   align=False)
    if slam.n_keyframes != kfs_before or int(slam.map.pt_valid.sum()) > pts_before:
        raise AssertionError("tracking_only: the frozen map changed")
    if not ate_only < 0.2:
        raise AssertionError(f"tracking_only: ATE {ate_only:.4f} m >= 0.2 m")
    # off the map: the reference test's 24 frames
    n_off = 24
    tl, tr_, _, _ = synthetic.render_stereo_sequence(fcfg, n_frames=n_off, n_points=500, seed=5,
                                                     step=0.6)
    slam = slam_mod.StereoSlam(fcfg, device=dev, enable_loop_closing=False)
    decisions, inner_need = [], slam._need_new_keyframe

    def noted_need(tracked, n_tracked_close, n_untracked_close):
        # the keyframe rule's inputs: the count of keyframes built here sets
        # where the map ends, and it hangs on "> 70 untracked close points"
        need = inner_need(tracked, n_tracked_close, n_untracked_close)
        decisions.append(f"{n_tracked_close}/{n_untracked_close}{'*' if need else ''}")
        return need

    slam._need_new_keyframe = noted_need
    drive_slam(slam, tl[:6], tr_[:6], fcfg.camera.fps)
    slam.finish()
    del slam._need_new_keyframe
    kfs_off = slam.n_keyframes
    slam.tracking_only = True
    vo_frames = []
    for i in range(6, n_off):
        drive_slam(slam, tl[i:i + 1], tr_[i:i + 1], fcfg.camera.fps, start=i)
        if slam._vo_mode:
            vo_frames.append(i)
    if not vo_frames or slam.n_keyframes != kfs_off:
        raise AssertionError(f"tracking_only: VO mode on frames {vo_frames}, keyframes "
                             f"{kfs_off} -> {slam.n_keyframes}")
    print(f"tracking_only_fixture: 512x256 | frozen map: 10 + 6 frames, keyframes "
          f"{kfs_before} and map points {pts_before} unchanged, ATE {ate_only:.4f} m (bound "
          f"0.2 m) | off the map: {kfs_off} keyframes over 6 frames (close points tracked/"
          f"untracked at frames 1-5, * = keyframe: {' '.join(decisions)}), then {n_off - 6} frames "
          f"at step 0.6: VO mode from frame {vo_frames[0]} on {len(vo_frames)} frames, every "
          f"pose finite", flush=True)

    # at KITTI size on phase 12's map: a frame without a feature puts the
    # tracker into VO mode, frames 12-17 must snap it back
    slam = kidnapped
    slam.finish()
    frozen = slam.map
    kfs_before = slam.n_keyframes
    slam.tracking_only = True
    tried = []
    inner_reloc = slam._try_relocalize

    def noted_reloc(cur):
        ok = inner_reloc(cur)
        tried.append(bool(ok))
        return ok

    slam._try_relocalize = noted_reloc
    blank = np.full(lefts[0].shape, 100.0, np.float32)
    replay = [("blank", blank, blank, None)] + [(f"frame{i}", lefts[i], rights[i], gt[i])
                                                  for i in range(12, 18)]
    errs = []
    for k, (label, left, right, T_gt) in enumerate(replay):
        T = slam.process(left, right, timestamp=(n_frames + 10 + k) / cam.fps)
        if not np.isfinite(T.cpu().numpy()).all():
            raise AssertionError(f"tracking_only: non-finite pose at {label}")
        if T_gt is not None:
            errs.append(pose_err(T, T_gt))
    slam.finish()
    # frozen: everything but the tracker's visible/found counters
    changed = [name for name, a, b in zip(frozen._fields, slam.map, frozen)
               if name not in ("pt_visible", "pt_found") and not torch.equal(a, b)]
    # relocalization is tried once per frame in VO mode (with decisions one
    # frame late, the flag rises and clears inside the step that snaps back)
    print(f"tracking_only_kitti: on phase 12's map, 1 frame without a feature then frames "
          f"12-17 | frames in VO mode (one relocalization attempt each): {len(tried)}, "
          f"snapped back: {sum(tried)} | pose error m at frames 12-17 "
          + " / ".join(f"{e:.4f}" for e in errs)
          + f" | map fields changed: {changed or 'none'}, keyframes {kfs_before} -> "
          f"{slam.n_keyframes}", flush=True)
    if changed or slam.n_keyframes != kfs_before:
        raise AssertionError(f"tracking_only: the map changed at KITTI size: {changed}")
    if not any(tried) or slam._vo_mode:
        raise AssertionError(f"tracking_only: relocalizations {tried}, still in VO mode: "
                             f"{slam._vo_mode}")
    if not errs[-1] < KIDNAP_BOUND_M:
        raise AssertionError(f"tracking_only: pose error {errs[-1]:.4f} m at frame 17 "
                             f"(bound {KIDNAP_BOUND_M})")
    t_phase.append(time.perf_counter())
    print("reloc_phases_seconds: phase 12 / 13 / 14: "
          + " / ".join(f"{b - a:.1f}" for a, b in zip(t_phase, t_phase[1:])), flush=True)

    return reloc_launches, lat


def _pose_gap(A, B, valid):
    """``(max translation difference m, max rotation angle rad)`` between two
    ``[K, 4, 4]`` pose sets over the ``valid`` slots (host numpy)."""
    import numpy as np

    A = _host(A)[valid].astype(np.float64)
    B = _host(B)[valid].astype(np.float64)
    if not len(A):
        return 0.0, 0.0
    dt = float(np.abs(A[:, :3, 3] - B[:, :3, 3]).max())
    # ||R_a - R_b||_F = 2 sqrt(2) sin(angle / 2): exact 0 for equal matrices
    chord = np.linalg.norm(A[:, :3, :3] - B[:, :3, :3], axis=(1, 2)) / (2.0 * np.sqrt(2.0))
    return dt, float((2.0 * np.arcsin(np.clip(chord, 0.0, 1.0))).max())


def synced_ms(fn, reps: int = 3):
    """``(median ms, last result)`` of ``fn()`` with a sync on both sides."""
    import numpy as np
    import torch

    ms, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    return float(np.median(ms)), out


# the loop slice's modules and driver methods, for the sync report
LOOP_FILES = ("loop_closing.py", "global_ba.py", "gba.py", "pose_graph.py", "horn.py")
LOOP_METHODS = ("_try_harvest_loop", "_dispatch_verify", "_service_gba")
# the functions that held the host syncs repaired with the sensor slice: the
# dump-slot writes now go through ``fill_at``; the scale, timestamp, angle
# bin and pose-row constants are device fills; the images go through
# pinned buffers (``_to_device``)
REPAIRED_SYNC_FUNCS = ("fill_at", "_alloc_point_slots", "_fuse_core", "_mark",
                       "_search_local_points", "track_frame_with_map", "extract_local_ba_grid",
                       "local_mapping_step", "cull_keyframes", "_to_features", "_to_device",
                       "brief_from_blurred", "stereo_match", "process_stereo", "make_T")


class _SyncCounter:
    """Counts the host syncs ``torch.cuda.set_sync_debug_mode("warn")``
    reports, by the call site in the port that made them, and apart those
    made inside the loop slice's code (``LOOP_FILES``, ``LOOP_METHODS``)."""

    def __init__(self):
        self.sites = {}
        self.loop_sites = {}      # syncs made inside the loop slice's code
        self.n = 0

    def __enter__(self):
        import traceback
        import warnings

        import torch

        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")

        def show(message, category, filename, lineno, file=None, line=None):
            # the sync's own warning; not the one-time notice, on entering the
            # mode, that it "does not yet detect all synchronizing operations"
            if "called a synchronizing" not in str(message):
                return
            self.n += 1
            site = loop_site = outside = None
            for fr in reversed(traceback.extract_stack()[:-1]):
                if "opendlv_perception_vision_orbslam2_tpu_torch" not in fr.filename:
                    if outside is None and "/torch/" not in fr.filename and \
                            "warnings" not in fr.filename:
                        outside = f"outside the port: {Path(fr.filename).name}:{fr.lineno} " \
                                  f"{fr.name}"
                    continue
                here = f"{Path(fr.filename).name}:{fr.lineno} {fr.name}"
                site = site or here
                if Path(fr.filename).name in LOOP_FILES or fr.name in LOOP_METHODS:
                    loop_site = f"{site} <- {here}" if here != site else here
                    break
            site = site or outside or "other"
            self.sites[site] = self.sites.get(site, 0) + 1
            if loop_site is not None:
                self.loop_sites[loop_site] = self.loop_sites.get(loop_site, 0) + 1

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        return False


def loop_phases(cfg, dev, closure_path=None):
    """Phases 15-16 (see the module's docstring) on the KITTI-size loop
    circuit; phase 16's closure map (where its GBA starts) is saved to
    ``closure_path`` for phase 20.  Returns phase 15's launch counts, the
    circuit's ``(lefts, rights, gt)`` (phase 22 drives it again) and phase
    15's median ms/frame."""
    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.models import global_ba, loop_closing
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import gba as gba_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import pose_graph
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import trajectory

    t_phase = [time.perf_counter()]
    lefts, rights, gt, _ = render_loop_circuit(cfg)
    n = lefts.shape[0]
    render_s = time.perf_counter() - t_phase[0]

    # -- 15. the loop circuit -------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    slam = slam_mod.StereoSlam(cfg, device=dev)        # loop closing + relocalization on
    frame = [0]
    labels = {}                                        # frame -> what ran in it

    def label(what):
        labels.setdefault(frame[0], []).append(what)

    def noting(obj, name, what, extra=None):
        inner = getattr(obj, name)

        def wrapped(*args, **kwargs):
            if what is not None:
                label(what)
            out = inner(*args, **kwargs)
            if extra is not None:
                extra(args, out)
            return out
        setattr(obj, name, wrapped)
        return inner

    growth, verifies, matches, sets_drawn, gba_spans, merges = [], [], [], [], {}, []

    def grew(args, _):
        K, P = slam.map.kf_capacity, slam.map.pt_capacity
        if (K, P) != growth_prev[0]:
            growth.append((frame[0], growth_prev[0], (K, P)))
            label(f"capacity growth to {K} kf / {P} points")
        growth_prev[0] = (K, P)

    growth_prev = [(slam.map.kf_capacity, slam.map.pt_capacity)]
    noting(slam, "_maybe_resize", None, grew)
    noting(slam, "_insert_only", "keyframe insert")
    noting(slam, "_dispatch_mapping", "mapping stage")
    noting(slam, "_register_keyframe", "registration + loop detection")
    noting(slam, "_adopt_vocab", "vocabulary swap")
    noting(slam, "_dispatch_verify", "Sim3 verification + masked correction",
           lambda args, _: verifies.append((frame[0], args[0], slam_state)))
    wrap_rungs(slam, lambda name, ok, sec: label(f"{RUNGS[name]} rung"))
    slam_state = None

    inner_dispatch = slam._dispatch_verify

    def stash_dispatch(det):
        nonlocal slam_state
        slam_state = (slam.map, slam.db, slam.kf_nodes)     # the verification's inputs
        return inner_dispatch(det)
    slam._dispatch_verify = stash_dispatch

    inner_clt, inner_sets = loop_closing.compute_loop_transform, loop_closing.sample_sets

    def stash_clt(*args, **kwargs):
        lm = inner_clt(*args, **kwargs)
        matches.append(lm)
        return lm

    def stash_sets(pair_ok, generator, *a):
        sets = inner_sets(pair_ok, generator, *a)
        sets_drawn.append((pair_ok, sets))
        return sets

    class TimedGBA(global_ba.IncrementalGBA):
        def step(self):
            label("GBA chunk")
            return super().step()

        def merge(self, m):
            label("GBA merge")
            merges.append(frame[0])
            return super().merge(m)

    host_spans(TimedGBA, ("step",), gba_spans)
    loop_closing.compute_loop_transform, loop_closing.sample_sets = stash_clt, stash_sets
    inner_gba, slam_mod.IncrementalGBA = slam_mod.IncrementalGBA, TimedGBA
    lat, lost, closures, profiled, prof = [], [], [], set(), None
    try:
        reset_launches()
        with _SyncCounter() as syncs:
            def next_frame():
                i = frame[0] = len(lat)
                loops = slam.loops_closed
                t = time.perf_counter()
                T = slam.process(lefts[i], rights[i], timestamp=i / LOOP_FPS)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t)
                if T is None:
                    raise AssertionError(f"loop circuit: stereo initialization failed at frame {i}")
                if slam.lost:
                    lost.append(i)
                if slam.loops_closed != loops:
                    closures.append(i)
                return T

            n_sync_warm = 0
            while len(lat) < n:
                if len(lat) == LOOP_WARM:
                    n_sync_warm = syncs.n
                if (prof is None and slam.pending_gba is not None and len(lat) >= LOOP_WARM
                        and len(lat) + 6 <= n):
                    first = len(lat)
                    prof = device_busy(next_frame, 6) + (first,)
                    profiled.update(range(first, first + 6))
                else:
                    next_frame()
            n_sync = syncs.n - n_sync_warm
            launches = read_launches()
            slam.finish()
    finally:
        loop_closing.compute_loop_transform, loop_closing.sample_sets = inner_clt, inner_sets
        slam_mod.IncrementalGBA = inner_gba
        unwrap_rungs(slam)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t_phase.append(time.perf_counter())

    expected = {"fast_nms": 0, "fast_nms_pyramid": n, "gather_patches": n,
                "gather_patches_multi": n}
    if launches != expected:
        raise AssertionError(f"loop circuit: kernel launches {launches}, expected {expected}")
    est = slam.corrected_trajectory()
    raw = [T.cpu().numpy() for T in slam.trajectory]
    if len(est) != n or not all(np.isfinite(T).all() for T in est + raw):
        raise AssertionError("loop circuit: a pose is missing or not finite")
    ate = trajectory.ate_rmse(est, list(gt), align=True)
    ate_raw = trajectory.ate_rmse(raw, list(gt), align=True)
    timed = [i for i in range(LOOP_WARM, n) if i not in profiled]
    tl = 1e3 * np.array([lat[i] for i in timed])
    worst = timed[int(np.argmax(tl))]
    m = slam.map
    print(f"loop_kitti: {n} frames 1241x376 (bench.py's circuit: radius 35 m, 1.25 laps, "
          f"rendered in {render_s:.1f} s), StereoSlam(cfg) defaults, async | frames "
          f"{LOOP_WARM}-{n - 1} without the {len(profiled)} profiled: "
          f"{1e3 / tl.mean():.2f} frames/s, ms/frame median {np.median(tl):.2f} mean "
          f"{tl.mean():.2f} worst {tl.max():.2f} (frame {worst}: "
          f"{'; '.join(labels.get(worst, ['tracking only']))}) | keyframes "
          f"{slam.n_keyframes} (valid {int(m.kf_valid.sum())}) | map points "
          f"{int(m.pt_valid.sum())} | lost {len(lost)} of {n} {lost} (bound < "
          f"{LOOP_LOST_SHARE * n:g}) | "
          f"loops {slam.loops_closed} | ATE corrected {ate:.4f} m, raw {ate_raw:.4f} m "
          f"(align=True, bound {LOOP_ATE_BOUND_M} m; the reference package "
          f"{REFERENCE_LOOP_ATE_M} m on the CPU, 0.141 m in BENCH_r05.json) | peak device "
          f"memory {peak_gb:.3f} GB | launches/frame {per_frame(launches, n)}", flush=True)

    # closures: the verification that closed each loop
    closed = []
    for i in closures:
        # the verdict landed at frame i: the last verification dispatched before it
        k = max(j for j, (f, _, _) in enumerate(verifies) if f <= i)
        closed.append(k)
        f_v, (cur, cur_id, cand, cand_id), _ = verifies[k]
        lm = matches[k]
        print(f"loop_closure: verdict at frame {i}, verification dispatched at frame {f_v}: "
              f"current keyframe slot {cur} id {cur_id}, candidate slot {cand} id {cand_id} | "
              f"n_inliers {int(lm.n_inliers)} n_total {int(lm.n_total)} | s_rel "
              f"{float(lm.s_rel):.4f}", flush=True)
    print(f"loop_verifications: {len(verifies)} dispatched at frames "
          f"{[f for f, _, _ in verifies]}, {len(closures)} closed", flush=True)
    for f, before, after in growth:
        print(f"loop_capacity: frame {f}: {before[0]} kf / {before[1]} points -> {after[0]} kf / "
              f"{after[1]} points", flush=True)
    chunk_ms = [s.elapsed_time(e) for _, s, e in gba_spans.get("step", [])]
    print(f"loop_gba: {len(chunk_ms)} chunks, device ms per chunk (CUDA events) "
          + (f"median {np.median(chunk_ms):.2f} max {max(chunk_ms):.2f}" if chunk_ms else "none")
          + f" | merged at frames {merges}", flush=True)
    if prof is not None:
        busy_ms, ops, first = prof
        prof_ms = 1e3 * float(np.mean(lat[first:first + 6]))
        print(f"loop_device: frames {first}-{first + 5} with GBA chunks running: device busy "
              f"{busy_ms:.2f} ms/frame in {ops:.0f} device ops (torch.profiler) | idle share "
              f"{1 - busy_ms / prof_ms:.3f} of {prof_ms:.2f} ms/frame (profiled)", flush=True)
    top = sorted(syncs.sites.items(), key=lambda kv: -kv[1])
    loop_sites = sorted(syncs.loop_sites.items(), key=lambda kv: -kv[1])
    repaired = sum(v for k, v in top if k.split()[-1] in REPAIRED_SYNC_FUNCS)
    print(f"loop_syncs: {n_sync} host syncs over frames {LOOP_WARM}-{n - 1} "
          f"({n_sync / (n - LOOP_WARM):.2f} a frame; torch.cuda.set_sync_debug_mode), "
          f"{syncs.n} over the whole drive, {repaired} of them at the repaired sites | every "
          "site (innermost frame in the port): " + "; ".join(f"{k} x{v}" for k, v in top)
          + " | in the loop-closing and GBA code: "
          + ("; ".join(f"{k} x{v}" for k, v in loop_sites) or "none"), flush=True)
    if slam.loops_closed < 1:
        raise AssertionError("loop circuit: no loop closed")
    if not growth or growth[-1][2][0] <= LOOP_INITIAL_KF_SLOTS:
        raise AssertionError(f"loop circuit: the map never grew past {LOOP_INITIAL_KF_SLOTS} "
                             f"keyframe slots {growth}")
    if not len(lost) < LOOP_LOST_SHARE * n:
        raise AssertionError(f"loop circuit: frames {lost} lost of {n}")
    if not ate < LOOP_ATE_BOUND_M:
        raise AssertionError(f"loop circuit: ATE {ate:.4f} m >= {LOOP_ATE_BOUND_M} m")

    # per-layer ms on the closing verification's inputs, synced both sides
    k = closed[0]
    _, (cur, cur_id, cand, cand_id), (m0, db0, nodes0) = verifies[k]
    pair_ok_card, sets_card = sets_drawn[k]
    layers = {}
    layers["loop_candidates"], _ = synced_ms(lambda: loop_closing.loop_candidates(m0, db0, cur))
    layers["_geometric_loop_query"], _ = synced_ms(
        lambda: loop_closing._geometric_loop_query(m0, cur, cfg))
    closer = loop_closing.LoopCloser(cfg, dev)
    closer._geo_tick = 2                              # the next dispatch runs the vote
    pend = closer.dispatch(m0, db0, nodes0, cur, cur_id)
    pend["fetch"].result()
    t = time.perf_counter()
    closer.harvest_detect(pend)
    layers["harvest_detect (host)"] = 1e3 * (time.perf_counter() - t)
    fixed_sets = lambda pair_ok, generator, *a: sets_card.to(pair_ok.device)  # noqa: E731
    loop_closing.sample_sets = fixed_sets
    try:
        layers["verify_and_apply"], (m_v, valid, _, _) = synced_ms(
            lambda: loop_closing.verify_and_apply(m0, nodes0, cur, cand, cur_id, cand_id, None,
                                                  cfg, True))
        lm = loop_closing.compute_loop_transform(m0, nodes0, cur, cand, None, cfg, True)
    finally:
        loop_closing.sample_sets = inner_sets
    if not bool(valid):
        raise AssertionError("loop circuit: the closing verification declines when repeated")
    layers["correct_loop"], m_c = synced_ms(
        lambda: loop_closing.correct_loop(m0, cur, cand, lm.T_rel, lm.s_rel))
    edges = loop_closing.build_essential_edges(m0, cur, cand, lm.T_rel, lm.s_rel)
    pg = pose_graph.PoseGraphProblem(
        T=m0.kf_T_cw, v_valid=m0.kf_valid,
        v_fixed=torch.arange(m0.kf_capacity, device=dev) == cand, e_i=edges.e_i,
        e_j=edges.e_j, e_T_ij=edges.e_T, e_weight=edges.e_w, e_valid=edges.e_valid,
        e_s_ij=edges.e_s)
    layers["optimize_pose_graph"], pg_out = synced_ms(
        lambda: pose_graph.optimize_pose_graph(pg, n_iters=15))
    gba = global_ba.IncrementalGBA(m_c, cfg)
    layers["global_bundle_adjust_chunk"], carry = synced_ms(
        lambda: gba_mod.global_bundle_adjust_chunk(
            gba.prob, gba.carry, fx=cfg.camera.fx, fy=cfg.camera.fy, cx=cfg.camera.cx,
            cy=cfg.camera.cy, bf=cfg.camera.bf, n_outer=1, cg_iters=gba.cg_iters,
            sums=gba.sums))
    # run-to-run spread on the card (0: every sum runs in a fixed order)
    pg_again = pose_graph.optimize_pose_graph(pg, n_iters=15)
    carry_again = gba_mod.global_bundle_adjust_chunk(
        gba.prob, gba.carry, fx=cfg.camera.fx, fy=cfg.camera.fy, cx=cfg.camera.cx,
        cy=cfg.camera.cy, bf=cfg.camera.bf, n_outer=1, cg_iters=gba.cg_iters, sums=gba.sums)
    spread_pg = float((pg_again[0] - pg_out[0]).abs().max())
    spread_gba = float((carry_again[0] - carry[0]).abs().max())
    print(f"loop_layers: on the closing verification's inputs (K {m0.kf_capacity}, P "
          f"{m0.pt_capacity}, {int(m0.kf_valid.sum())} keyframes), median of 3, sync both sides: "
          + " | ".join(f"{name} {ms:.2f} ms" for name, ms in layers.items())
          + f" | run-to-run spread on the card: pose graph {spread_pg:.3g}, GBA chunk poses "
          f"{spread_gba:.3g}", flush=True)
    t_phase.append(time.perf_counter())

    # -- 16. the loop stages on the card against the CPU -----------------------
    m0c, nodes0c, sets_cpu = to_cpu(m0), nodes0.cpu(), sets_card.cpu()
    pair_oks = []

    def recorded_sets(pair_ok, generator, *a):
        pair_oks.append(pair_ok.cpu())
        return sets_cpu.to(pair_ok.device)

    loop_closing.sample_sets = recorded_sets
    try:
        lm_card = loop_closing.compute_loop_transform(m0, nodes0, cur, cand, None, cfg, True)
        lm_cpu = loop_closing.compute_loop_transform(m0c, nodes0c, cur, cand, None, cfg, True)
    finally:
        loop_closing.sample_sets = inner_sets
    same_pairs = torch.equal(pair_oks[0], pair_oks[1]) and torch.equal(pair_oks[0],
                                                                       pair_ok_card.cpu())
    counts = [(bool(x.ok), int(x.n_inliers), int(x.n_total)) for x in (lm_card, lm_cpu)]
    d_rel = float((lm_card.T_rel.cpu() - lm_cpu.T_rel).abs().max())
    c_card = loop_closing.correct_loop(m0, cur, cand, lm_card.T_rel, lm_card.s_rel)
    c_cpu = loop_closing.correct_loop(m0c, cur, cand, lm_card.T_rel.cpu(), lm_card.s_rel.cpu())
    valid_kf = m0c.kf_valid.numpy()
    dt_c, dr_c = _pose_gap(c_card.kf_T_cw, c_cpu.kf_T_cw, valid_kf)
    if closure_path is not None:
        torch.save(to_cpu(c_card), closure_path)
    g_card = global_ba.IncrementalGBA(c_card, cfg)
    g_cpu = global_ba.IncrementalGBA(to_cpu(c_card), cfg)
    carry0 = g_card.carry
    g_card.step()
    g_cpu.step()
    # the same chunk again on the card: bit for bit (fixed-order sums)
    again = gba_mod.global_bundle_adjust_chunk(
        g_card.prob, carry0, fx=cfg.camera.fx, fy=cfg.camera.fy, cx=cfg.camera.cx,
        cy=cfg.camera.cy, bf=cfg.camera.bf, n_outer=1, cg_iters=g_card.cg_iters,
        sums=g_card.sums)
    chunk_bits = all(torch.equal(a, b) for a, b in zip(again, g_card.carry))
    cost_card, cost_cpu = float(g_card.carry[3]), float(g_cpu.carry[3])
    dt_g, dr_g = _pose_gap(g_card.carry[0], g_cpu.carry[0], valid_kf)
    # where card and CPU part: the same chunk stopped after 5-40 CG steps,
    # in float32 and in float64 on both devices
    cam = cfg.camera
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf)

    def chunk(prob, cg):
        return gba_mod.global_bundle_adjust_chunk(prob, gba_mod.gba_init_carry(prob), **kw,
                                                  cg_iters=cg)[0]

    f64 = lambda p: type(p)(*(x.double() if x.is_floating_point() else x for x in p))  # noqa: E731
    steps = []
    for cg in (5, 10, 20, 40):
        t = {(d, b): chunk(f64(p) if b == 64 else p, cg)
             for d, p in (("card", g_card.prob), ("CPU", g_cpu.prob)) for b in (32, 64)}
        steps.append((cg, _pose_gap(t["card", 32], t["CPU", 32], valid_kf)[0],
                      _pose_gap(t["card", 32], t["card", 64], valid_kf)[0],
                      _pose_gap(t["CPU", 32], t["CPU", 64], valid_kf)[0],
                      _pose_gap(t["card", 64], t["CPU", 64], valid_kf)[0]))
    print(f"loop_card_vs_cpu: closing keyframe slot {cur} vs candidate slot {cand}, the card's "
          f"RANSAC sets on both | compute_loop_transform: pairs "
          f"{'identical' if same_pairs else 'DIFFER'} ({int(pair_oks[0].sum())}), (ok, "
          f"n_inliers, n_total) card {counts[0]} CPU {counts[1]}, T_rel max diff {d_rel:.3g} "
          f"(bound 1e-3) | correct_loop: keyframe poses {dt_c:.3g} m, {dr_c:.3g} rad (bounds "
          f"1e-3) | one GBA chunk: cost {cost_card:.6g} vs {cost_cpu:.6g} (relative "
          f"{abs(cost_card - cost_cpu) / abs(cost_cpu):.3g}, bound 1e-3), poses {dt_g:.3g} m, "
          f"{dr_g:.3g} rad (bounds 1e-3) | the chunk twice on the card: "
          f"{'bit-equal' if chunk_bits else 'DIFFERENT'} (segment sums by pose and by point)",
          flush=True)
    print("loop_gba_precision: one chunk after 5/10/20/40 CG steps, max keyframe translation "
          "gap m | card-CPU float32, card float32-float64, CPU float32-float64, card-CPU "
          "float64: " + " | ".join(f"{cg}: {a:.3g}, {b:.3g}, {c:.3g}, {d:.3g}"
                                   for cg, a, b, c, d in steps), flush=True)
    if not same_pairs or counts[0] != counts[1] or not d_rel < 1e-3:
        raise AssertionError("loop card vs CPU: compute_loop_transform differs")
    if not (dt_c < 1e-3 and dr_c < 1e-3):
        raise AssertionError("loop card vs CPU: correct_loop differs")
    if not (abs(cost_card - cost_cpu) < 1e-3 * abs(cost_cpu) and dt_g < 1e-3 and dr_g < 1e-3):
        raise AssertionError("loop card vs CPU: the GBA chunk differs")
    if not chunk_bits:
        raise AssertionError("GBA: one chunk run twice on the card differs")
    t_phase.append(time.perf_counter())
    print("loop_phases_seconds: phase 15 drive / 15 layers / 16: "
          + " / ".join(f"{b - a:.1f}" for a, b in zip(t_phase, t_phase[1:])), flush=True)
    return launches, (lefts, rights, gt), float(np.median(tl))


# Phase 17: tests/test_rgbd.py's ATE bound, on phase 9's world and poses
# continued to 48 frames.  On phase 9's 24 frames the reference package
# makes 4 keyframes on the CPU, as the port does on the card, and 8 over
# these 48 (tests/test_torch_rgbd.py::test_kitti_rgbd_reference_run, which
# holds it to this phase's gates): exact depth keeps the tracked share above
# the keyframe rule's thresholds, and >= 5 keyframes are needed for keyframe
# culling to run.
RGBD_ATE_BOUND_M = 0.10
RGBD_FRAMES = 48
RGBD_DRIVE = dict(n_points=900, seed=0, step=0.6)      # phase 9's world and poses
# Phase 18: tests/test_mono.py's lateral drive at KITTI size (sideways-
# dominant motion over a close world: forward motion is the degenerate case
# that the reference's 0.9 N reconstruction gates refuse), and its bars
MONO_DRIVE = dict(n_frames=20, n_points=2000, seed=9, step=0.05, step_x=0.15,
                  z_range=(3.0, 15.0))
# Initialized by this frame.  tests/test_mono.py's bar is frame 4 on its
# 512x256 fixture, where the reference initializes at frame 2.  On this
# drive the reference package initializes at frame 7 on the CPU (from frame
# 4, after resets of the init frame;
# tests/test_torch_mono.py::test_kitti_mono_reference_run, which holds it to
# this phase's gates): the bound keeps the fixture's two frames of margin.
MONO_INIT_BY = 9
MONO_MIN_POINTS = 50         # more map points than this
MONO_MIN_COS = 0.966         # translation direction within 15 degrees of the truth
MONO_LOST_AFTER = 4          # not lost within this many frames of initialization
MONO_INIT_POSE_TOL = 1e-3    # the initializer's T_21, card against CPU


def _check_pose(what, i, T, slam):
    """Raise if frame ``i``'s pose is missing or not finite, or tracking is lost."""
    import numpy as np

    if T is None:
        raise AssertionError(f"{what}: no pose at frame {i}")
    if not np.isfinite(T.cpu().numpy()).all():
        raise AssertionError(f"{what}: non-finite pose at frame {i}")
    if slam.lost:
        raise AssertionError(f"{what}: tracking lost at frame {i}")


def rgbd_phase(cfg, dev, n_frames: int = RGBD_FRAMES):
    """Phase 17: ``StereoSlam(cfg).process_rgbd`` (loop closing and
    relocalization on, async) over phase 9's world and poses as RGB-D frames
    at KITTI size.  Returns its launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic, trajectory

    t0 = time.perf_counter()
    gc.collect()                 # the loop phases' maps out of this phase's peak
    rcfg = dataclasses.replace(cfg, camera_type="rgbd")
    grays, depths, gt, _ = synthetic.render_rgbd_sequence(rcfg, n_frames=n_frames, **RGBD_DRIVE)
    n, n_prof, fps = grays.shape[0], 6, cfg.camera.fps
    torch.cuda.reset_peak_memory_stats()
    slam = slam_mod.StereoSlam(rcfg, device=dev)
    reset_launches()
    lat, kf_at = [], []

    def frame(i):
        t = time.perf_counter()
        n_kf = slam.n_keyframes
        T = slam.process_rgbd(grays[i], depths[i], timestamp=i / fps)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        if slam.n_keyframes != n_kf:
            kf_at.append(i)
        _check_pose("RGB-D", i, T, slam)

    for i in range(n - n_prof):
        frame(i)
    todo = iter(range(n - n_prof, n))
    busy_ms, ops = device_busy(lambda: frame(next(todo)), n_prof)
    launches = read_launches()
    slam.finish()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    poses = [T.cpu().numpy() for T in slam.trajectory]
    ate = trajectory.ate_rmse(poses, list(gt))
    ate_raw = trajectory.ate_rmse(poses, list(gt), align=False)
    timed = 1e3 * np.array(lat[8:n - n_prof])         # steady frames, not profiled
    m = slam.map
    print(f"rgbd_kitti: {n} frames 1241x376 with depth maps (phase 9's world and poses), 2000 "
          f"features, "
          f"8 levels, StereoSlam(cfg).process_rgbd, async | frames 8-{n - n_prof - 1}: "
          f"{1e3 / timed.mean():.2f} frames/s, ms/frame median {np.median(timed):.2f} worst "
          f"{timed.max():.2f} | first frame {1e3 * lat[0]:.1f} ms | keyframes {slam.n_keyframes} "
          f"(valid {int(m.kf_valid.sum())}) | map points {int(m.pt_valid.sum())} | device busy "
          f"{busy_ms:.2f} ms/frame in {ops:.0f} device ops (torch.profiler, frames "
          f"{n - n_prof}-{n - 1}), idle share {1 - busy_ms / float(np.mean(timed)):.3f} | peak "
          f"device memory {peak_gb:.3f} GB | ATE {ate:.4f} m (align=True, bound "
          f"{RGBD_ATE_BOUND_M} m; align=False {ate_raw:.4f} m) | launches/frame "
          f"{per_frame(launches, n)} | keyframes inserted at frames {kf_at} | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if slam.lost:
        raise AssertionError("RGB-D: tracking lost at the last frame")
    expected = {"fast_nms": 0, "fast_nms_pyramid": n, "gather_patches": n,
                "gather_patches_multi": 0}
    if launches != expected:
        raise AssertionError(f"RGB-D: kernel launches {launches}, expected {expected}")
    if slam.n_keyframes < 5:
        raise AssertionError(f"RGB-D: {slam.n_keyframes} keyframes in {n} frames, need >= 5")
    if not ate < RGBD_ATE_BOUND_M:
        raise AssertionError(f"RGB-D: ATE {ate:.4f} m >= {RGBD_ATE_BOUND_M} m")
    return launches


def mono_phase(cfg, dev):
    """Phase 18: ``MonocularSlam(cfg)`` with its defaults over ``MONO_DRIVE``
    at KITTI size, and the initializer's successful attempt on the card
    against the CPU from the same sets.  Returns its launch counts."""
    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.models import initializer
    from opendlv_perception_vision_orbslam2_tpu_torch.models import mono_slam as mono_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic, trajectory

    t0 = time.perf_counter()
    lefts, _, gt, _ = synthetic.render_stereo_sequence(cfg, **MONO_DRIVE)
    n, fps = lefts.shape[0], cfg.camera.fps
    slam = mono_mod.MonocularSlam(cfg, device=dev)
    attempts, inner = [], mono_mod.initialize_two_view

    def recorded(*args, **kwargs):
        res = inner(*args, **kwargs)
        attempts.append((args, kwargs, res))
        return res

    mono_mod.initialize_two_view = recorded
    reset_launches()
    lat, lost, init_at, ref_idx, ref_at = [], [], None, None, None
    try:
        for i in range(n):
            ref_before = slam._init_ref
            t = time.perf_counter()
            T = slam.process(lefts[i], timestamp=i / fps)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
            if not slam.initialized:
                if slam._init_ref is not None and slam._init_ref is not ref_before:
                    ref_idx = i            # this frame became the init frame
                continue
            if init_at is None:
                init_at, init_T, ref_at = i, T.cpu().numpy(), ref_idx
            if T is None or not np.isfinite(T.cpu().numpy()).all():
                raise AssertionError(f"mono: missing or non-finite pose at frame {i}")
            if slam.lost:
                lost.append(i)
    finally:
        mono_mod.initialize_two_view = inner
    launches = read_launches()
    slam.finish()
    expected = {"fast_nms": 0, "fast_nms_pyramid": n, "gather_patches": n,
                "gather_patches_multi": 0}
    if launches != expected:
        raise AssertionError(f"mono: kernel launches {launches}, expected {expected}")
    if init_at is None or init_at > MONO_INIT_BY:
        verdicts = [(bool(r.success), "H" if bool(r.used_homography) else "F",
                     int(r.point_ok.sum())) for _, _, r in attempts]
        raise AssertionError(f"mono: initialized at frame {init_at}, bound {MONO_INIT_BY}; "
                             f"initializer attempts (success, model, points) {verdicts}")
    T_gt = gt[init_at] @ np.linalg.inv(gt[ref_at])
    cos = float(init_T[:3, 3] @ T_gt[:3, 3]
                / (np.linalg.norm(init_T[:3, 3]) * np.linalg.norm(T_gt[:3, 3])))
    n_pts = int(slam.map.pt_valid.sum())
    est = slam.corrected_trajectory()
    gt_sel = [gt[ref_at]] + list(gt[init_at:])
    ate = (f"{trajectory.ate_rmse(est, gt_sel, with_scale=True):.4f} m" if len(est) == len(gt_sel)
           else f"not comparable ({len(est)} poses for {len(gt_sel)} frames: a reset)")

    # the successful attempt's initializer, card against CPU, the same sets
    # drawn once on the CPU
    (xy1, xy2, valid, _), kw, _ = [a for a in attempts if bool(a[2].success)][-1]
    sets = initializer.sample_sets(valid.cpu(), torch.Generator().manual_seed(21))
    init_ms, card = synced_ms(lambda: initializer.initialize_two_view(
        xy1, xy2, valid, sets=sets.to(dev), **kw))
    with _SyncCounter() as syncs:
        initializer.initialize_two_view(xy1, xy2, valid, sets=sets.to(dev), **kw)
        torch.cuda.synchronize()
    cpu = initializer.initialize_two_view(xy1.cpu(), xy2.cpu(), valid.cpu(), sets=sets, **kw)
    same = (bool(card.success) == bool(cpu.success)
            and bool(card.used_homography) == bool(cpu.used_homography)
            and torch.equal(card.point_ok.cpu(), cpu.point_ok))
    d_T = float((card.T_21.cpu() - cpu.T_21).abs().max())
    lat_ms = 1e3 * np.array(lat)
    print(f"mono_kitti: {n} frames 1241x376 (lateral drive: {MONO_DRIVE}), "
          f"MonocularSlam(cfg) defaults | initialized at frame {init_at} from frame {ref_at} "
          f"after {len(attempts)} initializer attempt(s) (bound: by frame {MONO_INIT_BY}) | "
          f"direction cosine {cos:.5f} (bound > {MONO_MIN_COS}) | keyframes {slam.n_keyframes} | "
          f"map points {n_pts} (bound > {MONO_MIN_POINTS}) | lost frames {lost} | ms/frame "
          f"until initialized median {np.median(lat_ms[:init_at + 1]):.2f}, after "
          f"{np.median(lat_ms[init_at + 1:]):.2f} (worst {lat_ms[init_at + 1:].max():.2f}) | "
          f"Sim3-aligned ATE {ate} (reported) | launches/frame {per_frame(launches, n)} | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"mono_initializer: the successful attempt ({int(valid.sum())} matches) from the same "
          f"sets: card {init_ms:.2f} ms (median of 3, sync both sides), {syncs.n} host syncs "
          f"({'; '.join(f'{k} x{v}' for k, v in sorted(syncs.sites.items()))}) | card vs CPU: "
          f"H/F {'H' if bool(card.used_homography) else 'F'} / "
          f"{'H' if bool(cpu.used_homography) else 'F'}, success {bool(card.success)} / "
          f"{bool(cpu.success)}, point_ok {'identical' if same else 'DIFFER'} "
          f"({int(card.point_ok.sum())} / {int(cpu.point_ok.sum())}), T_21 max diff {d_T:.3g} "
          f"(bound {MONO_INIT_POSE_TOL})", flush=True)
    if slam.n_keyframes < 2 or not n_pts > MONO_MIN_POINTS:
        raise AssertionError(f"mono: {slam.n_keyframes} keyframes, {n_pts} points")
    if not cos > MONO_MIN_COS:
        raise AssertionError(f"mono: direction cosine {cos:.4f} <= {MONO_MIN_COS}")
    if lost and lost[0] - init_at < MONO_LOST_AFTER:
        raise AssertionError(f"mono: lost at frame {lost[0]}, initialized at {init_at}")
    if not same or not d_T < MONO_INIT_POSE_TOL:
        raise AssertionError("mono: the initializer differs between card and CPU")
    return launches


# Phase 19: the service layer.  The KITTI-layout directory holds phase 9's
# 24 frames; the CLI runs with deploy/docker-compose.yml's flags.
SERVICE_DRIVE = dict(n_frames=24, n_points=900, seed=0, step=0.6)   # phase 9's frames
SERVICE_FLAGS = (
    "--name=cam0 --width=2560 --height=720 --bpp=24 --cameraType=stereo "
    "--Camera.fx=718.856 --Camera.fy=718.856 --Camera.cx=607.1928 --Camera.cy=185.2157 "
    "--Camera.k1=0 --Camera.k2=0 --Camera.k3=0 --Camera.p1=0 --Camera.p2=0 --Camera.fps=15 "
    "--Camera.bf=386.1448 --Camera.RGB=1 --ThDepth=35 --ORBextractor.nFeatures=2000 "
    "--ORBextractor.scaleFactor=1.2 --ORBextractor.nLevels=8 --ORBextractor.iniThFAST=20 "
    "--ORBextractor.minThFAST=7"
).split()   # deploy/docker-compose.yml:27-35 without --cid and --kittiPath
# The reference package's own CLI over this directory on the CPU: 14
# keyframes, never lost, ATE of its poses.txt 0.0103 m and of its re-chained
# trajectory after finish() 0.0109 m (align=True;
# tests/test_torch_service.py::test_kitti_cli_reference_run, which holds it
# to this phase's gates).  The bound leaves room for the port's own RANSAC
# draws (phase 7: the draw moves the VO's ATE by tens of cm).
SERVICE_ATE_BOUND_M = 0.05


def write_png_gray(path, img) -> None:
    """An 8-bit grayscale PNG of ``img`` [H, W] (rounded, clipped to 0-255):
    one IDAT of zlib-compressed rows, each with filter byte 0."""
    import struct
    import zlib

    import numpy as np

    u8 = np.clip(np.round(img), 0, 255).astype(np.uint8)
    h, w = u8.shape
    rows = np.hstack([np.zeros((h, 1), np.uint8), u8]).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n"
                           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(rows, 6)) + chunk(b"IEND", b""))


def write_kitti_dir(directory, lefts, rights, fps: float) -> None:
    """A KITTI-layout sequence: ``times.txt`` and ``image_0/``, ``image_1/``
    of 6-digit PNGs."""
    d = Path(directory)
    (d / "image_0").mkdir(parents=True, exist_ok=True)
    (d / "image_1").mkdir(parents=True, exist_ok=True)
    (d / "times.txt").write_text("".join(f"{i / fps:.6e}\n" for i in range(len(lefts))))
    for i, (left, right) in enumerate(zip(lefts, rights)):
        write_png_gray(d / "image_0" / f"{i:06d}.png", left)
        write_png_gray(d / "image_1" / f"{i:06d}.png", right)


def read_kitti_poses(path):
    """poses.txt rows (camera-to-world 3x4) as world->camera 4x4 poses."""
    import numpy as np

    rows = np.loadtxt(path, ndmin=2)
    T_wc = np.tile(np.eye(4), (len(rows), 1, 1))
    T_wc[:, :3, :] = rows.reshape(-1, 3, 4)
    return list(np.linalg.inv(T_wc))


# Phase 19's live path: the deploy flags with rectification from a small
# relative rotation and lens distortion, over 6 rendered side-by-side frames
SERVICE_LIVE_FLAGS = [
    "--cid=120", "--rectify=1", "--Camera.baseline=0.53716", "--Camera.rx=0.002",
    "--Camera.cv=-0.001", "--Camera.rz=0.0015", "--Camera.k1=-0.02", "--Camera.k2=0.005",
    "--Camera.p1=1e-4", "--Camera.p2=-1e-4"]
SERVICE_LIVE_FRAMES = 6
SERVICE_REMAP_TOL = 1e-3     # remap_bilinear, card against CPU, grey levels
# the service layer's files: host syncs whose innermost frame in the port is
# in one of them are the service layer's own
SERVICE_FILES = ("selflocalization.py", "kitti.py", "__main__.py")


class _Session:
    """An OD4 session stand-in that keeps what was sent (the live path's
    ``--cid`` opens no socket)."""

    def __init__(self, *args, **kwargs):
        self.sent = []

    def send(self, message, timestamp=None):
        self.sent.append(message)

    def close(self):
        pass


def service_phase(cfg, dev, phase12_lat):
    """Phase 19: the service layer at KITTI size.  The CLI in process over a
    KITTI-layout directory of phase 9's frames with the deploy flags; a
    ``Selflocalization`` with a recording session driven by ``KittiRunner``
    over the same directory; the live loop with rectification over rendered
    side-by-side frames.  ``phase12_lat`` is phase 12's seconds per frame.
    Returns the CLI drive's launch counts and its ms a frame from fps.txt."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as cli
    from opendlv_perception_vision_orbslam2_tpu_torch.io import kitti as kitti_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.io import od4 as od4_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.io.messages import (
        Geolocation, chunk_map_messages, encode_envelope,
    )
    from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as sel_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import undistort
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic, trajectory
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import config_from_flags

    t0 = time.perf_counter()
    gc.collect()
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(cfg, **SERVICE_DRIVE)
    n = lefts.shape[0]
    inner_sel = sel_mod.Selflocalization
    made, lost, drive_sites, posted = [], [], {}, []
    watch = {"syncs": None, "post": False}    # what Recording.track records

    class Recording(inner_sel):
        """Keeps the pipeline and each frame's lost flag; with
        ``watch["syncs"]`` the host syncs made inside ``track`` by site; with
        ``watch["post"]`` each frame's posted pose and frame 20's map
        (tensors, read after the drive)."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def track(self, *args, **kwargs):
            syncs = watch["syncs"]
            before = dict(syncs.sites) if syncs is not None else {}
            T = super().track(*args, **kwargs)
            lost.append(self.slam.lost)
            if watch["post"]:
                posted.append((self.slam.trajectory[-1],
                               self.slam.map if self.frame_count == 20 else None))
            if syncs is not None:
                for site, k in syncs.sites.items():
                    if k != before.get(site, 0):
                        drive_sites[site] = drive_sites.get(site, 0) + k - before.get(site, 0)
            return T

    with tempfile.TemporaryDirectory(prefix="chip_smoke_service_") as tmp:
        d = Path(tmp) / "kitti"
        write_kitti_dir(d, lefts, rights, cfg.camera.fps)
        write_s = time.perf_counter() - t0

        # -- 19a. the CLI, in process, on the card -----------------------------
        sel_mod.Selflocalization = Recording
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            with _SyncCounter() as syncs:
                watch["syncs"] = syncs
                rc = cli.main([f"--kittiPath={d}"] + SERVICE_FLAGS, ranks=1)
            watch["syncs"] = None
            launches = read_launches()
        finally:
            sel_mod.Selflocalization = inner_sel
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        pipe = made[0]
        slam = pipe.slam
        poses_txt = (d / "poses.txt").read_text().strip().splitlines()
        est = read_kitti_poses(d / "poses.txt")
        fps_rows = [line.split() for line in (d / "fps.txt").read_text().strip().splitlines()]
        ms = np.array([1e3 / float(f) for f, _ in fps_rows])
        ref_ms = 1e3 * np.array(phase12_lat)
        span = slice(1, min(len(ref_ms), n))
        service_syncs = {k: v for k, v in drive_sites.items()
                         if k.split(":")[0] in SERVICE_FILES}
        ate = trajectory.ate_rmse(est, list(gt)) if len(est) == n else float("nan")
        lags = pipe.publisher.lags
        print(f"service_cli: python -m opendlv_perception_vision_orbslam2_tpu_torch "
              f"--kittiPath=<{n} PNG pairs 1241x376> + deploy/docker-compose.yml's flags, "
              f"exit {rc} | keyframes {slam.n_keyframes} | map points "
              f"{int(slam.map.pt_valid.sum())} | lost at {[i for i, x in enumerate(lost) if x]} "
              f"| ms/frame from fps.txt over frames {span.start}-{span.stop - 1}: median "
              f"{np.median(ms[span]):.2f} worst {ms[span].max():.2f} (phase 12, same frames, a "
              f"sync each frame: median {np.median(ref_ms[span]):.2f} worst "
              f"{ref_ms[span].max():.2f}) | first frame {ms[0]:.1f} ms | publish lag in "
              f"frames: max {max(lags)}, mean "
              f"{np.mean(lags):.2f} | peak device memory {peak_gb:.3f} GB | ATE of poses.txt "
              f"{ate:.4f} m (align=True, bound {SERVICE_ATE_BOUND_M} m) | host syncs in track: "
              f"{sum(drive_sites.values())} ({drive_sites}), at the service layer's sites "
              f"{sum(service_syncs.values())}; {syncs.n} over the whole CLI run | "
              f"launches/frame {per_frame(launches, n)}", flush=True)
        if rc != 0:
            raise AssertionError(f"service CLI: exit code {rc}")
        if len(poses_txt) != n or any(len(r.split()) != 12 for r in poses_txt) or \
                not all(np.isfinite(T).all() for T in est):
            raise AssertionError(f"service CLI: poses.txt has {len(poses_txt)} rows, want {n} "
                                 "of 12 finite numbers")
        if (d / "map.txt").stat().st_size == 0 or len(fps_rows) != n:
            raise AssertionError(f"service CLI: map.txt empty or fps.txt has {len(fps_rows)} "
                                 f"lines, want {n}")
        if any(lost) or slam.lost or slam.n_keyframes < 5:
            raise AssertionError(f"service CLI: lost at {[i for i, x in enumerate(lost) if x]}"
                                 f" (at the end: {slam.lost}), {slam.n_keyframes} keyframes "
                                 "(need >= 5)")
        expected = {"fast_nms": 0, "fast_nms_pyramid": n, "gather_patches": n,
                    "gather_patches_multi": n}
        if launches != expected:
            raise AssertionError(f"service CLI: kernel launches {launches}, expected {expected}")
        if not ate < SERVICE_ATE_BOUND_M:
            raise AssertionError(f"service CLI: ATE {ate:.4f} m >= {SERVICE_ATE_BOUND_M} m")
        if service_syncs:
            raise AssertionError(f"service CLI: host syncs at the service layer's sites "
                                 f"{service_syncs}")
        if max(lags) > sel_mod.MAX_PUBLISH_LAG:
            raise AssertionError(f"service CLI: a message {max(lags)} frames late")

        # -- 19b. publishing: Selflocalization + KittiRunner, recorded ----------
        del made[:], lost[:]
        watch["post"] = True
        rec = _Session()
        scfg = config_from_flags([f"--kittiPath={d}"] + SERVICE_FLAGS)
        sel_mod.Selflocalization = Recording
        try:
            pipe = sel_mod.Selflocalization(scfg, od4=rec)
        finally:
            sel_mod.Selflocalization = inner_sel
        runner = kitti_mod.KittiRunner(str(d), pipe, publisher=rec)
        runner.run()
        pipe.shutdown()
        watch["post"] = False
        geo_at = [i for i, m in enumerate(rec.sent) if isinstance(m, Geolocation)]
        if len(geo_at) != n:
            raise AssertionError(f"publishing: {len(geo_at)} Geolocation messages, want {n}")
        ref = (scfg.ref_latitude, scfg.ref_longitude, scfg.start_heading)
        for i, (k, (T, _)) in enumerate(zip(geo_at, posted)):
            want = sel_mod.pose_to_geolocation(T.cpu().numpy(), *ref)
            if rec.sent[k].encode() != want.encode():
                raise AssertionError(f"publishing: frame {i}'s Geolocation {rec.sent[k]} is "
                                     f"not its logged pose's {want}")
        chunks = rec.sent[geo_at[19] + 1:geo_at[20]]
        T20, m20 = posted[19]
        pts = m20.pt_pos.cpu().numpy()[m20.pt_valid.cpu().numpy()]
        want = chunk_map_messages(T20.cpu().numpy(), pts.tolist())
        if [m.encode() for m in chunks] != [m.encode() for m in want] or \
                len(rec.sent) != n + len(chunks):
            raise AssertionError(f"publishing: {len(chunks)} OrbslamMap chunks at frame 20, "
                                 f"want {len(want)} for {len(pts)} points, and nothing else")
        for m in rec.sent:
            env = encode_envelope(m, sender_stamp=0, timestamp=1.0)
            if env[:2] != b"\x0d\xa4" or len(env) != 5 + int.from_bytes(env[2:5], "little"):
                raise AssertionError(f"publishing: envelope of {type(m).__name__} malformed")
        print(f"service_publish: Selflocalization(cfg, od4=<recording>) + KittiRunner over the "
              f"same directory, PNG decoder {runner.decoder} | {len(geo_at)} Geolocation, one a "
              f"frame in frame order, each "
              f"pose_to_geolocation of the frame's logged pose | {len(chunks)} OrbslamMap chunks "
              f"at frame 20 ({len(pts)} points, chunk_map_messages' contract) | "
              f"{len(rec.sent)} envelopes encode | publish lag max {max(pipe.publisher.lags)}",
              flush=True)

    # -- 19c. the live loop with rectification, frames handed in -------------
    lcfg = config_from_flags(SERVICE_FLAGS + SERVICE_LIVE_FLAGS)
    eye = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, width=lcfg.width // 2, height=lcfg.height))
    ll, lr, _, _ = synthetic.render_stereo_sequence(
        eye, **dict(SERVICE_DRIVE, n_frames=SERVICE_LIVE_FRAMES))
    frames = [(np.hstack([a, b]), i / cfg.camera.fps) for i, (a, b) in enumerate(zip(ll, lr))]
    maps, inner_loop, inner_session = [], cli.live_loop, od4_mod.OD4Session

    def recording_loop(pipeline, frames, raw_width, rect_maps=None, resize_to=None):
        maps.append(rect_maps)
        return inner_loop(pipeline, frames, raw_width, rect_maps, resize_to)

    del made[:], lost[:]
    cli.live_loop, od4_mod.OD4Session = recording_loop, _Session
    sel_mod.Selflocalization = Recording
    try:
        rc = cli.main(SERVICE_FLAGS + SERVICE_LIVE_FLAGS, frames=frames, ranks=1)
    finally:
        cli.live_loop, od4_mod.OD4Session = inner_loop, inner_session
        sel_mod.Selflocalization = inner_sel
    live_poses = [T.cpu().numpy() for T in made[0].slam.trajectory]
    grid_l, grid_r = maps[0]
    left = torch.from_numpy(frames[0][0][:, : lcfg.width // 2].copy())
    err = 0.0
    for grid in (grid_l, grid_r):
        on_card = undistort.remap_bilinear(left.to(dev), grid)
        on_cpu = undistort.remap_bilinear(left, grid.cpu())
        err = max(err, float((on_card.cpu() - on_cpu).abs().max()))
    print(f"service_live: {SERVICE_LIVE_FRAMES} side-by-side frames 2560x720 through the live "
          f"loop with --rectify=1 (rx/cv/rz 0.002/-0.001/0.0015, k1/k2 -0.02/0.005, p1/p2 "
          f"1e-4/-1e-4) on the card, exit {rc} | rectify maps {tuple(grid_l.shape)} on "
          f"{grid_l.device} | rectified camera fx {made[0].config.camera.fx:.3f} cx "
          f"{made[0].config.camera.cx:.3f} bf {made[0].config.camera.bf:.3f} | poses "
          f"{len(live_poses)}, keyframes {made[0].slam.n_keyframes} | remap_bilinear card vs "
          f"CPU on a 1280x720 frame: max abs err {err:.2e} (tol {SERVICE_REMAP_TOL}) | "
          f"{time.perf_counter() - t0:.1f} s (PNG writing {write_s:.1f} s)", flush=True)
    if rc != 0 or not live_poses or not all(np.isfinite(T).all() for T in live_poses):
        raise AssertionError(f"service live: exit {rc}, {len(live_poses)} poses, not all finite")
    if grid_l.device.type != "cuda" or not err <= SERVICE_REMAP_TOL:
        raise AssertionError(f"service live: maps on {grid_l.device}, remap card vs CPU {err}")
    return launches, ms


# Phase 20: multi-device SLAM over torch.distributed.  The card's machine has
# one H100 and NCCL refuses two ranks on one card, so the group is
# MULTI_WORLD processes on cuda:0 with gloo, which stages CUDA tensors
# through host memory (one host round trip a collective).
MULTI_WORLD = 2
MULTI_GROUP_TIMEOUT_S = 300      # a collective that waits longer raises
MULTI_JOIN_TIMEOUT_S = 420       # every rank must have exited 0 by then
# phase 16's bar for one GBA chunk on two devices (card vs CPU): the
# sharded chunk sums in other halves, and float32 CG on the closure map
# moves with the summation order by ~1e-4 (loop_gba_precision)
MULTI_CHUNK_TOL = 1e-3
# the merged keyframe poses (m and rad) after 10 sharded chunks and the
# merge against the single-device run, with the closure problem's edges in
# the map's order (every live edge in rank 0's block: read 0 on the card) and
# shuffled over both ranks.  Readings of the shuffled run: 2.9e-6 on
# tests/test_torch_parallel.py's 512x256 map on the CPU; on the card the
# carry after 10 chunks read 7.89e-5 m, 2.44e-6 rad in four calls (the
# float32 chunk on this map sits ~1e-4 from float64 in either summation
# order, loop_gba_precision); the bound is 2.5x the card's reading.
MULTI_MERGED_TOL = 2e-4
MULTI_POSE_TOL = 1e-4            # tests/test_torch_parallel.py's pose bar
MULTI_POSE_FRAME = 12            # the tracked frame whose solve part (b) repeats
MULTI_ENGINE_FRAMES = MULTI_POSE_FRAME + 1   # part (c)'s drive: phase 9's first frames
MULTI_SYNC_FRAMES = range(4, 8)  # frames whose host syncs are counted
# Phase 9 reports its ATE without a bound.  The engine's drive here is held
# to the bound the repo sets for KITTI-size drives of phase 9's world (phase
# 17's), on the ATE with align=True.  (Phase 19's 0.05 m, first taken, was
# set for the CLI from the JAX CLI's 0.0103 m, and failed here: 0.0516 m
# sharded against 0.0242 m alone, both deterministic.  The witnesses place
# the gap in the pose solve's rounding: the lone engine with a sync at each
# of the sharded path's collectives reads 0.0279 m, as without them, and
# with the two ranks' block sums in one process 0.0516 m, the sharded
# engine's poses exactly.  The parities below gate that.)
MULTI_ATE_BOUND_M = RGBD_ATE_BOUND_M
# Two parities of the engine's drive, each keyframes within 1 and the ATEs
# (align=True) within 5 mm: in the synchronous schedule
# (force_sync_decisions) sharded against alone (the card read 11 vs 11
# keyframes and 0.0232 vs 0.0233 m in four calls, poses up to 0.0147 apart
# at one entry; the CPU rehearsal at 512x256 parted 14 vs 15 keyframes at
# the pose solve's rounding), and in the default schedule sharded against
# the split witness, the lone engine whose pose solve sums two blocks as
# the ranks do (the card read 18 vs 18 keyframes, 0.0516 vs 0.0516 m, the
# same poses).  The lone engine's own ATE is 0.0242 m: the drive moves with
# the pose solve's float32 rounding by more than these bounds.
MULTI_PARITY_KF_GAP = 1
MULTI_PARITY_ATE_GAP_M = 0.005


def _timed_call(fn):
    """``(result, device ms by CUDA events, host ms)`` of ``fn()``."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b), 1e3 * (time.perf_counter() - t)


def _live_edges(prob, world: int):
    """The live edges of each rank's contiguous block of ``prob``'s edges."""
    import torch

    live = (prob.e_valid & prob.pt_valid[prob.e_pt.long()]).reshape(world, -1)
    return [int(x) for x in torch.sum(live, dim=1).cpu()]


class _ShuffledExtraction:
    """Within it, ``global_ba.extract_global_ba`` returns the problem with
    its edges permuted by ``perm``, so that ``IncrementalGBA``'s contiguous
    edge blocks give every rank live edges (the map's own order puts them
    all in rank 0's block)."""

    def __init__(self, perm):
        self.perm = perm

    def __enter__(self):
        from opendlv_perception_vision_orbslam2_tpu_torch.models import global_ba
        from opendlv_perception_vision_orbslam2_tpu_torch.parallel.sharded_ba import EDGE_FIELDS

        self.inner = inner = global_ba.extract_global_ba

        def shuffled(m, scale_factor):
            prob = inner(m, scale_factor)
            perm = self.perm.to(prob.e_kf.device)
            return prob._replace(**{f: getattr(prob, f)[perm] for f in EDGE_FIELDS})

        global_ba.extract_global_ba = shuffled

    def __exit__(self, *exc):
        from opendlv_perception_vision_orbslam2_tpu_torch.models import global_ba

        global_ba.extract_global_ba = self.inner


def _igba_merged(m, cfg, perm=None):
    """``IncrementalGBA(m, cfg)`` (sharded when a group is formed), its 10
    chunks and the merge (the edges shuffled by ``perm`` when given): the
    instance, every carry on the host, the merged keyframe poses."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import global_ba

    if perm is None:
        g = global_ba.IncrementalGBA(m, cfg)
    else:
        with _ShuffledExtraction(perm):
            g = global_ba.IncrementalGBA(m, cfg)
    carries, done = [], False
    while not done:
        done = g.step()
        carries.append(to_cpu(g.carry))
    return g, carries, g.merge(m).kf_T_cw.cpu()


def _in_blocks(world: int, run):
    """``run(rank, reduce)`` for every rank of ``world`` in one process, a
    thread each, where ``reduce(x)`` is the sum of every block's ``x`` in
    rank order (the bits ``collectives.all_reduce_sum`` gives ``world``
    ranks: for two blocks ``a + b``), with no collective and no sync.
    Returns rank 0's result."""
    import threading

    slots, outs, errors = [None] * world, [None] * world, []
    barrier = threading.Barrier(world, timeout=60)

    def block(rank):
        def reduce(x):
            slots[rank] = x
            barrier.wait()
            total = slots[0]
            for y in slots[1:]:
                total = total + y
            barrier.wait()
            return total

        try:
            outs[rank] = run(rank, reduce)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=block, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return outs[0]


def _split_solver(cam, world: int = MULTI_WORLD):
    """The sharded path's pose solve over ``world`` blocks in one process
    (``_in_blocks``): the solve a rank makes, each reduction the blocks'
    sum in rank order."""
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel.sharded_pose import (
        pad_obs_to_multiple, shard_obs, sharded_pose_solve,
    )

    c = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)

    def solve(T0, obs):
        k = obs.valid.shape[0]
        padded = pad_obs_to_multiple(obs, world)
        T, every, n = _in_blocks(world, lambda rank, reduce: sharded_pose_solve(
            T0, shard_obs(padded, rank, world), c, reduce, rank, world))
        return T, every[:k], n

    return solve


def split_gba(world: int = MULTI_WORLD):
    """``IncrementalGBA`` whose chunks sum ``world`` contiguous edge blocks
    in rank order in one process (``_in_blocks``), each block in the order
    of its own ``EdgeSums``: what the engine's GBA sharded over ``world``
    ranks computes (``parallel/serve.py``'s ``EngineGBA`` and
    ``ShardedGBA``), with no group."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import global_ba
    from opendlv_perception_vision_orbslam2_tpu_torch.optim.gba import (
        edge_sums, gba_core, gba_init_carry,
    )
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel.sharded_ba import (
        pad_edges_to_multiple, shard_problem,
    )

    class SplitGBA(global_ba.IncrementalGBA):
        def __init__(self, m, config, n_outer_total: int = 10, cg_iters: int = 40,
                     sharded=None):
            super().__init__(m, config, n_outer_total, cg_iters, sharded=False)
            self.prob = pad_edges_to_multiple(self.prob, world)
            self.shards = [shard_problem(self.prob, r, world) for r in range(world)]
            self.block_sums = [edge_sums(b) for b in self.shards]
            self.sums = None
            self.carry = gba_init_carry(self.prob)

        def step(self) -> bool:
            cam, carry = self.config.camera, self.carry
            self.carry = _in_blocks(world, lambda rank, reduce: gba_core(
                self.shards[rank], fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
                n_outer=1, cg_iters=self.cg_iters, fix_first_pose=True, init_carry=carry,
                return_carry=True, sums=self.block_sums[rank], reduce_fn=reduce))
            self.iters_left -= 1
            return self.iters_left <= 0

    return SplitGBA


class SplitWitness:
    """Within it, every ``StereoSlam`` made is the split witness of an
    engine on ``world`` ranks: no group, its local-map pose solve
    ``_split_solver`` and its post-loop GBA ``split_gba``, each summing
    ``world`` blocks in rank order as the ranks do.  Its trajectory is the
    bits the ranks' engine gives."""

    def __init__(self, cam, world: int = MULTI_WORLD):
        self.cam, self.world = cam, world

    def __enter__(self):
        from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod

        self.inner = slam_mod.IncrementalGBA, slam_mod.StereoSlam._sharded_pose_solver
        solver = _split_solver(self.cam, self.world)
        slam_mod.IncrementalGBA = split_gba(self.world)
        slam_mod.StereoSlam._sharded_pose_solver = lambda slam: solver
        return self

    def __exit__(self, *exc):
        from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod

        slam_mod.IncrementalGBA, slam_mod.StereoSlam._sharded_pose_solver = self.inner
        return False


def _multi_gba_runs(m, cfg, dev, perm):
    """Rank 0, part (a): the sharded IncrementalGBA on the closure map twice,
    then on the closure problem with its edges shuffled; each with the
    merge."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import global_ba
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import collectives

    runs = []
    for _ in range(2):
        collectives.reset_stats()
        g, _, init_ms = _timed_call(lambda: global_ba.IncrementalGBA(m, cfg))
        run = dict(init_ms=init_ms, init=dict(collectives.STATS), carries=[], ms=[], wall=[],
                   reduces=[], reduce_ms=[], live=_live_edges(g.prob, MULTI_WORLD),
                   n_edges=g.prob.e_kf.shape[0])
        if g._sharded is None:
            raise AssertionError("multi gba: IncrementalGBA did not take the sharded path")
        done = False
        while not done:
            collectives.reset_stats()
            done, ms, wall = _timed_call(g.step)
            run["ms"].append(ms)
            run["wall"].append(wall)
            run["reduces"].append(collectives.STATS["all_reduce"])
            run["reduce_ms"].append(1e3 * collectives.STATS["all_reduce_s"])
            run["carries"].append(to_cpu(g.carry))
        run["kf_T"] = g.merge(m).kf_T_cw.cpu()
        runs.append(run)
    g, carries, kf_T = _igba_merged(m, cfg, perm)
    if g._sharded is None:
        raise AssertionError("multi gba: the shuffled IncrementalGBA did not take the sharded "
                             "path")
    return runs, dict(live=_live_edges(g.prob, MULTI_WORLD), carries=carries, kf_T=kf_T)


def _engine_drive(dev, sync: bool, split: bool = False) -> dict:
    """``StereoSlam(cfg)`` with its defaults over phase 9's first
    ``MULTI_ENGINE_FRAMES`` frames (in the
    synchronous schedule with ``sync``): poses, keyframes, ATE.  With
    ``split``, the engine is the split witness of one on ``MULTI_WORLD``
    ranks (``SplitWitness``)."""
    import numpy as np

    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic, trajectory
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import SystemConfig

    cfg = SystemConfig()
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(cfg, n_frames=24, n_points=900,
                                                            seed=0, step=0.6)
    lefts, rights, gt = (a[:MULTI_ENGINE_FRAMES] for a in (lefts, rights, gt))
    with SplitWitness(cfg.camera) if split else contextlib.nullcontext():
        slam = slam_mod.StereoSlam(cfg, device=dev)
        slam.force_sync_decisions = sync
        lat = drive_slam(slam, lefts, rights, cfg.camera.fps)
        slam.finish()
    poses = [t.cpu().numpy() for t in slam.trajectory]
    return dict(P=np.stack(poses), n_kf=slam.n_keyframes, lat=lat,
                sharded=slam._pose_solver is not None,
                ate=trajectory.ate_rmse(poses, list(gt), align=True),
                ate_raw=trajectory.ate_rmse(poses, list(gt), align=False))


def _multi_engine(dev, work: Path, solo):
    """Rank 0: part (a), then the engine (c) while rank 1 serves, then the
    pose solve (b) on a frame of that drive."""
    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.optim.pose_opt import PoseObs, pose_optimize
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import collectives, serve
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel.sharded_pose import (
        make_sharded_pose_optimizer,
    )
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic, trajectory
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import SystemConfig

    cfg = SystemConfig()
    cam = cfg.camera
    out = {}
    # -- (a) the GBA on the closure problem ------------------------------------
    m = to_cpu(torch.load(work / "closure.pt", weights_only=False), dev)
    perm = torch.load(work / "perm.pt").to(dev)
    out["runs"], out["shuffled"] = _multi_gba_runs(m, cfg, dev, perm)
    del m
    # -- (c) the engine: StereoSlam(cfg) with its defaults ----------------------
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(cfg, n_frames=24, n_points=900,
                                                            seed=0, step=0.6)
    lefts, rights, gt = (a[:MULTI_ENGINE_FRAMES] for a in (lefts, rights, gt))
    slam = slam_mod.StereoSlam(cfg, device=dev)
    if not isinstance(slam._pose_solver, serve.EnginePoseSolver):
        raise AssertionError("multi engine: StereoSlam on rank 0 did not take the sharded "
                             "pose solve")
    inner, frame, kept = slam._pose_solver, [0], {}

    def keep(T, obs):
        if frame[0] == MULTI_POSE_FRAME:
            kept.update(T=T.clone(), obs=PoseObs(*(x.clone() for x in obs)))
        return inner(T, obs)

    slam._pose_solver = keep
    counter = _SyncCounter()
    reset_launches()
    collectives.reset_stats()
    lat = []
    for i in range(lefts.shape[0]):
        frame[0] = i
        if i in MULTI_SYNC_FRAMES:
            with counter:
                lat += drive_slam(slam, lefts[i:i + 1], rights[i:i + 1], cam.fps, start=i)
        else:
            lat += drive_slam(slam, lefts[i:i + 1], rights[i:i + 1], cam.fps, start=i)
    out["launches"] = read_launches()
    out["collectives"] = dict(collectives.STATS)
    slam.finish()
    poses = [t.cpu().numpy() for t in slam.trajectory]
    out.update(lat=lat, lost=bool(slam.lost), n_kf=slam.n_keyframes, P=np.stack(poses),
               n_pt=int(slam.map.pt_valid.sum()), syncs=dict(counter.sites),
               n_sync_frames=len(MULTI_SYNC_FRAMES),
               ate=trajectory.ate_rmse(poses, list(gt), align=True),
               ate_raw=trajectory.ate_rmse(poses, list(gt), align=False))
    # the same drive in the synchronous schedule, for the parity with one device
    out["sync"] = _engine_drive(dev, sync=True)
    # -- (b) that frame's local-map pose solve at full width --------------------
    T1, obs = kept["T"], kept["obs"]
    two, two_ms, two_wall = _timed_call(lambda: inner(T1, obs))
    one_solver = make_sharded_pose_optimizer(solo, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                                             bf=cam.bf)
    one, one_ms, one_wall = _timed_call(lambda: one_solver(T1, obs))
    _, alone_ms, alone_wall = _timed_call(lambda: pose_optimize(
        T1, obs, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf))
    split = _split_solver(cam)(T1, obs)
    out["pose"] = dict(n_obs=int(obs.valid.shape[0]), n_valid=int(obs.valid.sum()),
                       two=to_cpu(two), one=to_cpu(one), two_ms=two_ms, two_wall=two_wall,
                       split=to_cpu(split), one_ms=one_ms, one_wall=one_wall,
                       alone_ms=alone_ms,
                       alone_wall=alone_wall)
    serve.stop_workers()
    return out


def _multi_serve(dev):
    """Rank 1: serve rank 0's solves; keep every GBA carry and pose result,
    and each served GBA chunk's device ms (CUDA events)."""
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import serve

    steps, poses, ms = [], [], []
    step = serve.ShardedGBA.step

    def timed_step(self):
        carry, t, _ = _timed_call(lambda: step(self))
        ms.append(t)
        return carry

    def keep(op, result):
        if op == "gba_step":
            steps.append(to_cpu(result))
        elif op == "pose":
            poses.append(to_cpu(result))

    serve.ShardedGBA.step = timed_step
    reset_launches()
    served = serve.serve(dev, on_result=keep)
    torch.cuda.synchronize()
    return dict(served=served, steps=steps, poses=poses, step_ms=ms, launches=read_launches())


def multi_rank(rank: int, world: int, work: str):
    """One rank of phase 20 (a spawned process): forms the gloo group through
    a file in ``work``, runs its side, saves its results there."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world, timeout=timedelta(seconds=MULTI_GROUP_TIMEOUT_S))
    solo = dist.new_group([0])          # the one-rank group of part (b)
    out = _multi_engine(dev, Path(work), solo) if rank == 0 else _multi_serve(dev)
    torch.save(out, Path(work) / f"rank{rank}.pt")
    dist.destroy_process_group()


def _bit_equal(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def multi_rank_phase(cfg, dev, work: Path, closure_path: Path, slam_ms: float):
    """Phase 20: the sharded GBA (a), the sharded pose solve (b) and the
    engine (c) on MULTI_WORLD gloo ranks on ``cuda:0``, against the
    single-device solves in this process.  ``slam_ms`` is phase 9's ms/frame.
    Returns rank 0's launch counts of part (c)."""
    import multiprocessing

    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.models import global_ba

    t0 = time.perf_counter()
    # the single-device solves, here (no process group)
    m = to_cpu(torch.load(closure_path, weights_only=False), dev)
    _, single, single_kf_T = _igba_merged(m, cfg)
    kf_valid = m.kf_valid.cpu().numpy()
    n_edges = global_ba.extract_global_ba(m, cfg.orb.scale_factor).e_kf.shape[0]
    perm = torch.randperm(n_edges, generator=torch.Generator().manual_seed(0))
    torch.save(perm, work / "perm.pt")
    _, single_shuffled, single_shuffled_kf_T = _igba_merged(m, cfg, perm)
    del m
    # the engine alone in the synchronous schedule, and the split witness of
    # the engine on the ranks (the ranks' engine on the loop circuit: phase 22)
    one = _engine_drive(dev, True)
    split = _engine_drive(dev, False, split=True)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0

    # the ranks
    t1 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")       # the parent holds a CUDA context
    procs = [ctx.Process(target=multi_rank, args=(r, MULTI_WORLD, str(work)))
             for r in range(MULTI_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MULTI_JOIN_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break                      # a rank failed: the others are ended below
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    ranks_s = time.perf_counter() - t1
    if codes != [0] * MULTI_WORLD:
        raise AssertionError(f"multi: rank exit codes {codes} (0 each within "
                             f"{MULTI_JOIN_TIMEOUT_S} s wanted)")
    r0, r1 = (torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(MULTI_WORLD))

    # (a) the GBA
    run, again, sh = r0["runs"][0], r0["runs"][1], r0["shuffled"]
    dt, dr = _pose_gap(run["carries"][0][0], single[0][0], kf_valid)
    cost, cost_1 = float(run["carries"][0][3]), float(single[0][3])
    dt_m, dr_m = _pose_gap(run["kf_T"], single_kf_T, kf_valid)
    dt_s, dr_s = _pose_gap(sh["carries"][0][0], single_shuffled[0][0], kf_valid)
    dt_s10, dr_s10 = _pose_gap(sh["kf_T"], single_shuffled_kf_T, kf_valid)
    cost_s, cost_s1 = float(sh["carries"][0][3]), float(single_shuffled[0][3])
    mine = run["carries"] + again["carries"] + sh["carries"]
    n_chunks = len(run["ms"])
    ranks_equal = len(r1["steps"]) == len(mine) and all(
        _bit_equal(a, b) for a, b in zip(mine, r1["steps"]))
    repeat_equal = all(_bit_equal(a, b) for a, b in zip(run["carries"], again["carries"])) \
        and torch.equal(run["kf_T"], again["kf_T"])
    med = lambda v: float(np.median(v))  # noqa: E731
    print(f"multi_gba: {MULTI_WORLD} gloo ranks on cuda:0, IncrementalGBA(m, cfg) on phase 16's "
          f"closure map ({run['n_edges']} edges, live a rank {run['live']}), {n_chunks} chunks | "
          f"first chunk vs single-device: poses {dt:.3g} m, {dr:.3g} rad, cost {cost:.6g} vs "
          f"{cost_1:.6g} (relative {abs(cost - cost_1) / abs(cost_1):.3g}; bounds "
          f"{MULTI_CHUNK_TOL:g}) | merged keyframe poses vs single-device {dt_m:.3g} m, "
          f"{dr_m:.3g} rad (bound {MULTI_MERGED_TOL:g}) | ranks' carries after every chunk "
          f"{'bit-equal' if ranks_equal else 'DIFFER'} | repeated run "
          f"{'bit-equal' if repeat_equal else 'DIFFERS'} | device ms a chunk (CUDA events) "
          f"median rank 0 {med(run['ms']):.2f}, rank 1 {med(r1['step_ms'][:n_chunks]):.2f} | "
          f"wall ms a chunk rank 0 median {med(run['wall']):.2f} | all-reduces a chunk "
          f"{run['reduces'][0]}, their host ms median {med(run['reduce_ms']):.2f} | problem "
          f"broadcast: {run['init']['broadcast']} broadcasts {1e3 * run['init']['broadcast_s']:.2f} "
          f"ms, IncrementalGBA() {run['init_ms']:.2f} ms", flush=True)
    print(f"multi_gba_shuffled: the closure problem's edges shuffled (live a rank "
          f"{sh['live']}), IncrementalGBA(m, cfg), {len(sh['carries'])} chunks and the merge | "
          f"first chunk vs single-device: poses {dt_s:.3g} m, {dr_s:.3g} rad, cost relative "
          f"{abs(cost_s - cost_s1) / abs(cost_s1):.3g} (bounds {MULTI_CHUNK_TOL:g}) | merged "
          f"keyframe poses vs single-device {dt_s10:.3g} m, {dr_s10:.3g} rad (bound "
          f"{MULTI_MERGED_TOL:g}) | rank 1 device ms a chunk median "
          f"{med(r1['step_ms'][-len(sh['carries']):]):.2f}", flush=True)
    if not (dt < MULTI_CHUNK_TOL and dr < MULTI_CHUNK_TOL
            and abs(cost - cost_1) < MULTI_CHUNK_TOL * abs(cost_1)):
        raise AssertionError("multi gba: the first sharded chunk differs from the single-device")
    if not (dt_m < MULTI_MERGED_TOL and dr_m < MULTI_MERGED_TOL):
        raise AssertionError("multi gba: the merged map differs from the single-device one")
    if not (dt_s < MULTI_CHUNK_TOL and dr_s < MULTI_CHUNK_TOL
            and abs(cost_s - cost_s1) < MULTI_CHUNK_TOL * abs(cost_s1)):
        raise AssertionError("multi gba: the shuffled problem's first chunk differs")
    if not (min(sh["live"]) > 0 and dt_s10 < MULTI_MERGED_TOL and dr_s10 < MULTI_MERGED_TOL):
        raise AssertionError("multi gba: the shuffled problem's merged map differs from the "
                             "single-device one (or a rank holds no live edge)")
    if not ranks_equal:
        raise AssertionError("multi gba: the ranks' carries differ")
    if not repeat_equal:
        raise AssertionError("multi gba: the repeated sharded run differs")

    # (b) the pose solve
    ps = r0["pose"]
    (T2, inl2, n2), (T1, inl1, n1) = ps["two"], ps["one"]
    d_T = float((T2 - T1).abs().max())
    same_inl = torch.equal(inl2, inl1) and int(n2) == int(n1)
    rank1_T = r1["poses"][-1][0]
    print(f"multi_pose: the local-map pose solve of frame {MULTI_POSE_FRAME}, {ps['n_obs']} "
          f"observations ({ps['n_valid']} valid) | 2 ranks vs one-rank group: T max diff "
          f"{d_T:.3g} (bound {MULTI_POSE_TOL:g}), inliers {'identical' if same_inl else 'DIFFER'} "
          f"({int(n2)} vs {int(n1)}), ranks' T {'bit-equal' if torch.equal(T2, rank1_T) else 'DIFFER'}"
          f" | device ms (CUDA events) 2 ranks {ps['two_ms']:.2f}, one-rank group "
          f"{ps['one_ms']:.2f}, pose_optimize (no group, no collective) {ps['alone_ms']:.2f}; "
          f"wall ms {ps['two_wall']:.2f}, {ps['one_wall']:.2f}, {ps['alone_wall']:.2f} | "
          f"the two blocks summed in one process (the split witness) vs 2 ranks: "
          f"{'bit-equal' if _bit_equal(ps['split'], ps['two']) else 'DIFFER'}", flush=True)
    if not (d_T < MULTI_POSE_TOL and same_inl and torch.equal(T2, rank1_T)):
        raise AssertionError("multi pose: the sharded pose solve differs")

    # (c) the engine
    lat = r0["lat"]
    n_frames = len(lat)
    expected = {"fast_nms": 0, "fast_nms_pyramid": n_frames, "gather_patches": n_frames,
                "gather_patches_multi": n_frames}
    coll = r0["collectives"]
    ms_frame = 1e3 * float(np.mean(lat[1:]))
    n_sync = sum(r0["syncs"].values())
    print(f"multi_engine: StereoSlam(cfg) defaults on rank 0 over phase 9's {n_frames} frames, "
          f"rank 1 serving | {ms_frame:.2f} ms/frame over frames 1-{n_frames - 1} (phase 9, 1 "
          f"process, over its last 16: "
          f"{slam_ms:.2f}) | lost {r0['lost']} | keyframes {r0['n_kf']} | map points "
          f"{r0['n_pt']} | ATE {r0['ate']:.4f} m (align=True, bound {MULTI_ATE_BOUND_M:g}; "
          f"align=False {r0['ate_raw']:.4f}) | "
          f"collectives a frame: all-reduce {coll['all_reduce'] / n_frames:.2f} "
          f"({1e3 * coll['all_reduce_s'] / n_frames:.2f} host ms), broadcast "
          f"{coll['broadcast'] / n_frames:.2f} ({1e3 * coll['broadcast_s'] / n_frames:.2f} host "
          f"ms) | launches/frame rank 0 {per_frame(r0['launches'], n_frames)}; rank 1 "
          f"{r1['launches']} | ops served by rank 1 {r1['served']} | host syncs a frame "
          f"(frames {MULTI_SYNC_FRAMES.start}-{MULTI_SYNC_FRAMES.stop - 1}) "
          f"{n_sync / r0['n_sync_frames']:.1f}: "
          + ", ".join(f"{k} {v / r0['n_sync_frames']:g}"
                      for k, v in sorted(r0["syncs"].items(), key=lambda kv: -kv[1])),
          flush=True)
    sync = r0["sync"]
    ms = lambda d: 1e3 * float(np.mean(d["lat"][1:]))  # noqa: E731
    kf_gap, ate_gap = abs(sync["n_kf"] - one["n_kf"]), abs(sync["ate"] - one["ate"])
    split_gap = float(np.abs(split["P"] - r0["P"]).max())
    print(f"multi_engine_schedules: split witness, alone with the pose solve summing two "
          f"blocks as the ranks do (no collective, no sync): ATE {split['ate']:.4f} m (bound "
          f"{MULTI_PARITY_ATE_GAP_M:g} from the sharded engine's), {split['n_kf']} keyframes, "
          f"poses vs the sharded engine's max entry gap {split_gap:.3g}, {ms(split):.2f} "
          f"ms/frame | synchronous schedule, sharded vs alone: keyframes {sync['n_kf']} vs "
          f"{one['n_kf']} (bound {MULTI_PARITY_KF_GAP} apart), ATE {sync['ate']:.4f} vs "
          f"{one['ate']:.4f} m (bound {MULTI_PARITY_ATE_GAP_M:g} apart), max pose entry gap "
          f"{float(np.abs(sync['P'] - one['P']).max()):.3g}, ms/frame {ms(sync):.2f} vs "
          f"{ms(one):.2f}", flush=True)
    if not sync["sharded"] or one["sharded"]:
        raise AssertionError("multi engine: the synchronous drives did not run as labelled")
    if not (kf_gap <= MULTI_PARITY_KF_GAP and ate_gap < MULTI_PARITY_ATE_GAP_M):
        raise AssertionError(f"multi engine: in the synchronous schedule sharded and alone "
                             f"part by {kf_gap} keyframes and {ate_gap:.4f} m of ATE")
    if not (abs(r0["n_kf"] - split["n_kf"]) <= MULTI_PARITY_KF_GAP
            and abs(r0["ate"] - split["ate"]) < MULTI_PARITY_ATE_GAP_M):
        raise AssertionError(f"multi engine: sharded ({r0['n_kf']} keyframes, ATE "
                             f"{r0['ate']:.4f} m) and the split witness ({split['n_kf']}, "
                             f"{split['ate']:.4f} m) part")
    if r0["lost"] or r0["n_kf"] < 5:
        raise AssertionError(f"multi engine: lost {r0['lost']}, {r0['n_kf']} keyframes (>= 5)")
    if not r0["ate"] < MULTI_ATE_BOUND_M:
        raise AssertionError(f"multi engine: ATE {r0['ate']:.4f} m >= {MULTI_ATE_BOUND_M} m")
    if r0["launches"] != expected or any(r1["launches"].values()):
        raise AssertionError(f"multi engine: launches rank 0 {r0['launches']} (expected "
                             f"{expected}), rank 1 {r1['launches']} (expected none)")
    print(f"multi_phase_seconds: single-device references {ref_s:.1f} | ranks (spawn to exit) "
          f"{ranks_s:.1f}", flush=True)
    return r0["launches"]


# Phase 21: the service CLI on every visible card.  main(argv, ranks=D) with
# D = max(2, cards): gloo ranks on a host with one card (NCCL
# refuses two ranks on one card), NCCL one rank a card on a host with
# several.  The gates reuse phase 19's and phase 20's: the same frames,
# flags and dumps, the engine's ATE bound for this world, and the parity
# with the lone CLI whose pose solve sums D blocks as the ranks do.
SERVICE_MULTI_CID = 121
SERVICE_MULTI_DEADLINE_S = 240   # main, its ranks' start and teardown included
SERVICE_MULTI_CLI_TIMEOUT_S = 300  # the user's command as a subprocess


class _CollectiveTimes:
    """Within it, every collective of the sharded solves on rank 0
    (``collectives.all_reduce_sum`` and ``serve.broadcast``) is bracketed by
    CUDA events on the engine's stream: ``ms()`` sums their device time
    by kind.  Under NCCL the host's ``STATS`` seconds are the enqueue only;
    these are the collective's time as the engine's stream sees it."""

    def __enter__(self):
        import torch

        from opendlv_perception_vision_orbslam2_tpu_torch.parallel import collectives, serve

        self.events = {"all_reduce": [], "broadcast": []}
        self.inner = (collectives.all_reduce_sum, serve.broadcast)

        def timed(fn, kind):
            def run(x, *args):
                if not x.is_cuda:
                    return fn(x, *args)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(x, *args)
                b.record()
                self.events[kind].append((a, b))
                return out
            return run

        collectives.all_reduce_sum = timed(self.inner[0], "all_reduce")
        serve.broadcast = timed(self.inner[1], "broadcast")
        return self

    def __exit__(self, *exc):
        from opendlv_perception_vision_orbslam2_tpu_torch.parallel import collectives, serve

        collectives.all_reduce_sum, serve.broadcast = self.inner

    def ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.events.items()}


def _dumps_complete(d: Path, n: int):
    """poses.txt's poses if the run left ``n`` rows of 12 finite numbers,
    a map.txt with points and ``n`` fps.txt lines in ``d``, else None."""
    import numpy as np

    path = d / "poses.txt"
    poses = path.read_text().strip().splitlines() if path.exists() else []
    if len(poses) != n or any(len(r.split()) != 12 for r in poses):
        return None
    est = read_kitti_poses(d / "poses.txt")
    fps = (d / "fps.txt").read_text().strip().splitlines()
    if not all(np.isfinite(T).all() for T in est) or (d / "map.txt").stat().st_size == 0 \
            or len(fps) != n:
        return None
    return est


def service_multi_phase(cfg, dev, service_ms):
    """Phase 21: the CLI on D = max(2, cards) ranks in process (rank 0 here,
    D - 1 spawned by ``parallel/launch.py``) over phase 19's directory, the
    lone CLI whose pose solve sums D blocks as the ranks do, and on a host
    with several cards the user's command as a subprocess.  ``service_ms``
    is phase 19's ms a frame from fps.txt.  Returns rank 0's launch counts."""
    import os

    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as cli
    from opendlv_perception_vision_orbslam2_tpu_torch.io import od4 as od4_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.io.messages import Geolocation
    from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as sel_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import collectives, launch, serve
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic, trajectory
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import config_from_flags

    t0 = time.perf_counter()
    gc.collect()
    n_cards = torch.cuda.device_count()
    world = max(2, n_cards)
    backend = launch.NCCL if n_cards >= world else launch.GLOO
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(cfg, **SERVICE_DRIVE)
    n = lefts.shape[0]
    inner_sel, inner_ranks, inner_session = (sel_mod.Selflocalization, launch.LocalRanks,
                                             od4_mod.OD4Session)
    made, ranks_made, sessions, lost, posted = [], [], [], [], []
    watch = {"syncs": None}

    class Recording(inner_sel):
        """Keeps the pipeline and each frame's lost flag and logged pose;
        counts the host syncs inside ``track`` in ``watch["syncs"]`` over
        frames ``MULTI_SYNC_FRAMES`` (the sync debug mode also warns at each
        of gloo's staging copies, in gloo's threads, which slows every frame
        it is on)."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def track(self, *args, **kwargs):
            if watch["syncs"] is not None and self.frame_count in MULTI_SYNC_FRAMES:
                with watch["syncs"]:
                    T = super().track(*args, **kwargs)
            else:
                T = super().track(*args, **kwargs)
            lost.append(self.slam.lost)
            posted.append(self.slam.trajectory[-1])
            return T

    class Kept(inner_ranks):
        def __init__(self, plan):
            super().__init__(plan)
            ranks_made.append(self)

    def session(*args, **kwargs):
        sessions.append(_Session())
        return sessions[-1]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp:
        base = Path(tmp) / "kitti"
        write_kitti_dir(base, lefts, rights, cfg.camera.fps)
        dirs = {k: Path(tmp) / k for k in ("ranks", "witness", "cli")}
        for d in dirs.values():
            shutil.copytree(base, d)

        # -- 21a. main on D ranks, in process ----------------------------------
        argv = [f"--kittiPath={dirs['ranks']}", f"--cid={SERVICE_MULTI_CID}"] + SERVICE_FLAGS
        sel_mod.Selflocalization, launch.LocalRanks = Recording, Kept
        od4_mod.OD4Session = session
        try:
            reset_launches()
            collectives.reset_stats()
            t1 = time.perf_counter()
            syncs = watch["syncs"] = _SyncCounter()
            with _CollectiveTimes() as coll:
                rc = cli.main(argv, ranks=world)
            wall_s = time.perf_counter() - t1
            watch["syncs"] = None
            launches = read_launches()
            stats = dict(collectives.STATS)
            coll_ms = coll.ms()
        finally:
            sel_mod.Selflocalization, launch.LocalRanks = inner_sel, inner_ranks
            od4_mod.OD4Session = inner_session
        ranks = ranks_made[0]
        slam = made[0].slam
        est = _dumps_complete(dirs["ranks"], n)
        ate = trajectory.ate_rmse(est, list(gt)) if est is not None else float("nan")
        fps_rows = [ln.split() for ln in (dirs["ranks"] / "fps.txt").read_text().split("\n")
                    if ln.strip()]
        ms = np.array([1e3 / float(f) for f, _ in fps_rows])
        span = slice(1, n)
        service_sites = {k: v for k, v in syncs.sites.items()
                         if k.split(":")[0] in SERVICE_FILES}
        worker_launches = {r: rep["launches"] for r, rep in ranks.reports.items()}
        served = {r: rep["served"] for r, rep in ranks.reports.items()}
        scfg = config_from_flags(argv)
        ref = (scfg.ref_latitude, scfg.ref_longitude, scfg.start_heading)
        geo = [m for m in sessions[0].sent if isinstance(m, Geolocation)]
        want = [sel_mod.pose_to_geolocation(T.cpu().numpy(), *ref).encode() for T in posted]
        print(f"service_multi: main(python -m ... --kittiPath=<{n} PNG pairs 1241x376> + "
              f"deploy flags, ranks={world}) on {n_cards} card(s): {launch.describe(ranks.plan)}"
              f" | exit {rc}, worker exit codes {ranks.exit_codes}, {wall_s:.1f} s from the call "
              f"to the last rank's exit (deadline {SERVICE_MULTI_DEADLINE_S} s) | keyframes "
              f"{slam.n_keyframes} | map points {int(slam.map.pt_valid.sum())} | lost at "
              f"{[i for i, x in enumerate(lost) if x]} | ATE of poses.txt {ate:.4f} m (align=True,"
              f" bound {MULTI_ATE_BOUND_M:g}) | ms/frame from fps.txt over frames 1-{n - 1}: "
              f"median {np.median(ms[span]):.2f} worst {ms[span].max():.2f} at frame "
              f"{int(np.argmax(ms[span])) + 1}, frames 0-3 {np.round(ms[:4], 1).tolist()} "
              f"(phase 19, one process: median {np.median(service_ms[span]):.2f} worst "
              f"{service_ms[span].max():.2f} at frame {int(np.argmax(service_ms[span])) + 1}, "
              f"frames 0-3 {np.round(service_ms[:4], 1).tolist()}) | collectives a frame on "
              f"rank 0: all-reduce "
              f"{stats['all_reduce'] / n:.2f}, device {coll_ms['all_reduce'] / n:.2f} ms (CUDA "
              f"events), host {1e3 * stats['all_reduce_s'] / n:.2f} ms; broadcast "
              f"{stats['broadcast'] / n:.2f}, device {coll_ms['broadcast'] / n:.2f} ms, host "
              f"{1e3 * stats['broadcast_s'] / n:.2f} ms | ops served by the workers {served} | "
              f"Geolocations {len(geo)} | host syncs in track over frames "
              f"{MULTI_SYNC_FRAMES.start}-{MULTI_SYNC_FRAMES.stop - 1}: {syncs.sites}, at the "
              f"service sites {sum(service_sites.values())} | launches/frame rank 0 "
              f"{per_frame(launches, n)};"
              f" workers {worker_launches}", flush=True)
        if rc != 0 or ranks.exit_codes != [0] * (world - 1) or \
                not wall_s < SERVICE_MULTI_DEADLINE_S:
            raise AssertionError(f"service multi: exit {rc}, worker exit codes "
                                 f"{ranks.exit_codes}, {wall_s:.1f} s")
        if ranks.plan.world != world or ranks.plan.backend != backend:
            raise AssertionError(f"service multi: formed {launch.describe(ranks.plan)}, want "
                                 f"{world} ranks over {backend}")
        if not isinstance(slam._pose_solver, serve.EnginePoseSolver):
            raise AssertionError("service multi: the engine did not take the sharded pose solve")
        if est is None:
            raise AssertionError("service multi: poses.txt, map.txt or fps.txt incomplete")
        if any(lost) or slam.lost or slam.n_keyframes < 5:
            raise AssertionError(f"service multi: lost at {[i for i, x in enumerate(lost) if x]}"
                                 f", {slam.n_keyframes} keyframes (need >= 5)")
        if not ate < MULTI_ATE_BOUND_M:
            raise AssertionError(f"service multi: ATE {ate:.4f} m >= {MULTI_ATE_BOUND_M} m")
        if [m.encode() for m in geo] != want or len(geo) != n:
            raise AssertionError(f"service multi: {len(geo)} Geolocations, not one a frame "
                                 "equal to its logged pose's")
        if service_sites:
            raise AssertionError(f"service multi: host syncs at the service sites "
                                 f"{service_sites}")
        expected = {"fast_nms": 0, "fast_nms_pyramid": n, "gather_patches": n,
                    "gather_patches_multi": n}
        if launches != expected or len(worker_launches) != world - 1 or \
                any(any(v.values()) for v in worker_launches.values()):
            raise AssertionError(f"service multi: launches rank 0 {launches} (expected "
                                 f"{expected}), workers {worker_launches} (expected none)")
        if not stats["all_reduce"] > 0:
            raise AssertionError("service multi: rank 0 made no collective")

        # -- 21b. the lone CLI whose pose solve sums D blocks ------------------
        del made[:], lost[:], posted[:]
        sel_mod.Selflocalization = Recording
        try:
            with SplitWitness(cfg.camera, world):
                rc_w = cli.main([f"--kittiPath={dirs['witness']}"] + SERVICE_FLAGS, ranks=1)
        finally:
            sel_mod.Selflocalization = inner_sel
        wslam = made[0].slam
        w_est = _dumps_complete(dirs["witness"], n)
        w_ate = trajectory.ate_rmse(w_est, list(gt)) if w_est is not None else float("nan")
        gap = float(np.abs(np.stack(w_est) - np.stack(est)).max()) if w_est is not None \
            else float("nan")
        print(f"service_multi_witness: the lone CLI (no group) whose pose solve sums {world} "
              f"blocks as the ranks do (_split_solver) | exit {rc_w} | keyframes "
              f"{wslam.n_keyframes} vs {slam.n_keyframes} on {world} ranks (bound "
              f"{MULTI_PARITY_KF_GAP} apart) | ATE {w_ate:.4f} vs {ate:.4f} m (bound "
              f"{MULTI_PARITY_ATE_GAP_M:g} apart) | poses.txt max entry gap {gap:.3g}",
              flush=True)
        if rc_w != 0 or w_est is None:
            raise AssertionError(f"service multi witness: exit {rc_w}, dumps incomplete")
        if not (abs(wslam.n_keyframes - slam.n_keyframes) <= MULTI_PARITY_KF_GAP
                and abs(w_ate - ate) < MULTI_PARITY_ATE_GAP_M):
            raise AssertionError(f"service multi: {world} ranks ({slam.n_keyframes} keyframes, "
                                 f"ATE {ate:.4f} m) and the split witness "
                                 f"({wslam.n_keyframes}, {w_ate:.4f} m) part")

        # -- 21c. the user's command on every card -----------------------------
        if n_cards < 2:
            print(f"service_multi_nccl: not run: {n_cards} card visible; NCCL takes one rank a "
                  "card, so `python -m opendlv_perception_vision_orbslam2_tpu_torch` forms no "
                  "group on this host (phase 19 ran it alone)", flush=True)
        else:
            repo = Path(__file__).resolve().parent
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(repo), os.environ.get("PYTHONPATH", "")]))
            t1 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "opendlv_perception_vision_orbslam2_tpu_torch",
                 f"--kittiPath={dirs['cli']}"] + SERVICE_FLAGS, cwd=repo, env=env,
                capture_output=True, text=True, timeout=SERVICE_MULTI_CLI_TIMEOUT_S)
            cli_s = time.perf_counter() - t1
            formed = [ln for ln in run.stdout.splitlines() if " ranks (" in ln]
            c_est = _dumps_complete(dirs["cli"], n)
            c_ate = trajectory.ate_rmse(c_est, list(gt)) if c_est is not None else float("nan")
            want_line = (f"opendlv_perception_vision_orbslam2_tpu_torch: {n_cards} ranks "
                         f"({launch.NCCL})")
            print(f"service_multi_nccl: python -m opendlv_perception_vision_orbslam2_tpu_torch "
                  f"--kittiPath=<{n} PNG pairs> + deploy flags as a subprocess on {n_cards} cards"
                  f" | exit {run.returncode} in {cli_s:.1f} s | formed: {formed} | ATE "
                  f"{c_ate:.4f} m | {run.stdout.strip().splitlines()[-1:]}", flush=True)
            if run.returncode != 0 or not any(ln.startswith(want_line) for ln in formed) or \
                    c_est is None or not c_ate < MULTI_ATE_BOUND_M:
                raise AssertionError(f"service multi CLI: exit {run.returncode}, formed "
                                     f"{formed}, ATE {c_ate}; stderr tail "
                                     f"{run.stderr[-2000:]}")
    print(f"service_multi_phase_seconds: phase 21 {time.perf_counter() - t0:.1f}", flush=True)
    return launches


# Phase 22: a loop closure on every card.  The CLI on D = max(2, cards) ranks
# (phase 21's call) over phase 15's circuit written as PNG pairs: the first
# loop closure starts the engine's GBA, sharded over the ranks, and the
# workers serve its chunks between rank 0's frames.  The gates are phase 15's
# on the CLI's poses.txt, and the bits of the split witness.
LOOP_MULTI_CID = 122
LOOP_MULTI_DEADLINE_S = 900      # main, its ranks' start and teardown included


class _LoopRecorder:
    """Within it, rank 0's engine is watched: each frame's lost flag and
    capacity, each verification (the frame it was dispatched at, its
    keyframe pair, its inliers and verdict), and each GBA the engine starts:
    whether it is sharded, its problem's broadcast (bytes, device ms), its
    live edges a rank, and each chunk (the frame, device ms by CUDA events,
    the collectives' calls, host ms and device ms) and the merge's frame;
    for ``replay_gbas``, the map it started from, its config, its carry
    after each chunk, and the map it merged into with the merged poses.
    ``coll`` is the ``_CollectiveTimes`` around the run."""

    def __init__(self, world: int, coll):
        self.world, self.coll = world, coll
        self.frame = 0
        self.bytes = 0                 # broadcast since the last GBA began
        self.lost, self.capacity, self.verifies, self.gbas = [], [], [], []

    def __enter__(self):
        import torch

        from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing
        from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
        from opendlv_perception_vision_orbslam2_tpu_torch.parallel import collectives, serve

        rec = self
        self.inner = (slam_mod.IncrementalGBA, loop_closing.compute_loop_transform,
                      slam_mod.StereoSlam._dispatch_verify, serve.broadcast)
        inner_gba, inner_clt, inner_verify, inner_bcast = self.inner

        def marks():
            return {k: len(v) for k, v in rec.coll.events.items()}, dict(collectives.STATS)

        def spent(before):
            n0, s0 = before
            ms = {k: sum(a.elapsed_time(b) for a, b in v[n0[k]:]) for k, v in
                  rec.coll.events.items()}
            return dict(calls={k: collectives.STATS[k] - s0[k] for k in ("all_reduce",
                                                                         "broadcast")},
                        host_ms={k: 1e3 * (collectives.STATS[k + "_s"] - s0[k + "_s"])
                                 for k in ("all_reduce", "broadcast")},
                        device_ms=ms)

        class WatchedGBA(inner_gba):
            def __init__(self, m, config, *args, **kwargs):
                before = marks()
                rec.bytes = 0
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                super().__init__(m, config, *args, **kwargs)
                b.record()
                b.synchronize()
                self.rec = dict(frame=rec.frame, sharded=getattr(self, "_sharded", None) is not None,
                                init_ms=a.elapsed_time(b), init=spent(before),
                                problem_bytes=rec.bytes, live=_live_edges(self.prob, rec.world),
                                n_edges=int(self.prob.e_kf.shape[0]),
                                K=int(m.kf_capacity), chunks=[], merged=None,
                                map=m, config=config, carries=[], merge_in=None, merge_T=None)
                rec.gbas.append(self.rec)

            def step(self):
                before = marks()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                done = super().step()
                b.record()
                b.synchronize()
                self.rec["chunks"].append(dict(frame=rec.frame, ms=a.elapsed_time(b),
                                               **spent(before)))
                self.rec["carries"].append(self.carry)
                return done

            def merge(self, m):
                self.rec["merged"] = rec.frame
                out = super().merge(m)
                self.rec["merge_in"], self.rec["merge_T"] = m, out.kf_T_cw
                return out

        def noted_clt(*args, **kwargs):
            lm = inner_clt(*args, **kwargs)
            if rec.verifies and "lm" not in rec.verifies[-1]:
                rec.verifies[-1]["lm"] = lm
            return lm

        def noted_verify(slam, det):
            rec.verifies.append(dict(frame=rec.frame, det=tuple(int(x) for x in det)))
            return inner_verify(slam, det)

        def counted_bcast(x, *args):
            rec.bytes += x.numel() * x.element_size()
            return inner_bcast(x, *args)

        slam_mod.IncrementalGBA = WatchedGBA
        loop_closing.compute_loop_transform = noted_clt
        slam_mod.StereoSlam._dispatch_verify = noted_verify
        serve.broadcast = counted_bcast
        return self

    def __exit__(self, *exc):
        from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing
        from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
        from opendlv_perception_vision_orbslam2_tpu_torch.parallel import serve

        (slam_mod.IncrementalGBA, loop_closing.compute_loop_transform,
         slam_mod.StereoSlam._dispatch_verify, serve.broadcast) = self.inner
        return False

    def replay_gbas(self):
        """Each recorded GBA replayed from its map by the split witness's GBA
        (``split_gba``: the same ``world`` edge blocks summed in rank order in
        one process, no group) for as many chunks as the engine ran, then
        merged into the same map.  Returns ``(the chunks' carries bit-equal,
        the merged keyframe poses bit-equal)`` over every GBA."""
        import torch

        SplitGBA = split_gba(self.world)
        carries_equal = merged_equal = True
        for g in self.gbas:
            w = SplitGBA(g["map"], g["config"])
            for carry in g["carries"]:
                w.step()
                carries_equal &= all(torch.equal(a, b) for a, b in zip(w.carry, carry))
            if g["merge_in"] is not None:
                merged_equal &= torch.equal(w.merge(g["merge_in"]).kf_T_cw, g["merge_T"])
        return carries_equal, merged_equal

    def closures(self, slam_loops: int):
        """Each verification as ``(frame, keyframe pair, n_inliers, n_total,
        verdict)``: the verdict of each is read from its match's ``ok``."""
        return [(v["frame"], v["det"], int(v["lm"].n_inliers), int(v["lm"].n_total),
                 bool(v["lm"].ok)) for v in self.verifies]


def loop_multi_phase(cfg, dev, circuit, loop_ms, base: Path):
    """Phase 22: the CLI on D = max(2, cards) ranks in process (rank 0 here,
    D - 1 spawned by ``parallel/launch.py``) over phase 15's circuit
    (``circuit``: its lefts, rights and ground truth) as PNG pairs, written
    into the directory ``base`` (kept for phase 23) and copied for the run,
    then each GBA the engine started replayed by the split witness's GBA,
    which sums D blocks as the ranks do (``_LoopRecorder.replay_gbas``).
    ``loop_ms``: phase 15's median ms/frame in this call (None: not run).
    Returns rank 0's launch counts and its fps.txt ms/frame (median, worst)
    over frames ``LOOP_WARM``-259."""
    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as cli
    from opendlv_perception_vision_orbslam2_tpu_torch.io import od4 as od4_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as sel_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import collectives, launch
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import trajectory

    t0 = time.perf_counter()
    gc.collect()
    n_cards = torch.cuda.device_count()
    world = max(2, n_cards)
    backend = launch.NCCL if n_cards >= world else launch.GLOO
    lefts, rights, gt = circuit
    n = lefts.shape[0]
    inner_sel, inner_ranks, inner_session = (sel_mod.Selflocalization, launch.LocalRanks,
                                             od4_mod.OD4Session)
    made, ranks_made, watch = [], [], {"syncs": None, "rec": None}

    class Recording(inner_sel):
        """Keeps the pipeline; tells the recorder each frame's number, lost
        flag and capacity; counts the host syncs inside ``track`` over
        frames ``MULTI_SYNC_FRAMES`` with ``watch["syncs"]``."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def track(self, *args, **kwargs):
            rec = watch["rec"]
            if rec is not None:
                rec.frame = self.frame_count
            if watch["syncs"] is not None and self.frame_count in MULTI_SYNC_FRAMES:
                with watch["syncs"]:
                    T = super().track(*args, **kwargs)
            else:
                T = super().track(*args, **kwargs)
            if rec is not None:
                rec.lost.append(self.slam.lost)
                rec.capacity.append(self.slam.map.kf_capacity)
                rec.frame = self.frame_count      # finish() runs after the last frame
            return T

    class Kept(inner_ranks):
        def __init__(self, plan):
            super().__init__(plan)
            ranks_made.append(self)

    def run(directory, ranks):
        del made[:]
        argv = [f"--kittiPath={directory}", f"--cid={LOOP_MULTI_CID}"] + SERVICE_FLAGS
        sel_mod.Selflocalization, launch.LocalRanks = Recording, Kept
        od4_mod.OD4Session = _Session
        try:
            with _CollectiveTimes() as coll, _LoopRecorder(world, coll) as rec:
                watch["rec"] = rec
                t1 = time.perf_counter()
                rc = cli.main(argv, ranks=ranks)
                wall_s = time.perf_counter() - t1
                torch.cuda.synchronize()
        finally:
            sel_mod.Selflocalization, launch.LocalRanks = inner_sel, inner_ranks
            od4_mod.OD4Session = inner_session
            watch["rec"] = None
        return rc, wall_s, made[0].slam, rec, coll.ms()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_multi_") as tmp:
        t1 = time.perf_counter()
        write_kitti_dir(base, lefts, rights, LOOP_FPS)
        dirs = {"ranks": Path(tmp) / "ranks"}
        shutil.copytree(base, dirs["ranks"])
        write_s = time.perf_counter() - t1

        # -- 22a. main on D ranks, in process -----------------------------------
        reset_launches()
        collectives.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        syncs = watch["syncs"] = _SyncCounter()
        try:
            rc, wall_s, slam, rec, coll_ms = run(dirs["ranks"], world)
        finally:
            watch["syncs"] = None
        launches = read_launches()
        stats = dict(collectives.STATS)
        peak0 = torch.cuda.max_memory_allocated()
        ranks = ranks_made[0]
        est = _dumps_complete(dirs["ranks"], n)
        ate = trajectory.ate_rmse(est, list(gt), align=True) if est is not None \
            else float("nan")
        fps_rows = [ln.split() for ln in (dirs["ranks"] / "fps.txt").read_text().split("\n")
                    if ln.strip()]
        ms = np.array([1e3 / float(f) for f, _ in fps_rows])
        timed = ms[LOOP_WARM:]
        service_sites = {k: v for k, v in syncs.sites.items()
                         if k.split(":")[0] in SERVICE_FILES}
        reports = ranks.reports
        worker_ops = {r: rep["ops"] for r, rep in reports.items()}
        worker_launches = {r: rep["launches"] for r, rep in reports.items()}
        lost = [i for i, x in enumerate(rec.lost) if x]
        growth = sorted({(i, c) for i, c in enumerate(rec.capacity)
                         if i == 0 or c != rec.capacity[i - 1]})
        closures = rec.closures(slam.loops_closed)
        chunks = [c for g in rec.gbas for c in g["chunks"]]
        ms_chunk = [c["ms"] for c in chunks]

        def per(items, key, kind):
            return (float(np.mean([c[key][kind] for c in items])) if items else float("nan"))

        coll_line = (
            f"a frame on rank 0 (all {n} frames, chunks included): all-reduce "
            f"{stats['all_reduce'] / n:.2f}, device {coll_ms['all_reduce'] / n:.2f} ms (CUDA "
            f"events), host {1e3 * stats['all_reduce_s'] / n:.2f} ms; broadcast "
            f"{stats['broadcast'] / n:.2f}, device {coll_ms['broadcast'] / n:.2f} ms, host "
            f"{1e3 * stats['broadcast_s'] / n:.2f} ms | a GBA chunk: all-reduce "
            f"{per(chunks, 'calls', 'all_reduce'):.0f}, device "
            f"{per(chunks, 'device_ms', 'all_reduce'):.2f} ms, host "
            f"{per(chunks, 'host_ms', 'all_reduce'):.2f} ms")
        gba_line = "; ".join(
            f"GBA {k + 1} at frame {g['frame']} (K {g['K']}, {g['n_edges']} edges, sharded "
            f"{g['sharded']}, live edges a rank {g['live']}): problem broadcast "
            f"{g['init']['calls']['broadcast']} broadcasts, {g['problem_bytes']} bytes, "
            f"{g['init']['device_ms']['broadcast']:.2f} ms device, "
            f"{g['init']['host_ms']['broadcast']:.2f} ms host, IncrementalGBA() "
            f"{g['init_ms']:.2f} ms; {len(g['chunks'])} chunks at frames "
            f"{[c['frame'] for c in g['chunks']]}, merged at frame {g['merged']}"
            for k, g in enumerate(rec.gbas))
        worker_gba = {r: {k: (v["n"], round(v["ms"] / max(v["n"], 1), 2), round(v["max_ms"], 2))
                          for k, v in ops.items()} for r, ops in worker_ops.items()}
        peaks = [peak0] + [reports[r]["peak_bytes"] for r in sorted(reports)]
        print(f"loop_multi: main(python -m ... --kittiPath=<{n} PNG pairs 1241x376, phase 15's "
              f"circuit> + deploy flags, ranks={world}) on {n_cards} card(s): "
              f"{launch.describe(ranks.plan)} | exit {rc}, worker exit codes "
              f"{ranks.exit_codes}, {wall_s:.1f} s from the call to the last rank's exit "
              f"(deadline {LOOP_MULTI_DEADLINE_S} s) | keyframes {slam.n_keyframes} | map "
              f"points {int(slam.map.pt_valid.sum())} | lost {len(lost)} of {n} {lost} (bound "
              f"< {LOOP_LOST_SHARE * n:g}) | loops {slam.loops_closed} | capacity (frame, kf "
              f"slots) {growth} | ATE of poses.txt {ate:.4f} m (align=True, bound "
              f"{LOOP_ATE_BOUND_M}) | ms/frame from fps.txt over frames {LOOP_WARM}-{n - 1}: "
              f"median {np.median(timed):.2f} mean {timed.mean():.2f} worst {timed.max():.2f} "
              f"at frame {LOOP_WARM + int(np.argmax(timed))} (phase 15 alone in this call: "
              + (f"median {loop_ms:.2f}" if loop_ms is not None else "not run") + ") | "
              f"PNG pairs written in {write_s:.1f} s | launches/frame rank 0 "
              f"{per_frame(launches, n)}; workers {worker_launches} | host syncs in track over "
              f"frames {MULTI_SYNC_FRAMES.start}-{MULTI_SYNC_FRAMES.stop - 1}: at the service "
              f"sites {sum(service_sites.values())}", flush=True)
        print(f"loop_multi_closure: verifications (frame dispatched, (slot, id, cand slot, "
              f"cand id), n_inliers, n_total, ok) {closures}", flush=True)
        print(f"loop_multi_gba: {gba_line} | rank 0 device ms a chunk (CUDA events) "
              + (f"median {np.median(ms_chunk):.2f} max {max(ms_chunk):.2f}" if ms_chunk
                 else "none")
              + f" | each worker's ops served (count, mean ms, max ms; device time by CUDA "
              f"events, collectives' waits included): {worker_gba} | collectives {coll_line} "
              f"| peak device memory a rank (GB) "
              f"{[round(b / 1e9, 3) if b is not None else None for b in peaks]}", flush=True)
        if rc != 0 or ranks.exit_codes != [0] * (world - 1) or \
                not wall_s < LOOP_MULTI_DEADLINE_S:
            raise AssertionError(f"loop multi: exit {rc}, worker exit codes "
                                 f"{ranks.exit_codes}, {wall_s:.1f} s")
        if ranks.plan.world != world or ranks.plan.backend != backend:
            raise AssertionError(f"loop multi: formed {launch.describe(ranks.plan)}, want "
                                 f"{world} ranks over {backend}")
        if est is None:
            raise AssertionError("loop multi: poses.txt, map.txt or fps.txt incomplete")
        inits = [ops.get("gba_init", {"n": 0})["n"] for ops in worker_ops.values()]
        steps = [ops.get("gba_step", {"n": 0})["n"] for ops in worker_ops.values()]
        if slam.loops_closed < 1 or not chunks or not all(g["sharded"] for g in rec.gbas):
            raise AssertionError(f"loop multi: {slam.loops_closed} loops, {len(chunks)} GBA "
                                 f"chunks, sharded {[g['sharded'] for g in rec.gbas]}")
        if inits != [len(rec.gbas)] * (world - 1) or steps != [len(chunks)] * (world - 1):
            raise AssertionError(f"loop multi: workers served {inits} GBA inits and {steps} "
                                 f"chunks; rank 0 started {len(rec.gbas)} and stepped "
                                 f"{len(chunks)}")
        if rec.gbas[-1]["merged"] is None or slam.pending_gba is not None:
            raise AssertionError("loop multi: the last GBA never merged")
        if not max(rec.capacity) > LOOP_INITIAL_KF_SLOTS:
            raise AssertionError(f"loop multi: the map never grew past {LOOP_INITIAL_KF_SLOTS} "
                                 f"keyframe slots {growth}")
        if not len(lost) < LOOP_LOST_SHARE * n:
            raise AssertionError(f"loop multi: frames {lost} lost of {n}")
        if not ate < LOOP_ATE_BOUND_M:
            raise AssertionError(f"loop multi: ATE {ate:.4f} m >= {LOOP_ATE_BOUND_M} m")
        expected = {"fast_nms": 0, "fast_nms_pyramid": n, "gather_patches": n,
                    "gather_patches_multi": n}
        if launches != expected or len(worker_launches) != world - 1 or \
                any(any(v.values()) for v in worker_launches.values()):
            raise AssertionError(f"loop multi: launches rank 0 {launches} (expected "
                                 f"{expected}), workers {worker_launches} (expected none)")
        if service_sites:
            raise AssertionError(f"loop multi: host syncs at the service sites {service_sites}")

        # -- 22b. each GBA replayed by the split witness's GBA ----------------------
        t1 = time.perf_counter()
        same_carries, same_merge = rec.replay_gbas()
        replay_s = time.perf_counter() - t1
        print(f"loop_multi_witness: each GBA the engine started, replayed from its map by "
              f"the split witness's GBA ({world} edge blocks summed in rank order in one "
              f"process) for its {len(chunks)} chunks: carries "
              f"{'bit-equal' if same_carries else 'DIFFER'}, merged keyframe poses "
              f"{'bit-equal' if same_merge else 'DIFFER'} ({replay_s:.1f} s)", flush=True)
        if not (same_carries and same_merge):
            raise AssertionError(f"loop multi: {world} ranks' GBA and the split witness's part")
        del rec
    print(f"loop_multi_phase_seconds: phase 22 {time.perf_counter() - t0:.1f} (the ranks "
          f"{wall_s:.1f}, the replay {replay_s:.1f})", flush=True)
    return launches, (float(np.median(timed)), float(timed.max()))


# Phase 23: the vocabulary file.  A DBoW2 text vocabulary of ORBvoc's shape
# (k = 10, L = 6: 1,111,110 nodes, 10^6 words), written once into the
# git-ignored _build/ by utils/synthetic.py::write_orbvoc_text, its upper 3
# levels trained on the descriptors of ORBVOC_DRIVE, a drive no other phase
# runs (ORBvoc was trained on images other than those it sees); the CLI
# loads it with --vocFilePath, and the engine keeps it for the whole run.
ORBVOC_DRIVE = dict(n_frames=12, n_points=900, seed=3, step=0.8)
ORBVOC_SEED = 0
# where a host sync would grow with the vocabulary's width W
PLACE_FILES = ("kfdb.py", "vocabulary.py")


def orbvoc_file(cfg, dev):
    """``(path, stats, seconds)`` of the ORBvoc-shaped file, keyed by the
    generator's parameters and source: written when missing from the descriptors of
    ``ORBVOC_DRIVE``'s left frames (the port's front end on ``dev``),
    reused otherwise (``seconds`` None)."""
    import hashlib
    import os

    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.models.frontend import process_stereo
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import cuda_build
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic

    params = [ORBVOC_DRIVE, ORBVOC_SEED, synthetic.ORBVOC_BRANCHING, synthetic.ORBVOC_LEVELS,
              synthetic.ORBVOC_TRAINED_LEVELS, cfg.orb.n_features, cfg.orb.n_levels,
              hashlib.sha1(Path(synthetic.__file__).read_bytes()).hexdigest()]   # the writer's
    key = hashlib.sha1(json.dumps(params).encode()).hexdigest()[:12]
    path = cuda_build.BUILD_DIR / (f"orbvoc_k{synthetic.ORBVOC_BRANCHING}_"
                                   f"L{synthetic.ORBVOC_LEVELS}_{key}.txt")
    k, L = synthetic.ORBVOC_BRANCHING, synthetic.ORBVOC_LEVELS
    stats = {"nodes": sum(k ** d for d in range(1, L + 1)), "words": k ** L}
    if path.exists():
        return path, dict(stats, bytes=path.stat().st_size), None
    t = time.perf_counter()
    lefts, rights, _, _ = synthetic.render_stereo_sequence(cfg, **ORBVOC_DRIVE)
    descs = []
    for i in range(len(lefts)):
        f = process_stereo(torch.from_numpy(lefts[i]).to(dev),
                           torch.from_numpy(rights[i]).to(dev), cfg, i / cfg.camera.fps).features
        descs.append(f.desc[f.valid].cpu().numpy())
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    stats = synthetic.write_orbvoc_text(tmp, np.concatenate(descs), seed=ORBVOC_SEED)
    os.replace(tmp, path)
    return path, dict(stats, descriptors=sum(len(d) for d in descs)), time.perf_counter() - t


def vocab_file_phase(cfg, dev, loop_dir: Path, loop_gt, frames, loop_ms, loop_multi_ms):
    """Phase 23: the vocabulary file on the card (see the module's docstring).
    ``loop_dir``: phase 22's PNG pairs of the loop circuit, ``loop_gt`` its
    ground truth; ``frames``: phase 9's ``(lefts, rights, gt)``;
    ``loop_ms`` phase 15's and ``loop_multi_ms`` phase 22's fps.txt ms/frame
    (median, worst) in this call.  Returns drive A's launch counts."""
    import numpy as np
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as cli
    from opendlv_perception_vision_orbslam2_tpu_torch.models import kfdb, loop_closing
    from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as sel_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.models import vocabulary as voc
    from opendlv_perception_vision_orbslam2_tpu_torch.models.frontend import process_stereo
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic, trajectory

    t0 = time.perf_counter()
    gc.collect()
    path, stats, gen_s = orbvoc_file(cfg, dev)
    W = stats["words"]
    print(f"vocab_file: {path.name}: {stats['bytes']} bytes, {stats['nodes']} nodes, {W} words "
          f"(k {synthetic.ORBVOC_BRANCHING}, L {synthetic.ORBVOC_LEVELS}) | "
          + (f"written in {gen_s:.1f} s from {stats['descriptors']} descriptors of "
             f"{ORBVOC_DRIVE['n_frames']} frames (seed {ORBVOC_DRIVE['seed']})"
             if gen_s is not None else "cached in _build/")
          + f" | a [K, W] float32 matrix: {64 * W * 4} bytes at K 64, {256 * W * 4} at K 256",
          flush=True)

    # -- 23A. the CLI with --vocFilePath over the loop circuit --------------------
    n = len(loop_gt)
    inner_sel, inner_load = sel_mod.Selflocalization, voc.load_text_vocabulary
    inner_reg, inner_adopt = slam_mod.StereoSlam._register_keyframe, \
        slam_mod.StereoSlam._adopt_vocab
    inner_train, inner_lc = slam_mod.train_vocab_from_pool, loop_closing.loop_candidates
    inner_hd = loop_closing.LoopCloser.harvest_detect
    inner_verify, inner_clt = slam_mod.StereoSlam._dispatch_verify, \
        loop_closing.compute_loop_transform
    verifies = []                  # (frame, det, LoopMatch) of each verification
    made, loaded, lost, capacity, reg_ms, adopted, trained, lc_events, nominated = \
        [], [], [], [], [], [], [], [], {}
    frame = [0]
    syncs, track_sites = _SyncCounter(), {}    # host syncs made inside track, by site

    class Recording(inner_sel):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def track(self, *args, **kwargs):
            frame[0] = self.frame_count
            before = dict(syncs.sites)
            T = super().track(*args, **kwargs)
            for site, k in syncs.sites.items():
                if k != before.get(site, 0):
                    track_sites[site] = track_sites.get(site, 0) + k - before.get(site, 0)
            lost.append(self.slam.lost)
            capacity.append(self.slam.map.kf_capacity)
            frame[0] = self.frame_count
            return T

    def timed_load(p, *args, **kwargs):
        t = time.perf_counter()
        v = inner_load(p, *args, **kwargs)
        loaded.append((v, time.perf_counter() - t))
        return v

    def timed_reg(slam, *args):
        t = time.perf_counter()
        out = inner_reg(slam, *args)
        reg_ms.append(1e3 * (time.perf_counter() - t))
        return out

    def noted_adopt(slam, vocab):
        adopted.append(frame[0])
        return inner_adopt(slam, vocab)

    def noted_train(*args):
        trained.append(frame[0])
        return inner_train(*args)

    def timed_lc(m, db, kf_slot, *args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner_lc(m, db, kf_slot, *args)
        b.record()
        lc_events.append((frame[0], int(m.kf_capacity), a, b))
        return out

    def noted_hd(closer, pending):
        det = inner_hd(closer, pending)
        if det is not None:
            _, n_valid, _, _, geo_n, _ = pending["fetch"].result()
            geo = pending["run_geo"] and int(n_valid) >= 20 and \
                int(geo_n) >= loop_closing.GEO_VOTE_MIN
            nominated[det] = "geometric vote" if geo else "BoW"
        return det

    def noted_verify(slam, det):
        verifies.append([frame[0], tuple(int(x) for x in det), None])
        return inner_verify(slam, det)

    def noted_clt(*args, **kwargs):
        lm = inner_clt(*args, **kwargs)
        if verifies and verifies[-1][2] is None:
            verifies[-1][2] = lm
        return lm

    d = loop_dir.parent / "vocab_kitti"
    shutil.copytree(loop_dir, d)
    argv = [f"--kittiPath={d}"] + SERVICE_FLAGS + [f"--vocFilePath={path}"]
    sel_mod.Selflocalization, voc.load_text_vocabulary = Recording, timed_load
    slam_mod.StereoSlam._register_keyframe = timed_reg
    slam_mod.StereoSlam._adopt_vocab = noted_adopt
    slam_mod.train_vocab_from_pool, loop_closing.loop_candidates = noted_train, timed_lc
    loop_closing.LoopCloser.harvest_detect = noted_hd
    slam_mod.StereoSlam._dispatch_verify = noted_verify
    loop_closing.compute_loop_transform = noted_clt
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with syncs:
            t1 = time.perf_counter()
            rc = cli.main(argv, ranks=1)
            wall_s = time.perf_counter() - t1
            torch.cuda.synchronize()
        launches = read_launches()
    finally:
        sel_mod.Selflocalization, voc.load_text_vocabulary = inner_sel, inner_load
        slam_mod.StereoSlam._register_keyframe = inner_reg
        slam_mod.StereoSlam._adopt_vocab = inner_adopt
        slam_mod.train_vocab_from_pool, loop_closing.loop_candidates = inner_train, inner_lc
        loop_closing.LoopCloser.harvest_detect = inner_hd
        slam_mod.StereoSlam._dispatch_verify = inner_verify
        loop_closing.compute_loop_transform = inner_clt
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0 or not made or len(loaded) != 1:
        raise AssertionError(f"vocab file: exit {rc}, {len(made)} pipelines, the file loaded "
                             f"{len(loaded)} times")
    slam = made[0].slam
    file_vocab, load_s = loaded[0]
    est = _dumps_complete(d, n)
    if est is None:
        raise AssertionError("vocab file: poses.txt, map.txt or fps.txt incomplete")
    ate = trajectory.ate_rmse(est, list(loop_gt), align=True)
    ms = np.array([1e3 / float(ln.split()[0]) for ln in
                   (d / "fps.txt").read_text().split("\n") if ln.strip()])
    timed = ms[LOOP_WARM:]
    lost_at = [i for i, x in enumerate(lost) if x]
    growth = sorted({(i, c) for i, c in enumerate(capacity)
                     if i == 0 or c != capacity[i - 1]})
    m, db = slam.map, slam.db
    db_bytes = db.bow.numel() * db.bow.element_size() + db.has_row.numel()
    lc_ms = {}
    for f, K, a, b in lc_events:
        lc_ms[K > LOOP_INITIAL_KF_SLOTS] = (f, K, a.elapsed_time(b))
    closures = [(f, det, int(lm.n_inliers), int(lm.n_total), bool(lm.ok),
                 nominated.get(det, "?")) for f, det, lm in verifies]
    place_sites = {k: v for k, v in track_sites.items() if k.split(":")[0] in PLACE_FILES}
    service_sites = {k: v for k, v in track_sites.items() if k.split(":")[0] in SERVICE_FILES}
    outside = {k: v - track_sites.get(k, 0) for k, v in syncs.sites.items()
               if v != track_sites.get(k, 0)}
    worst = LOOP_WARM + np.argsort(-timed)[:3]
    # after finish() (in the CLI's shutdown): every live keyframe's row and
    # node table against the ones recomputed from the map with the file
    words, nodes = voc.transform_all(slam.vocab, m.kf_desc, m.kf_feat_valid)
    live = m.kf_valid
    rows = voc.bow_vectors(slam.vocab, words)
    row_err = float((rows - db.bow)[live].abs().max())
    same_nodes = torch.equal(nodes[live], slam.kf_nodes[live])
    del rows, words, nodes
    # detection on the final database (1 GB at 256 slots), the card against
    # the CPU, at the closing keyframe and the last one: shared-word counts
    # identical, scores within 1e-6, the same candidates (among scores tied
    # to 1e-6 the order is rounding's, as in reloc_card_vs_cpu)
    host_m, host_db = to_cpu(m), to_cpu(db)
    det_slots = sorted({det[0] for _, det, lm in verifies if lm is not None and bool(lm.ok)}
                       | {slam.last_kf_slot})
    det_rows, det_bits = [], True
    for slot in det_slots:
        t = time.perf_counter()
        counts_b = kfdb.common_word_counts(host_db, host_db.bow[slot])
        min_b = loop_closing.loop_min_score(host_m, host_db, slot)
        slots_b, scores_b = loop_closing.loop_candidates(host_m, host_db, slot)
        cpu_ms = 1e3 * (time.perf_counter() - t)
        counts_a = kfdb.common_word_counts(db, db.bow[slot]).cpu()
        min_a = loop_closing.loop_min_score(m, db, slot).cpu()
        slots_a, scores_a = (x.cpu() for x in loop_closing.loop_candidates(m, db, slot))
        gap = max(float((scores_a - scores_b).abs().max()), float((min_a - min_b).abs()))
        tied = [float(sc) for sl, sc in zip(slots_a.tolist() + slots_b.tolist(),
                                            scores_a.tolist() + scores_b.tolist())
                if sl not in set(slots_a.tolist()) & set(slots_b.tolist())]
        if not torch.equal(counts_a, counts_b) or gap > 1e-6 or any(
                abs(sc - float(scores_b[-1])) > 1e-6 for sc in tied):
            raise AssertionError(f"vocab file: detection at slot {slot} differs between card "
                                 f"and CPU: {slots_a} {scores_a} vs {slots_b} {scores_b}")
        det_bits &= torch.equal(scores_a, scores_b) and torch.equal(min_a, min_b)
        det_rows.append(f"slot {slot}: {[c for c in slots_a.tolist() if c >= 0]}, scores "
                        f"within {gap:.1e}, CPU {cpu_ms:.0f} ms")
    del host_m, host_db
    same_vocab = (slam.vocab_given and slam.vocab.n_words == W and all(
        torch.equal(a.cpu(), b) for a, b in zip(slam.vocab[:4], file_vocab[:4])))
    print(f"vocab_cli: main(python -m ... --kittiPath=<{n} PNG pairs, phase 22's> + deploy "
          f"flags + --vocFilePath=<the file>, ranks=1), exit {rc} in {wall_s:.1f} s | the "
          f"loader {load_s:.2f} s | keyframes {slam.n_keyframes} | map points "
          f"{int(m.pt_valid.sum())} | lost {len(lost_at)} of {n} {lost_at} | loops "
          f"{slam.loops_closed} | capacity (frame, kf slots) {growth} | ATE of poses.txt "
          f"{ate:.4f} m (align=True, bound {LOOP_ATE_BOUND_M}) | fps.txt ms/frame over frames "
          f"{LOOP_WARM}-{n - 1}: median {np.median(timed):.2f} worst {timed.max():.2f} (the "
          f"worst 3 at frames {worst.tolist()}: {np.round(ms[worst], 1).tolist()}) (phase "
          f"15 in this call: median "
          + (f"{loop_ms:.2f}" if loop_ms is not None else "not run")
          + f"; phase 22: median {loop_multi_ms[0]:.2f} worst {loop_multi_ms[1]:.2f}) | "
          f"_register_keyframe host ms median {np.median(reg_ms):.2f} max {max(reg_ms):.2f} "
          f"x{len(reg_ms)} | launches/frame {per_frame(launches, n)}", flush=True)
    print(f"vocab_cli_place: the vocabulary replaced {len(adopted)} times, retrains "
          f"{len(trained)}, given {slam.vocab_given}, the file's tensors "
          f"{'kept' if same_vocab else 'NOT KEPT'} ({slam.vocab.n_words} words) | database "
          f"{tuple(db.bow.shape)}, {db_bytes} bytes | rows of {int(live.sum())} live keyframes "
          f"vs recomputed: max abs err {row_err:.1e}, node tables "
          f"{'equal' if same_nodes else 'DIFFER'} | loop_candidates device ms (CUDA events): "
          + "; ".join(f"{'after growth' if g else 'at 64 slots'}: frame {f}, K {K}, {t:.3f}"
                      for g, (f, K, t) in sorted(lc_ms.items()))
          + f" ({len(lc_events)} calls) | peak device memory {peak_gb:.3f} GB | host syncs "
          f"inside track {sum(track_sites.values())} ({sum(track_sites.values()) / n:.3f} a "
          f"frame), in {'/'.join(PLACE_FILES)}: {sum(place_sites.values())}, at the service "
          f"sites: {sum(service_sites.values())}; every site: "
          + ("; ".join(f"{k} x{v}" for k, v in sorted(track_sites.items(), key=lambda kv: -kv[1]))
             or "none")
          + " | outside track (the engine's set-up, the shutdown's dumps): "
          + ("; ".join(f"{k} x{v}" for k, v in sorted(outside.items(), key=lambda kv: -kv[1]))
             or "none"), flush=True)
    print(f"vocab_cli_closure: verifications (frame dispatched, (slot, id, cand slot, cand id), "
          f"n_inliers, n_total, ok, channel) {closures} | loop_candidates / loop_min_score / "
          f"common_word_counts on the final database, card vs CPU: "
          f"{'bit-equal' if det_bits else 'counts and candidates equal'} ({'; '.join(det_rows)})",
          flush=True)
    expected = {"fast_nms": 0, "fast_nms_pyramid": n, "gather_patches": n,
                "gather_patches_multi": n}
    if launches != expected:
        raise AssertionError(f"vocab file: kernel launches {launches}, expected {expected}")
    if not len(lost_at) < LOOP_LOST_SHARE * n:
        raise AssertionError(f"vocab file: frames {lost_at} lost of {n}")
    if not max(capacity) > LOOP_INITIAL_KF_SLOTS:
        raise AssertionError(f"vocab file: the map never grew past {LOOP_INITIAL_KF_SLOTS} "
                             f"keyframe slots {growth}")
    if slam.loops_closed < 1:
        raise AssertionError("vocab file: no loop closed")
    if not ate < LOOP_ATE_BOUND_M:
        raise AssertionError(f"vocab file: ATE {ate:.4f} m >= {LOOP_ATE_BOUND_M} m")
    if adopted or trained or slam._vocab_thread is not None or not same_vocab or \
            db.bow.shape[1] != W:
        raise AssertionError(f"vocab file: the vocabulary was replaced at frames {adopted}, "
                             f"retrained at {trained}, kept {same_vocab}, database "
                             f"{tuple(db.bow.shape)}")
    if not bool((db.has_row | ~live).all()) or row_err > 1e-6 or not same_nodes:
        raise AssertionError(f"vocab file: stored rows (max abs err {row_err}) or node tables "
                             "differ from the ones recomputed from the map")
    if service_sites or place_sites:
        raise AssertionError(f"vocab file: host syncs at the service sites {service_sites}, "
                             f"in the place-recognition code {place_sites}")
    del slam, made, db, m
    t_a = time.perf_counter() - t0

    # -- 23B. relocalization with the file: phase 12's drive and phase 13's kidnap --
    lefts, rights, gt = frames
    cam = cfg.camera
    gc.collect()
    slam = slam_mod.StereoSlam(cfg, vocab=file_vocab, device=dev, enable_loop_closing=False)
    swaps = []
    slam._adopt_vocab = lambda vocab: swaps.append(slam.n_keyframes)
    lat = drive_slam(slam, lefts, rights, cam.fps)
    slam.finish()
    tried, fed = kidnap_drive(slam, lefts, rights, gt, cam.fps, torch.cuda.synchronize)
    recovered = [t for t in tried if t[2]]
    label, lost_end, err_end = fed[-1]
    print(f"vocab_kidnap: StereoSlam(cfg, vocab=<the file>) relocalization on over phase 12's "
          f"{len(lefts)} frames ({1e3 * float(np.median(lat[1:])):.2f} ms/frame median), "
          f"keyframes {slam.n_keyframes}, database {tuple(slam.db.bow.shape)} | rungs tried: "
          f"{fmt_tried(tried)} | per frame (lost, pose error m): "
          + ", ".join(f"{lb} {'lost' if lo else 'ok'}" + (f" {e:.4f}" if e is not None else "")
                      for lb, lo, e in fed)
          + f" | recovered by {recovered[0][1] if recovered else 'no rung'} | bound "
          f"{KIDNAP_BOUND_M} m", flush=True)
    if swaps or slam.vocab.n_words != W:
        raise AssertionError(f"vocab kidnap: the vocabulary was replaced at {swaps}")
    if not recovered or lost_end or not err_end < KIDNAP_BOUND_M:
        raise AssertionError(f"vocab kidnap: at {label} lost={lost_end}, pose error {err_end} m "
                             f"(bound {KIDNAP_BOUND_M}), recovered by {recovered}")
    slam.finish()
    frame6 = process_stereo(torch.from_numpy(lefts[6]).to(dev),
                            torch.from_numpy(rights[6]).to(dev), cfg, 0.0)
    reloc_card_vs_cpu(slam, frame6, gt[6], cfg)
    print(f"vocab_file_phase_seconds: phase 23 {time.perf_counter() - t0:.1f} (the file "
          + (f"{gen_s:.1f}" if gen_s is not None else "cached")
          + f", drive A {t_a:.1f} with the loader's {load_s:.1f})", flush=True)
    return launches


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
    lefts, rights, gt, world = synthetic.render_stereo_sequence(
        cfg, n_frames=24, n_points=900, seed=0, step=0.6
    )
    both = torch.from_numpy(np.stack([lefts[0], rights[0]])).to(dev)
    depth0 = torch.from_numpy(synthetic.render_depth_map(
        gt[0], world, cam.height, cam.width, cam.fx, cam.fy, cam.cx, cam.cy)).to(dev)
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
    # one eye (the RGB-D and monocular front ends): the 8 levels of the
    # frame's left image in one launch
    one_levels, _, one_orb, mono_orb = record_one_eye(cfg, both[0], depth0)
    for t in FAST_THRESHOLDS:
        maps = fast_kernel.fast_nms_pyramid(one_levels, t)
        for lvl, (m, lv) in enumerate(zip(maps, one_levels)):
            err = max(err, check_equal(f"fast_nms_pyramid one eye level {lvl} th={t}", m,
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
    n_bytes, n_ops, shares = fast_work(one_levels, th)
    one = timed_pair(lambda: fast_kernel.fast_nms_pyramid(one_levels, th),
                     lambda: [fast_kernel.fast_nms_plain(lv, th) for lv in one_levels])
    one_row = site_row("one-eye pyramid (RGB-D / mono frame)", 1, one["kernel"]["device_ms"],
                       one["plain"]["device_ms"], n_bytes, n_ops, None,
                       candidate_share=[round(x, 4) for x in shares])
    results["fast_nms"] = dict(max_abs_err=err, **kernel_fields(frame_row),
                               wall_ms=pyr["kernel"]["wall_ms"],
                               sites=fast_sites + [frame_row, one_row])
    print(f"fast_nms: bit-equal to plain, fast_nms_pyramid on the frame's and on random and "
          f"integer-valued 376x1241 pyramids ({len(levels)} levels x 2 eyes) and on the "
          f"frame's one-eye pyramid ({len(one_levels)} levels) at th "
          f"{'/'.join(f'{t:g}' for t in FAST_THRESHOLDS)}, fast_nms on a random image at th 7/20 "
          f"| per frame at th {th:g}: {fmt_pair(pyr)} | one eye: {fmt_pair(one)}", flush=True)
    for row in fast_sites + [frame_row, one_row]:
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
    for name, job in (("one-eye ORB atlas", one_orb), ("mono init ORB atlas", mono_orb)):
        err = max(err, check_equal(f"gather {name} N={job[1].shape[0]}",
                                   gather_kernel.gather_patches(*job),
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
    one_rows = [site_row(f"{name} {job[3]}x{job[4]} N={job[1].shape[0]} (one launch a frame)", 1,
                         graph_ms(lambda job=job: gather_kernel.gather_patches(*job)),
                         graph_ms(lambda job=job: gather_kernel.gather_patches_plain(*job)),
                         gather_bytes([job]), 0, graph_ms(unfold_gather(*job)))
                for name, job in (("one-eye ORB atlas (RGB-D)", one_orb),
                                  ("one-eye ORB atlas (mono init)", mono_orb))]
    results["gather_patches"] = dict(max_abs_err=err, **kernel_fields(frame_row),
                                     sites=gather_sites + [pair_row, frame_row] + one_rows)
    print(f"gather_patches: bit-equal to plain on the frame's ORB atlas (N={ys.shape[0]}, "
          f"{side}x{side}), its SAD windows 11x11 and strips 11x21 (gather_patches and one "
          f"gather_patches_multi launch), the one-eye ORB atlases (N={one_orb[1].shape[0]}, "
          f"{mono_orb[1].shape[0]}) and clipped starts", flush=True)
    for row in gather_sites + [pair_row, frame_row] + one_rows:
        print(fmt_site("gather_patches", row), flush=True)
    del pyramids, maps, clipped, expect, far, one_levels, one_orb, mono_orb  # phase 9's peak

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
    for seed in range(1, 4):
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
    print("vo_kitti_draws: per-frame seed 0-3: ATE "
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
    t_ns = time.perf_counter_ns()
    slam_lat = lat = drive_slam(slam, lefts, rights, cam.fps)
    slam_launches = read_launches()
    stages_9 = stage_host_ms(t_ns)
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
          f"{per_frame(slam_launches, n_frames)} | mapping stages by path, host ms: "
          f"{stages_9}", flush=True)

    # -- 10. where the SLAM time goes ---------------------------------------
    # the layers are timed over frames 0-17; the profiler reads the last 6
    # (steady frames, a keyframe stage among them)
    spans, n_prof_slam = {}, 6
    restore = timed_layers(slam_mod, ("track_frame_with_map", "insert_stage",
                                      "mapping_stage"), spans)
    timed_stage = slam_mod.mapping_stage

    def stage_then_eager(*args, **kwargs):
        # on the card the stage replays its passes as one CUDA graph: each
        # pass is timed on an eager run of the same inputs, after the stage
        out = timed_stage(*args, **kwargs)
        undo = timed_layers(slam_mod, ("_mapping_stage_eager",) + MAPPING_PASSES, spans)
        try:
            slam_mod._mapping_stage_eager(*args, **kwargs)
        finally:
            undo()
        return out

    slam_mod.mapping_stage = stage_then_eager
    try:
        slam = slam_mod.StereoSlam(cfg, device=dev, **SLAM_OFF)
        drive_slam(slam, lefts[:n_frames - n_prof_slam], rights[:n_frames - n_prof_slam],
                   cam.fps)
    finally:
        restore()
    todo = iter(range(n_frames - n_prof_slam, n_frames))
    busy_ms, ops = device_busy(next_slam_frame_of(slam, todo, lefts, rights, cam.fps),
                               n_prof_slam)
    slam.finish()

    def med(name):
        v = spans.get(name, [])
        return f"{1e3 * float(np.median(v)):.2f} ms x{len(v)}" if v else "not run"

    print("slam_kitti_time: median per call, sync both sides: "
          + " | ".join(f"{n} {med(n)}" for n in ("track_frame_with_map", "insert_stage",
                                                 "mapping_stage"))
          + f" | the same stages run eagerly {med('_mapping_stage_eager')}, its passes: "
          + ", ".join(f"{n} {med(n)}" for n in MAPPING_PASSES)
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

    # -- 12-14. place recognition, relocalization, localization-only mode ---
    reloc_launches, reloc_lat = reloc_phases(cfg, fcfg, dev, lefts, rights, gt, expected,
                                             slam_lat, n_timed, n_prof_slam)

    # -- 15-16. loop closing and global BA on the loop circuit ---------------
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    atexit.register(shutil.rmtree, work, True)
    loop_launches, circuit, loop_ms = loop_phases(cfg, dev, closure_path=work / "closure.pt")

    # -- 17-18. RGB-D and monocular SLAM at KITTI size ------------------------
    t_phase = time.perf_counter()
    rgbd_launches = rgbd_phase(cfg, dev)
    mono_launches = mono_phase(cfg, dev)
    print(f"sensor_phases_seconds: phases 17-18 {time.perf_counter() - t_phase:.1f}", flush=True)

    # -- 19. the service layer: the CLI, publishing, the live loop -----------
    t_phase = time.perf_counter()
    service_launches, service_ms = service_phase(cfg, dev, reloc_lat)
    print(f"service_phase_seconds: phase 19 {time.perf_counter() - t_phase:.1f}", flush=True)

    # -- 20. multi-device SLAM: 2 gloo ranks on the card ------------------------
    t_phase = time.perf_counter()
    multi_launches = multi_rank_phase(cfg, dev, work, work / "closure.pt", slam_ms)
    print(f"multi_phase_seconds: phase 20 {time.perf_counter() - t_phase:.1f}", flush=True)

    # -- 21. the service CLI on every visible card ------------------------------
    service_multi_launches = service_multi_phase(cfg, dev, service_ms)

    # -- 22. a loop closure on every card -----------------------------------------
    loop_dir = work / "loop_kitti"        # phase 15's circuit as PNG pairs, for 22 and 23
    loop_multi_launches, loop_multi_ms = loop_multi_phase(cfg, dev, circuit, loop_ms, loop_dir)

    # -- 23. the vocabulary file on the card ----------------------------------------
    vocab_launches = vocab_file_phase(cfg, dev, loop_dir, circuit[2], (lefts, rights, gt),
                                      loop_ms, loop_multi_ms)
    del circuit

    kernels = [
        dict(name=name, route="cuda",
             source=f"opendlv_perception_vision_orbslam2_tpu_torch/csrc/{name}.cu",
             replaces=REPLACES[name], launches=kernel_launches(loop_launches, name),
             launches_vo=kernel_launches(launches, name),
             launches_slam=kernel_launches(slam_launches, name),
             launches_reloc=kernel_launches(reloc_launches, name),
             launches_rgbd=kernel_launches(rgbd_launches, name),
             launches_mono=kernel_launches(mono_launches, name),
             launches_service=kernel_launches(service_launches, name),
             launches_multi=kernel_launches(multi_launches, name),
             launches_service_multi=kernel_launches(service_multi_launches, name),
             launches_loop_multi=kernel_launches(loop_multi_launches, name),
             launches_vocab_file=kernel_launches(vocab_launches, name),
             **results[name])
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
