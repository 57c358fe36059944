"""One run of one cell.

Set-up is the service's as ``python -m opendlv_perception_vision_orbslam2_tpu_torch``
sets it up (``__main__.main``): ``config_from_flags`` over the configuration's
flags, ``load_text_vocabulary`` of the vocabulary file,
``launch.local_ranks("cuda", <the cell's chips>)``, and ``Selflocalization``
publishing into the benchmark's OD4 sink.  Then a few warm-up frames of the
same sequence, and the window: one client in a closed loop, handing frame
``i + 1`` when ``track`` returns for frame ``i``, as the KITTI runner does
with ``real_time=False``.  A frame's latency runs from handing it to
``track`` until its Geolocation reaches the sink; when the window closes the
publisher is flushed and those sends count with their real times.

Frames come from the traffic's generator in a process of its own, through
a ring of shared-memory slots.  After the window the program's state is
freed and the reference judges every frame handed in it
(``benchmark/reference``).
"""

from __future__ import annotations

import gc
import json
import math
import multiprocessing as mp
import queue as queue_mod
import subprocess
import sys
import time

import numpy as np

from . import frames, spec, vocab
from .sink import Sink

#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "opendlv_perception_vision_orbslam2_tpu")
CACHE = spec.BENCH_DIR / "cache"
GET_TIMEOUT_S = 120.0       # a generator that sends nothing for this long has failed
WAIT_NOTICE_S = 1e-3        # a take from the queue longer than this is a wait
PROFILE_SKIP = 8            # window frames before the profiled ones (--trace 1)
PROFILE_FRAMES = 12         # frames profiled
#: the reference's controls (``reference/poses.py``, ``reference/bow.py``)
CONTROLS = ("stale", "scale", "bf16")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class Window:
    """What a window recorded, for the end-to-end numbers and the readers
    of per-layer metrics (``benchmark/metrics``)."""

    def __init__(self):
        self.frames: list = []       # frame indices handed, in order
        self.hand: dict = {}         # frame -> host time handed to track
        self.returned: dict = {}     # frame -> host time track returned
        self.sent: dict = {}         # frame -> host time its Geolocation was sent
        self.geo: dict = {}          # frame -> (lat, lon, alt, heading)
        self.lost_frames: list = []  # frames after which the tracker was lost
        self.waits = 0               # frames that waited for the generator
        self.t0 = self.t1 = 0.0      # the window, flush included
        self.spans = None            # trace.Spans (--trace 1)
        self.device = None           # trace.DeviceWindow (--trace 1)
        self.kernels: dict = {}      # kernel -> (bound s, device s, calls, launches)
        self.busy_s = None


def end_to_end(w: Window, setup_s: float) -> dict:
    lat = [1e3 * (w.sent[f] - w.hand[f]) for f in w.frames if f in w.sent]
    return {
        "setup_s": setup_s,
        "frames_per_s": len(lat) / (w.t1 - w.t0),
        "pose_ms_p50": float(np.percentile(lat, 50)) if lat else None,
        "pose_ms_p90": float(np.percentile(lat, 90)) if lat else None,
    }


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


class FrameSource:
    """The traffic's frames, rendered by ``frames.serve_frames`` in a process
    of its own into ``SLOTS`` slots of a shared buffer: handing a frame over
    costs a slot index, not a copy.  A slot is given back once ``track`` has
    returned (the program has copied the images by then)."""

    SLOTS = 64

    def __init__(self, traffic: dict, cam, seed: int):
        from multiprocessing import shared_memory

        kind = traffic["frames"]
        ctx = mp.get_context("spawn")
        self.shm = shared_memory.SharedMemory(create=True,
                                              size=self.SLOTS * frames.slot_bytes(cam, kind))
        self.views = frames.slot_views(self.shm.buf, cam, kind, self.SLOTS)
        self.free, self.ready, self.stop = ctx.Queue(), ctx.Queue(), ctx.Event()
        for k in range(self.SLOTS):
            self.free.put(k)
        self.proc = ctx.Process(target=frames.serve_frames, daemon=True,
                                args=(traffic, cam, seed, self.shm.name, self.SLOTS,
                                      self.free, self.ready, self.stop))
        self.proc.start()

    def take(self):
        """``(i, a, b, slot, seconds waited)``."""
        t = time.perf_counter()
        while True:
            try:
                i, slot = self.ready.get(timeout=1.0)
                break
            except queue_mod.Empty:
                if not self.proc.is_alive() or time.perf_counter() - t > GET_TIMEOUT_S:
                    raise RuntimeError("the frame generator stopped") from None
        a, b = self.views[slot]
        return i, a, b, slot, time.perf_counter() - t

    def close(self) -> None:
        self.stop.set()
        deadline = time.monotonic() + 10
        while self.proc.is_alive() and time.monotonic() < deadline:
            for q in (self.ready, self.free):
                try:
                    while True:
                        q.get_nowait()
                except queue_mod.Empty:
                    pass
            self.proc.join(0.1)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(5)
        for q in (self.ready, self.free):
            q.close()
            q.join_thread()
        del self.views
        self.shm.close()
        self.shm.unlink()


def run(name: str, seed: int, seconds: float, trace: bool, t_process: float, *,
        device: str = "cuda", control: str | None = None, bench: dict | None = None) -> int:
    """Run cell ``name`` and print its result as the last line of standard
    output; ``control`` (one of :data:`CONTROLS`) judges that control of the
    reference in the program's place instead.  Returns the exit code."""
    import torch

    bench = bench or spec.load()
    cell = spec.workload(bench, name)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    chips = int(cell["chips"])
    if device == "cuda":
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            log(f"{name} needs {chips} CUDA device(s); this machine has {found}")
            return 2
    cam = frames.camera_from_flags(cfg["flags"])
    source = FrameSource(traffic, cam, seed)
    try:
        w, out = _drive(cfg, cam, chips, source, seconds, trace, t_process, device)
    finally:
        source.close()

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"modules that may not be loaded: {', '.join(loaded)}")
        return 3

    t = time.perf_counter()
    numbers = judge_numbers(w, out, traffic, cam, cfg, control)
    log(f"reference in {time.perf_counter() - t:.2f} s"
        + (f" (control {control})" if control else ""))
    from reference import poses as ref

    ok, checks = ref.judge(numbers, cfg["limits"])
    unsent = len(w.frames) - len(w.geo)
    checks["unsent"] = {"value": unsent, "limit": 0}
    correct = ok and unsent == 0

    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in spec.metrics_of(bench, name, kind)}
    if trace:
        values = {m: spec.metric_reader(m)(w) for m in units}
    else:
        values = end_to_end(w, out["setup_s"])
        log("end to end: " + ", ".join(f"{k} {v}" for k, v in values.items()))
    metrics = {m: {"value": values[m], "unit": units[m]} for m in units
               if values.get(m) is not None and math.isfinite(values[m])}
    dev = out["device"]
    if trace and w.device is not None:
        dev = dict(dev, busy_s=w.busy_s, window_s=w.device.t1 - w.device.t0)
    result = {"correct": correct, "attempted": len(w.frames), "failed": len(w.lost_frames) + unsent,
              "metrics": metrics, "device": dev}
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def judge_numbers(w: Window, out: dict, traffic: dict, cam, cfg: dict, control: str | None):
    """Every number the reference reads: of the program's run, or of the
    control ``control`` in its place; every run logs the program's, and a
    control run each control's too."""
    from reference import bow, poses as ref

    def truth(i):
        return frames.pose(traffic, i, cam.fps)

    voc = cfg["vocabulary"]
    level_desc, idf = bow.tree(voc["branching"], voc["levels"], voc["seed"], voc["train"])
    kfs = out["keyframes"]
    ref_rows = bow.rows(level_desc, idf, voc["branching"], kfs["desc"], kfs["feat_valid"])
    published = [(f, *ref.geolocation_to_centre(*w.geo[f], *out["ref_point"]))
                 for f in w.frames if f in w.geo]

    def numbers_of(name):
        if name is None:
            pub, anchors, kf_poses = published, out["anchors"], kfs["poses"]
            rows = kfs["rows"]
        else:
            pub, anchors, kf_poses = ref.control_poses(name, w.frames, out["anchors"],
                                                       kfs["poses"], truth)
            rows = [(wd, bow.bf16(v) if name == "bf16" else v) for wd, v in ref_rows]
        n = ref.pose_numbers(pub, anchors, truth)
        n.update(ref.keyframe_numbers(kf_poses, truth))
        n.update(bow.bow_numbers(rows, ref_rows, kfs["ids"]))
        return n

    def show(n, who):
        log(f"reference, {who}: {n['frames']} frames against {n['keyframes']} keyframes, "
            f"{n['kf_pairs']} keyframe pairs, {n['bow_keyframes']} BoW rows: "
            + ", ".join(f"{k} {v}" for k, v in n.items()
                        if k.startswith(("pose", "kf_rel", "kf_scale", "bow_row", "worst",
                                         "bow_worst"))))

    numbers = numbers_of(None)
    show(numbers, "the program")
    if control is None:
        return numbers
    for name in CONTROLS:
        n = numbers_of(name)
        show(n, f"control {name}")
        if name == control:
            numbers = n
    return numbers


def _drive(cfg, cam, chips, source, seconds, trace, t_process, device):
    """Set up, warm up and run the window; returns ``(Window, facts)`` with
    the program's state freed."""
    import torch

    from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as sel_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.models.vocabulary import (
        load_text_vocabulary,
    )
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import launch
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import (
        config_from_flags,
        parse_flags,
    )

    from . import trace as tr

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    power = _power_limit() if cuda else None
    voc_path, written_s = vocab.ensure(CACHE / "vocab", cfg["vocabulary"])
    if written_s is not None:
        log(f"vocabulary written in {written_s:.1f} s: {voc_path.name}")
    config = config_from_flags(parse_flags(list(cfg["flags"]) + [f"--vocFilePath={voc_path}"]))
    t = time.perf_counter()
    voc = load_text_vocabulary(config.voc_file_path)
    log(f"vocabulary loaded in {time.perf_counter() - t:.2f} s ({voc.n_words} words)")

    # the frame each keyframe id was made from: (id, timestamp) at every insert
    kf_log = []
    spans = tr.Spans()

    def note_insert(args, _out):
        kf_log.append((args[0].next_kf_id, args[1].timestamp))

    spans.wrap(slam_mod, "insert_stage", "insert", note_insert)
    if not trace:
        spans.items = _Discard()       # the bookkeeping alone, no span kept
    w = Window()
    # each window frame's map as its pose was published: (kf_valid, kf_id,
    # kf_T_cw), references to the program's tensors (its map updates are out
    # of place), read after the window
    maps = {}
    capture = {"on": False, "fast": [], "gather": []}
    syncs = None
    waited = []
    group = launch.local_ranks(device, chips)
    with group as dev:
        sink = Sink()
        pipe = sel_mod.Selflocalization(config, od4=sink, vocab=voc, device=dev)
        fps = cam.fps
        # the warm-up: every ``stride``-th frame of the sequence's start, so
        # that the engine reaches the keyframe count of its steady schedule
        # (more than 5: decisions deferred a frame) before the window
        warm = cfg["warmup"]
        for _ in range(warm["frames"] * warm["stride"]):
            i, a, b, slot, _ = source.take()
            if i % warm["stride"] == 0:
                pipe.track(a, b, i / fps)
            source.free.put(slot)
        pipe.publisher.flush(pipe.frame_count)
        sync()
        n_warm_geo = len(sink.geolocations)
        log(f"warm-up: {warm['frames']} frames (every {warm['stride']}), "
            f"{pipe.slam.n_keyframes} keyframes, steady {pipe.slam._pipeline_healthy}, "
            f"lost {pipe.slam.lost}, {torch.cuda.max_memory_allocated(dev) if cuda else 0} "
            f"bytes peak")
        if trace:
            _instrument(spans, pipe, slam_mod, capture)
            w.spans = spans
            if cuda:
                syncs = _SyncCount().__enter__()
        w.t0 = time.perf_counter()
        # writing the vocabulary file is the benchmark's asset, made once a
        # checkout; the service's start loads it (ORBvoc.txt ships)
        setup_s = w.t0 - t_process - (written_s or 0.0)
        end = w.t0 + seconds
        k = steady = 0
        inliers = []
        m = pipe.slam.map
        grown = [(None, (m.kf_capacity, m.pt_capacity))]   # map capacity changes
        while time.perf_counter() < end:
            t_ask = time.perf_counter()
            i, a, b, slot, dt = source.take()
            waited.append(dt)
            if trace:
                spans.add("generator", t_ask, time.perf_counter())
                if cuda and k == PROFILE_SKIP:
                    w.device = tr.DeviceWindow()
                    w.device.start()
                    capture["on"] = True
            spans.frame = i
            w.frames.append(i)
            w.hand[i] = time.perf_counter()
            pipe.track(a, b, i / fps)
            w.returned[i] = time.perf_counter()
            source.free.put(slot)
            m = pipe.slam.map
            maps[i] = (m.kf_valid, m.kf_id, m.kf_T_cw)
            if trace:
                spans.add("track", w.hand[i], w.returned[i])
                if capture["on"] and k == PROFILE_SKIP + PROFILE_FRAMES - 1:
                    w.device.stop()
                    capture["on"] = False
            if pipe.slam.lost:
                w.lost_frames.append(i)
            caps = (m.kf_capacity, m.pt_capacity)
            if caps != grown[-1][1]:
                grown.append((i, caps))
            steady += bool(pipe.slam._pipeline_healthy)
            if pipe.slam.last_stats is not None:
                inliers.append(int(pipe.slam.last_stats[0]))
            k += 1
        if capture["on"]:
            w.device.stop()
            capture["on"] = False
        pipe.publisher.flush(pipe.frame_count)
        w.t1 = time.perf_counter()
        if syncs is not None:
            syncs.__exit__(None, None, None)
            log(f"host syncs in the window: {syncs.n} ({syncs.n / max(len(w.frames), 1):.2f} "
                f"a frame)")
        geo = sink.geolocations[n_warm_geo:]
        for f, g in zip(w.frames, geo):
            w.sent[f] = g[0]
            w.geo[f] = g[1:]
        w.waits = sum(dt > WAIT_NOTICE_S for dt in waited)
        lags = np.bincount(pipe.publisher.lags).tolist() if pipe.publisher.lags else []
        log(f"window: {len(w.frames)} frames in {w.t1 - w.t0:.2f} s, {len(geo)} Geolocations, "
            f"{sink.other} map messages, {len(w.lost_frames)} lost {w.lost_frames[:12]}, "
            f"{steady} steady, median inliers {np.median(inliers) if inliers else None}, "
            f"{pipe.slam.n_keyframes} keyframes made, {pipe.slam.loops_closed} loops closed, "
            f"map (keyframe, point) slots "
            f"{grown[0][1]}, grown at (frame, slots) {grown[1:]}; {w.waits} frames waited over "
            f"{1e3 * WAIT_NOTICE_S:.0f} ms for the generator (longest "
            f"{1e3 * max(waited, default=0):.2f} ms, in all {sum(waited):.3f} s); "
            f"publish lag in frames (count by lag): {lags}")
        pipe.slam.finish()
        sync()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        ref_point = (config.ref_latitude, config.ref_longitude, config.start_heading)
        final = _final_keyframes(pipe.slam)
        spans.restore()
        host = {}
        for f, tensors in maps.items():
            maps[f] = tuple(host.setdefault(id(x), x.cpu().numpy()) for x in tensors)
        del pipe, m, sink, host
    peaks = [peak] + [rep.get("peak_bytes") or 0 for rep in group.reports.values()]
    ids_to_frame = {}
    for kf_id, ts in kf_log:
        ids_to_frame[int(kf_id)] = int(round(float(ts) * cam.fps))
    anchors = {}
    for f, (valid, ids, T) in maps.items():
        # the newest keyframe of the map the frame's pose was published from
        k = int(np.argmax(np.where(valid, ids, -1)))
        if valid[k] and int(ids[k]) in ids_to_frame:
            anchors[f] = (ids_to_frame[int(ids[k])], T[k].astype(np.float64))
    kf_poses, unmapped = [], []
    for k in np.argsort(final["ids"]):
        kf_id = int(final["ids"][k])
        if kf_id in ids_to_frame:
            kf_poses.append((ids_to_frame[kf_id], final["T_cw"][k].astype(np.float64)))
        else:
            unmapped.append(kf_id)
    final["poses"] = kf_poses
    log(f"map at the window's end: {len(final['ids'])} keyframes, {len(kf_poses)} with their "
        f"frames, ids not inserted by the window or warm-up: {unmapped}")
    breakdown = None
    if trace and w.device is not None:
        breakdown = _reduce_trace(w, capture, tr)
    del kf_log, capture, maps
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": chips if cuda else 1, "memory_peak_bytes": int(max(peaks)),
                   "power_limit": power}
    log(f"device: {device_info}; setup {setup_s:.2f} s")
    return w, {"setup_s": setup_s, "anchors": anchors, "ref_point": ref_point, "keyframes": final,
               "device": device_info, "breakdown": breakdown}


def _final_keyframes(slam) -> dict:
    """The map's live keyframes once the engine has settled: ids, poses,
    descriptors, and each one's row of the keyframe database as
    ``(words, weights)`` (None where it has none), copied to the host."""
    import torch

    m = slam.map
    slots = torch.nonzero(m.kf_valid).flatten()
    out = {"ids": m.kf_id[slots].cpu().numpy(), "T_cw": m.kf_T_cw[slots].cpu().numpy(),
           "desc": m.kf_desc[slots].cpu().numpy(),
           "feat_valid": m.kf_feat_valid[slots].cpu().numpy(), "rows": []}
    db = slam.db
    has = db.has_row[slots].cpu().numpy() if db is not None else np.zeros(len(slots), bool)
    for s, h in zip(slots.tolist(), has):
        if not h:
            out["rows"].append(None)
            continue
        words = torch.nonzero(db.bow[s]).flatten()
        out["rows"].append((words.cpu().numpy(), db.bow[s, words].double().cpu().numpy()))
    return out


class _Discard(list):
    """A span list that keeps nothing (runs without ``--trace``)."""

    def append(self, item) -> None:
        pass


def _instrument(spans, pipe, slam_mod, capture) -> None:
    """Spans around the calls into the program's layers, and the inputs of
    the hand-written kernels' calls while ``capture["on"]``."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import extractor
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import stereo

    spans.items = []
    for attr in ("process_stereo", "process_rgbd"):
        spans.wrap(slam_mod, attr, "frontend")
    spans.wrap(slam_mod, "track_frame_with_map", "tracking")
    spans.wrap(slam_mod, "mapping_stage", "mapping")
    for attr in ("process", "process_rgbd"):
        spans.wrap(pipe.slam, attr, "slam")
    spans.wrap(pipe.slam, "_register_keyframe", "register")
    spans.wrap(pipe.publisher, "drain", "publish")

    def keep(kind, make):
        def note(args, _out):
            if capture["on"]:
                capture[kind].append(make(args))
        return note

    spans.wrap(extractor, "fast_nms_pyramid", "fast_nms",
               keep("fast", lambda a: (list(a[0]), float(a[1]))))
    spans.wrap(extractor, "gather_patches", "gather_patches", keep("gather", lambda a: [a]))
    spans.wrap(stereo, "gather_patches_multi", "gather_patches",
               keep("gather", lambda a: list(a[0])))


def _reduce_trace(w: Window, capture, tr) -> dict:
    """Busy time, kernel rooflines and the breakdown from the profiled frames."""
    t = time.perf_counter()
    events = w.device.events()
    busy = tr.busy_intervals(events, w.device.t0, w.device.t1)
    w.busy_s = sum(b - a for a, b in busy)
    by_name: dict = {}
    for nm, a, b in events:
        by_name[nm] = by_name.get(nm, 0.0) + (b - a)
    for kind, symbol, calls in (("fast_nms", tr.FAST_KERNEL, capture["fast"]),
                                ("gather_patches", tr.GATHER_KERNEL, capture["gather"])):
        dev_s = [b - a for nm, a, b in events if symbol in nm]
        if kind == "fast_nms":
            bound = sum(tr.bound_s(*tr.fast_work(lv, th)) for lv, th in calls)
        else:
            bound = sum(tr.bound_s(tr.gather_bytes(jobs), 0) for jobs in calls)
        w.kernels[kind] = (bound, sum(dev_s), len(calls), len(dev_s))
        log(f"kernel {kind}: {len(calls)} calls, {len(dev_s)} launches traced, "
            f"bound {1e3 * bound:.4f} ms, device {1e3 * sum(dev_s):.4f} ms")
    in_window = [s for s in w.spans.items if s[3] in set(w.frames)]
    idle = tr.idle_by_span(busy, w.device.t0, w.device.t1, in_window)
    log(f"profiled {len(events)} device operations over {w.device.t1 - w.device.t0:.3f} s, "
        f"busy {w.busy_s:.4f} s; reduced in {time.perf_counter() - t:.1f} s")
    return {"device_ops": tr.top({k[:120]: v for k, v in by_name.items()}),
            "idle_gaps": tr.top(idle)}


class _SyncCount:
    """Counts the host syncs ``torch.cuda.set_sync_debug_mode("warn")``
    reports (the idea of ``chip_smoke._SyncCounter``, without its sites)."""

    def __enter__(self):
        import warnings

        import torch

        self.n = 0
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")

        def show(message, *args, **kwargs):
            if "called a synchronizing" in str(message):
                self.n += 1

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
