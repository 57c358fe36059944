"""The port's recorder (``utils/trace.py``) and the spans and counters the
program writes into it, on the CPU.

- The ring keeps the newest ``RING_SIZE`` records and stamps them with
  ``time.perf_counter_ns``; a span is recorded when its block raises too.
- Over a 20-frame RGB-D drive through ``Selflocalization`` (512x256, 600
  features, a keyframe every few frames, so that the engine passes 5
  keyframes and defers some decisions): every tracked frame has one
  ``slam.track`` inside its ``service.track`` and one ``frontend.process``
  before it; the four ``slam.track.*`` stages lie inside it, in order, and
  take at least 95 % of it; keyframe frames have ``slam.insert``, and the
  stage's ``place.register`` follows in that frame, the next or the
  shutdown; one
  decision counter a tracked frame, ``slam.decision_deferred`` exactly when
  the engine's pipeline is healthy, each with its ``slam.decision_wait``;
  one ``service.send`` a Geolocation; fps.txt's latencies are the
  ``service.track`` spans' lengths.
- A stereo frame's front end holds one ``frontend.stereo_match`` inside its
  ``frontend.process``.
- Loop closing and the post-loop GBA, called directly on
  ``tests/test_torch_cuda.py``'s ring (the synchronous closer over its
  keyframes, then the engine's verdict and GBA on the closure): a
  ``loop.detect`` span at each dispatch and each harvest, one
  ``loop.nominated.<channel>`` count a nomination (``bow`` or ``geo``), a
  ``loop.verify`` span and a ``loop.verified`` count a verification, and
  ``loop.closed`` once, for the closure; the engine dispatches the
  correction, a ``loop.correct`` span, after the valid verdict's
  verification, and its harvest is a ``loop.apply`` span holding its two
  counts; each chunk of
  the GBA a ``gba.chunk`` span and its merge one ``gba.merge``.
"""

import time

import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as tsel
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic as tsyn
from opendlv_perception_vision_orbslam2_tpu_torch.utils import trace
from opendlv_perception_vision_orbslam2_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256, fps=10.0)
ORB = dict(n_features=600, max_keypoints=1024, n_levels=4)
N_FRAMES = 20
STAGES = ("slam.track.motion_match", "slam.track.first_solve", "slam.track.local_map",
          "slam.track.second_solve")


class Sink:
    def __init__(self):
        self.sent = []

    def send(self, message, timestamp=None, sender_stamp=0):
        self.sent.append(message)

    def close(self):
        pass


def test_ring_keeps_the_newest_records():
    assert trace.RING_SIZE == 1 << 16
    assert trace.RECORDER._ring.maxlen == trace.RING_SIZE
    rec = trace.Recorder()
    for k in range(trace.RING_SIZE + 5):
        rec.count("c", k)
    out = rec.records()
    assert len(out) == trace.RING_SIZE
    assert [r.n for r in out[:2]] == [5, 6] and out[-1].n == trace.RING_SIZE + 4
    small = trace.Recorder(size=3)
    for k in range(7):
        small.count("c", k)
    assert [r.n for r in small.records()] == [4, 5, 6]


def test_records_are_stamped_by_perf_counter_ns():
    rec = trace.Recorder()
    t0 = time.perf_counter_ns()
    with rec.span("a") as s:
        rec.count("c", 3)
    t1 = time.perf_counter_ns()
    c, a = rec.records()
    assert isinstance(a, trace.Span) and isinstance(c, trace.Count)
    assert a.name == "a" and t0 <= a.start_ns <= c.t_ns <= a.end_ns <= t1
    assert (c.name, c.n) == ("c", 3)
    assert s.seconds == (a.end_ns - a.start_ns) / 1e9
    with pytest.raises(ValueError):
        with rec.span("raises"):
            raise ValueError
    assert rec.records()[-1].name == "raises"
    assert [r.name for r in rec.records(since_ns=t1)] == ["raises"]

    @rec.traced("fn")
    def fn(x):
        """doc"""
        return x + 1

    assert fn(1) == 2 and fn.__name__ == "fn" and fn.__doc__ == "doc"
    assert rec.records()[-1].name == "fn"


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """``Selflocalization`` over the drive: each frame's ``(start, end)`` on
    the recorder's clock, whether the engine's pipeline was healthy and its
    keyframe count after it; the records of the drive and its shutdown; the
    latencies and the dump directory."""
    cfg = tconfig.SystemConfig(
        camera=tconfig.CameraConfig(**CAM), orb=tconfig.OrbConfig(**ORB),
        tracking=tconfig.TrackingConfig(max_frames=1, th_depth=35.0, depth_map_factor=1.0),
        camera_type="rgbd", max_keyframes=32, max_map_points=16384)
    grays, depths, _, _ = tsyn.render_rgbd_sequence(cfg, n_frames=N_FRAMES, n_points=900,
                                                    seed=5, step=0.6)
    sink = Sink()
    sel = tsel.Selflocalization(cfg, od4=sink, device="cpu")
    t_start = time.perf_counter_ns()
    frames = []
    for i in range(N_FRAMES):
        a = time.perf_counter_ns()
        sel.track(grays[i], depths[i], i * 0.1)
        b = time.perf_counter_ns()
        frames.append({"start": a, "end": b, "healthy": sel.slam._pipeline_healthy,
                       "kfs": sel.slam.n_keyframes, "lost": sel.slam.lost})
    out = tmp_path_factory.mktemp("dumps")
    sel.shutdown(str(out))
    records = trace.records(since_ns=t_start)
    for f in frames:
        f["records"] = [r for r in records if f["start"] <= r[1] and _end(r) <= f["end"]]
    return {"frames": frames, "records": records, "latencies": list(sel.latencies),
            "dir": out, "map_sizes": list(sel.map_sizes), "sink": sink, "sel": sel}


def _end(r):
    return r.end_ns if isinstance(r, trace.Span) else r.t_ns


def _spans(f, name):
    return [r for r in f["records"] if isinstance(r, trace.Span) and r.name == name]


def _counts(f, name):
    return [r for r in f["records"] if isinstance(r, trace.Count) and r.name == name]


def test_the_drive_defers_some_decisions_and_makes_keyframes(drive):
    frames = drive["frames"]
    assert not any(f["lost"] for f in frames)
    healthy = [f["healthy"] for f in frames[1:]]
    assert any(healthy) and not all(healthy)
    assert frames[-1]["kfs"] >= 6


def test_every_tracked_frame_has_one_track_span_inside_its_service_span(drive):
    for k, f in enumerate(drive["frames"]):
        (svc,) = _spans(f, "service.track")
        tracks = _spans(f, "slam.track")
        assert len(tracks) == (0 if k == 0 else 1), k
        (front,) = _spans(f, "frontend.process")
        assert svc.start_ns <= front.start_ns <= front.end_ns <= svc.end_ns
        for t in tracks:
            assert svc.start_ns <= front.end_ns <= t.start_ns <= t.end_ns <= svc.end_ns


def test_the_four_stages_tile_the_track_span_in_order(drive):
    for f in drive["frames"][1:]:
        (t,) = _spans(f, "slam.track")
        stages = [_spans(f, name) for name in STAGES]
        assert all(len(s) == 1 for s in stages)
        prev = t.start_ns
        for (s,) in stages:
            assert prev <= s.start_ns <= s.end_ns <= t.end_ns
            prev = s.end_ns
        covered = sum(s.end_ns - s.start_ns for (s,) in stages)
        assert covered >= 0.95 * (t.end_ns - t.start_ns)


def test_keyframe_frames_insert_and_register(drive):
    frames = drive["frames"]
    kf_frames = [k for k in range(N_FRAMES)
                 if frames[k]["kfs"] > (frames[k - 1]["kfs"] if k else 0)]
    assert len(kf_frames) >= 5
    after = {"records": [r for r in drive["records"] if r[1] > frames[-1]["end"]]}
    for k in kf_frames:
        assert _spans(frames[k], "slam.insert"), k
        # the stage is adopted at once, at the next frame's start, or at shutdown
        later = frames[k + 1] if k + 1 < N_FRAMES else after
        assert _spans(frames[k], "place.register") or _spans(later, "place.register"), k
    # every keyframe is mapped and registered once; a keyframe queued behind
    # an in-flight stage is inserted again onto the settled map
    n_kf = drive["sel"].slam.n_keyframes
    recs = drive["records"]
    n = {name: sum(isinstance(r, trace.Span) and r.name == name for r in recs)
         for name in ("slam.insert", "slam.mapping", "place.register")}
    assert n["slam.mapping"] == n["place.register"] == n_kf <= n["slam.insert"]


def test_decision_counters_follow_the_path_step_takes(drive):
    n_sync = n_deferred = 0
    for f in drive["frames"][1:]:
        sync, deferred = _counts(f, "slam.decision_sync"), _counts(f, "slam.decision_deferred")
        assert len(sync) + len(deferred) == 1
        assert bool(deferred) == f["healthy"]
        waits = _spans(f, "slam.decision_wait")
        (track,) = _spans(f, "slam.track")
        if sync:
            assert len(waits) == 1 and waits[0].start_ns >= track.end_ns
        assert len(waits) <= 1
        n_sync += len(sync)
        n_deferred += len(deferred)
    assert n_sync + n_deferred == N_FRAMES - 1 and n_sync and n_deferred


def test_each_tracked_frame_solves_its_two_poses_eagerly_on_the_cpu(drive):
    """The first and second solves inside ``slam.track`` count one
    ``pose.solve_eager`` each; a CPU run captures and replays no graph."""
    for f in drive["frames"][1:]:
        (track,) = _spans(f, "slam.track")
        solves = _counts(f, "pose.solve_eager")
        assert len(solves) == 2
        assert all(track.start_ns <= c.t_ns <= track.end_ns for c in solves)
    for name in ("pose.solve_graphed", "pose.graph_capture"):
        assert not any(isinstance(r, trace.Count) and r.name == name for r in drive["records"])


def test_each_mapping_stage_runs_eagerly_on_the_cpu(drive):
    """Every ``slam.mapping`` span holds one ``mapping.eager`` count; a CPU
    run captures and replays no graph of the stage."""
    recs = drive["records"]
    stages = [r for r in recs if isinstance(r, trace.Span) and r.name == "slam.mapping"]
    eager = [r for r in recs if isinstance(r, trace.Count) and r.name == "mapping.eager"]
    assert len(stages) == len(eager) >= 5
    for s in stages:
        assert sum(s.start_ns <= c.t_ns <= s.end_ns for c in eager) == 1
    for name in ("mapping.graphed", "mapping.graph_capture"):
        assert not any(isinstance(r, trace.Count) and r.name == name for r in recs)


class _FakeStageGraph:
    """Stands in for ``slam._StageGraph`` on the CPU: notes each capture and
    returns its own outputs on each replay."""

    made = []

    def __init__(self, m, slot, config, flags):
        self.key = flags
        _FakeStageGraph.made.append(flags)

    def __call__(self, m, slot):
        return m, torch.zeros(3, dtype=torch.int32)


def test_the_mapping_graph_cache_counts_eager_capture_and_replay(monkeypatch):
    """``slam._replay_stage``'s bookkeeping, with a stand-in for the
    capture: a key's first call runs eagerly (``mapping.eager``), its second
    captures and replays (``mapping.graph_capture``), later ones replay
    (``mapping.graphed``); each call counts once, each key is captured once, the cache keeps the
    ``MAPPING_GRAPH_CACHE_SIZE`` most recently used, and a key dropped from
    it starts again with an eager call."""
    from collections import OrderedDict

    from opendlv_perception_vision_orbslam2_tpu_torch.models import map_state
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as tslam

    monkeypatch.setattr(tslam, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(tslam, "_SEEN", OrderedDict())
    monkeypatch.setattr(tslam, "_StageGraph", _FakeStageGraph)
    monkeypatch.setattr(tslam, "_mapping_stage_eager",
                        lambda m, slot, config, *flags: (m, torch.ones(3, dtype=torch.int32)))
    _FakeStageGraph.made = []
    cfg = tconfig.SystemConfig()
    m = map_state.empty_map(4, 8, 2)
    slot = torch.zeros((), dtype=torch.int64)
    n = tslam.MAPPING_GRAPH_CACHE_SIZE
    keys = [tuple(bool(k >> b & 1) for b in range(4)) for k in range(n + 1)]

    def counted(flags):
        t0 = time.perf_counter_ns()
        _, aux = tslam._replay_stage(m, slot, cfg, flags)
        got = sorted(r.name for r in trace.records(since_ns=t0) if isinstance(r, trace.Count))
        return got, int(aux[0])

    assert counted(keys[0]) == (["mapping.eager"], 1)
    assert counted(keys[0]) == (["mapping.graph_capture"], 0)
    assert counted(keys[0]) == (["mapping.graphed"], 0)
    assert _FakeStageGraph.made == [keys[0]]
    # another capacity is another key
    _, aux = tslam._replay_stage(map_state.empty_map(8, 8, 2), slot, cfg, keys[0])
    assert int(aux[0]) == 1 and len(tslam._GRAPHS) == 1
    for k in keys[1:]:
        counted(k)
        counted(k)
    assert len(tslam._GRAPHS) == n and len(tslam._SEEN) <= n
    assert _FakeStageGraph.made == keys
    # keys[0], the least recently used, was dropped: eager, then captured again
    assert keys[0] not in {key[2] for key in tslam._GRAPHS}
    assert counted(keys[0]) == (["mapping.eager"], 1)
    assert counted(keys[0]) == (["mapping.graph_capture"], 0)
    assert len(tslam._GRAPHS) == n


def test_one_send_span_a_geolocation_and_a_flush_at_shutdown(drive):
    recs = drive["records"]
    sends = [r for r in recs if isinstance(r, trace.Span) and r.name == "service.send"]
    geo = [m for m in drive["sink"].sent if isinstance(m, tsel.Geolocation)]
    assert len(sends) == len(geo) == N_FRAMES
    assert sum(isinstance(r, trace.Span) and r.name == "service.flush" for r in recs) == 1


def test_fps_txt_latencies_are_the_service_track_spans(drive):
    spans = [s for f in drive["frames"] for s in _spans(f, "service.track")]
    assert drive["latencies"] == [(s.end_ns - s.start_ns) / 1e9 for s in spans]
    want = drive["dir"] / "want.txt"
    ttraj.write_fps_file(str(want), drive["latencies"], drive["map_sizes"])
    assert (drive["dir"] / "fps.txt").read_bytes() == want.read_bytes()
    assert len(np.unique(drive["latencies"])) > 1


def _named(records, kind, name):
    return [r for r in records if isinstance(r, kind) and r.name == name]


def test_a_stereo_frame_matches_its_eyes_inside_the_front_end():
    from opendlv_perception_vision_orbslam2_tpu_torch.models.frontend import process_stereo

    cfg = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM), orb=tconfig.OrbConfig(**ORB))
    lefts, rights, _, _ = tsyn.render_stereo_sequence(cfg, n_frames=1, n_points=900, seed=5)
    t0 = time.perf_counter_ns()
    process_stereo(torch.from_numpy(lefts[0]).float(), torch.from_numpy(rights[0]).float(), cfg)
    recs = trace.records(since_ns=t0)
    (front,) = _named(recs, trace.Span, "frontend.process")
    (match,) = _named(recs, trace.Span, "frontend.stereo_match")
    assert front.start_ns <= match.start_ns <= match.end_ns <= front.end_ns


@pytest.fixture(scope="module")
def loop_records():
    """The records of the ring's synchronous closer and of the engine's
    verdict and GBA on its closure, with the closer's detections."""
    import test_torch_cuda as card

    from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing as lc

    dets, harvest = [], lc.LoopCloser.harvest_detect

    def keep(self, pending):
        dets.append(harvest(self, pending))
        return dets[-1]

    t0 = time.perf_counter_ns()
    lc.LoopCloser.harvest_detect = keep
    try:
        c = card.ring_closure()
    finally:
        lc.LoopCloser.harvest_detect = harvest
    t1 = time.perf_counter_ns()
    slam = card.port_engine(c)
    slam._dispatch_verify(c["det"])
    slam._try_harvest_loop(force=True)
    gba = slam.pending_gba
    while slam.pending_gba is not None:
        slam._service_gba()
    return {"closer": trace.records(since_ns=t0), "engine": trace.records(since_ns=t1),
            "t1": t1, "dets": dets, "gba": gba, "loops": slam.loops_closed}


def test_the_closer_records_detection_nomination_and_verification(loop_records):
    recs = [r for r in loop_records["closer"] if r[1] < loop_records["t1"]]
    dets = loop_records["dets"]
    nominated = [d for d in dets if d is not None]
    # each keyframe's dispatch and harvest (the cooldown skips none: the
    # ring's closer starts 100 keyframes after its last loop)
    assert len(_named(recs, trace.Span, "loop.detect")) == 2 * len(dets)
    n_bow = len(_named(recs, trace.Count, "loop.nominated.bow"))
    n_geo = len(_named(recs, trace.Count, "loop.nominated.geo"))
    assert n_bow + n_geo == len(nominated) >= 1
    verifies = _named(recs, trace.Span, "loop.verify")
    assert len(verifies) == len(_named(recs, trace.Count, "loop.verified")) == len(nominated)
    (closed,) = _named(recs, trace.Count, "loop.closed")
    assert verifies[-1].end_ns <= closed.t_ns


def test_the_engine_records_the_verdict_and_each_gba_chunk(loop_records):
    recs = loop_records["engine"]
    assert loop_records["loops"] == 1
    (verify,) = _named(recs, trace.Span, "loop.verify")
    (correct,) = _named(recs, trace.Span, "loop.correct")
    (apply,) = _named(recs, trace.Span, "loop.apply")
    assert verify.end_ns <= correct.start_ns and correct.end_ns <= apply.start_ns
    for name in ("loop.verified", "loop.closed"):
        (c,) = _named(recs, trace.Count, name)
        assert apply.start_ns <= c.t_ns <= apply.end_ns
    chunks = _named(recs, trace.Span, "gba.chunk")
    (merge,) = _named(recs, trace.Span, "gba.merge")
    assert len(chunks) == 10 and loop_records["gba"].iters_left == 0
    assert apply.end_ns <= chunks[0].start_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(chunks, chunks[1:]))
    assert chunks[-1].end_ns <= merge.start_ns
