"""The program's own spans and counters as the benchmark reads them
(``harness/program_trace.py``): a traced run of ``tiny.desk`` on the CPU,
with the metrics that read them listed for that cell.  The span- and
counter-read metrics are numbers; the device-trace ones are None and left
out of the line; the window's cut keeps the warm-up's records out."""

import json
import time

import torch

import _tiny
from harness import cell, program_trace, spec

from opendlv_perception_vision_orbslam2_tpu_torch.utils import trace

torch.set_num_threads(2)

NEW = ("track.motion_match_ms", "track.first_solve_ms", "track.local_map_ms",
       "track.second_solve_ms", "track.launches", "slam.decision_wait_ms",
       "slam.sync_decision_share")
SPAN_READ = set(NEW) - {"track.launches"}
WARM = 6        # tiny-rgbd.json's warm-up frames


def test_a_traced_run_reads_the_program_and_cuts_the_warm_up(capsys, monkeypatch):
    bench = _tiny.bench_with_tiny()
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] = m["workloads"] + [_tiny.TINY]
    seen = []
    read = program_trace.read

    def keep(w):
        pt = read(w)
        seen.append((w, pt))
        return pt

    monkeypatch.setattr(program_trace, "read", keep)
    t0 = time.perf_counter_ns()
    rc = cell.run(_tiny.TINY, 2147483659, 20.0, True, time.perf_counter(), device="cpu",
                  bench=bench)
    assert rc == 0
    out = capsys.readouterr()
    r = json.loads(out.out.strip().splitlines()[-1])
    # whether the window is `correct` is test_bench_check.py's; a window of a
    # few frames on a busy CPU may be too short for the scale's check
    assert r["attempted"] >= 1 and r["checks"]["unsent"]["value"] == 0
    got = r["metrics"]
    assert SPAN_READ <= set(got) and "track.launches" not in got
    for name in SPAN_READ:
        assert got[name]["value"] >= 0
    assert 0 <= got["slam.sync_decision_share"]["value"] <= 100
    stages = sum(got[f"track.{s}_ms"]["value"]
                 for s in ("motion_match", "first_solve", "local_map", "second_solve"))
    assert 0.9 * got["slam.tracking_ms"]["value"] <= stages <= 1.1 * got["slam.tracking_ms"]["value"]
    assert out.err.count("program trace: ") == 1

    # one ProgramTrace for the window, read once and kept
    w, pt = seen[0]
    assert all(p is pt for _, p in seen) and len(seen) == len(NEW)
    assert set(pt.spans) <= set(w.frames)
    assert sum(n == "service.track" for f in pt.frames for n, _, _ in pt.spans[f]) == len(w.frames)
    for f in w.frames:
        for _, a, b in pt.spans[f]:
            assert w.hand[f] <= a <= b <= w.returned[f]
    # the run's first records are the warm-up's, and none of them is read
    ran = [r for r in trace.records(since_ns=t0) if r.name == "service.track"]
    assert len(ran) == WARM + len(w.frames)
    assert all(r.end_ns / 1e9 < w.t0 for r in ran[:WARM])
    assert pt.idle is None and pt.launched is None


class _Event:
    """A kineto event as ``_lay_device`` reads it."""

    def __init__(self, on_device, corr, start_s, dur_s):
        from torch.autograd import DeviceType

        self._type = DeviceType.CUDA if on_device else DeviceType.CPU
        self._corr, self._start, self._dur = corr, int(start_s * 1e9), int(dur_s * 1e9)

    def device_type(self):
        return self._type

    def correlation_id(self):
        return self._corr

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


def test_device_operations_go_to_the_spans_that_launched_them():
    """Two frames, each a ``slam.track`` tiled by its four stages; five
    operations a frame launched at known times (one more before the first
    frame, one with no launch record): launches and device seconds by stage,
    idle time by innermost span, and the metric."""
    from types import SimpleNamespace

    stages = [("slam.track.motion_match", 0.1, 0.2), ("slam.track.first_solve", 0.2, 0.5),
              ("slam.track.local_map", 0.5, 0.6), ("slam.track.second_solve", 0.6, 0.8)]
    launch_at = [0.15, 0.3, 0.35, 0.55, 0.7]
    records, kineto, busy = [], [], []
    corr = 1
    for f0 in (1.0, 2.0):
        for name, a, b in [("service.track", 0.0, 0.9), ("slam.track", 0.1, 0.8)] + stages:
            records.append((trace.Span(name, int((f0 + a) * 1e9), int((f0 + b) * 1e9)), True))
        records.append((trace.Count("slam.decision_sync", int((f0 + 0.85) * 1e9), 1), False))
        for t in launch_at:
            # the operation runs 0.05 s after its launch, for 0.01 s
            kineto += [_Event(False, corr, f0 + t, 1e-6),
                       _Event(True, corr, f0 + t + 0.05, 0.01)]
            busy.append(("op", f0 + t + 0.05, f0 + t + 0.06))
            corr += 1
    kineto += [_Event(False, corr, 0.96, 1e-6), _Event(True, corr, 0.97, 0.01),
               _Event(True, 10 ** 6, 1.2, 0.01)]
    dev = SimpleNamespace(t0=0.95, t1=2.95, wall_minus_host_ns=0, events=lambda: busy,
                          prof=SimpleNamespace(profiler=SimpleNamespace(
                              kineto_results=SimpleNamespace(events=lambda: kineto))))
    w = cell.Window()
    w.frames, w.hand, w.returned, w.t1, w.device = [10, 11], {10: 1.0, 11: 2.0}, \
        {10: 1.9, 11: 2.9}, 2.95, dev
    pt = program_trace.ProgramTrace(w, records)
    program_trace._lay_device(pt, w)
    assert pt.launch_note == "11 of 12 device operations with a launch record"
    assert [k for k, _ in pt.launched_in("slam.track")] == [5, 5]
    want = {"slam.track.motion_match": 1, "slam.track.first_solve": 2,
            "slam.track.local_map": 1, "slam.track.second_solve": 1}
    for name, k in want.items():
        for got_k, got_s in pt.launched_in(name):
            assert got_k == k and abs(got_s - 0.01 * k) < 1e-9
    assert abs(sum(pt.idle.values()) + 10 * 0.01 - (2.95 - 0.95)) < 1e-9
    assert pt.idle["outside"] > 0 and pt.idle["slam.track.first_solve"] > 0
    assert pt.total_count("slam.decision_sync") == 2
    assert abs(pt.median_ms("slam.track.first_solve") - 300.0) < 1e-6
    program_trace._CACHE[w] = pt
    assert spec.metric_reader("track.launches")(w) == 5.0
