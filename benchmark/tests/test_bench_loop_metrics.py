"""The readers of the loop-closing, GBA and stereo-match metrics
(``benchmark/metrics/loop.verify_ms.py``, ``loop.detect_ms.py``,
``gba.chunk_ms.py``, ``frontend.stereo_match_ms.py``) on a recorded window:
three frames with known spans, a span of the warm-up before them and one
between two frames, which no frame holds.  Each reads the median over the
frames that have its span (a frame's spans of one name summed), and None on
a window whose program records none of them, as the parent commit's does."""

import _tiny  # noqa: F401  (the benchmark's packages on the path)
from harness import cell, program_trace, spec

from opendlv_perception_vision_orbslam2_tpu_torch.utils import trace

NEW = ("loop.verify_ms", "loop.detect_ms", "gba.chunk_ms", "frontend.stereo_match_ms")


def _window(spans):
    """A window of frames 10, 11, 12 handed at 1, 2, 3 s, each returned 0.9
    s later, holding ``spans`` ``(name, start s, end s)``."""
    w = cell.Window()
    w.frames = [10, 11, 12]
    w.hand = {10: 1.0, 11: 2.0, 12: 3.0}
    w.returned = {10: 1.9, 11: 2.9, 12: 3.9}
    w.t0, w.t1 = 1.0, 4.0
    records = [(trace.Span(n, int(a * 1e9), int(b * 1e9)), True) for n, a, b in spans]
    program_trace._CACHE[w] = program_trace.ProgramTrace(w, records)
    return w


def test_each_reader_takes_the_median_over_the_frames_that_have_its_span():
    w = _window([
        ("frontend.stereo_match", 1.01, 1.02), ("frontend.stereo_match", 2.01, 2.04),
        ("frontend.stereo_match", 3.01, 3.03),
        # detection: a dispatch and a harvest in frame 10 (sum 30 ms), one in 12
        ("loop.detect", 1.1, 1.11), ("loop.detect", 1.2, 1.22), ("loop.detect", 3.1, 3.15),
        ("loop.verify", 2.1, 2.6),
        ("gba.chunk", 2.7, 2.8), ("gba.chunk", 3.5, 3.62),
        # the warm-up's and one between frames: read by none
        ("loop.verify", 0.1, 0.9), ("gba.chunk", 1.91, 1.99),
    ])
    got = {name: spec.metric_reader(name)(w) for name in NEW}
    want = {"frontend.stereo_match_ms": 20.0, "loop.detect_ms": 40.0, "loop.verify_ms": 500.0,
            "gba.chunk_ms": 110.0}
    for name, v in want.items():
        assert abs(got[name] - v) < 1e-6, (name, got[name])


def test_a_program_without_the_spans_reads_none():
    w = _window([("frontend.process", 1.0, 1.05), ("slam.track", 1.1, 1.2)])
    for name in NEW:
        assert spec.metric_reader(name)(w) is None


def test_the_metrics_are_listed_for_the_revisit_cell_alone():
    bench = spec.load()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = by_name[name]
        assert m["workloads"] == ["kitti00-stereo.revisit"] and m["moves"] == "pose_ms_p90"
        assert m["source"] == "program_span" and m["unit"] == "ms"
