"""The reader of ``slam.mapping_graph_share``
(``benchmark/metrics/slam.mapping_graph_share.py``) on a recorded window:
the counts of three frames, one of the warm-up before them and one between
two frames, which no frame holds.  It reads 100 graphed / (graphed +
eager + captured) over the frames, and None on a window whose program
counts no mapping stage, as the parent commit's does."""

import _tiny  # noqa: F401  (the benchmark's packages on the path)
from harness import cell, program_trace, spec

from opendlv_perception_vision_orbslam2_tpu_torch.utils import trace

NAME = "slam.mapping_graph_share"


def _window(counts):
    """A window of frames 10, 11, 12 handed at 1, 2, 3 s, each returned 0.9
    s later, holding ``counts`` ``(name, t s, n)``."""
    w = cell.Window()
    w.frames = [10, 11, 12]
    w.hand = {10: 1.0, 11: 2.0, 12: 3.0}
    w.returned = {10: 1.9, 11: 2.9, 12: 3.9}
    w.t0, w.t1 = 1.0, 4.0
    records = [(trace.Count(n, int(t * 1e9), k), False) for n, t, k in counts]
    program_trace._CACHE[w] = program_trace.ProgramTrace(w, records)
    return w


def test_the_share_counts_graphed_over_all_stages_in_the_window():
    w = _window([
        ("mapping.eager", 1.2, 1), ("mapping.graph_capture", 2.3, 1),
        ("mapping.graphed", 3.4, 1), ("mapping.graphed", 3.6, 1), ("mapping.graphed", 3.7, 1),
        ("slam.decision_sync", 3.1, 1),
        # the warm-up's and one between frames: read by none
        ("mapping.eager", 0.5, 1), ("mapping.graph_capture", 1.95, 1),
    ])
    assert abs(spec.metric_reader(NAME)(w) - 60.0) < 1e-9


def test_a_program_without_the_counters_reads_none():
    w = _window([("pose.solve_graphed", 1.1, 1), ("slam.decision_deferred", 2.1, 1)])
    assert spec.metric_reader(NAME)(w) is None


def test_the_metric_is_listed_for_both_cells():
    by_name = {m["name"]: m for m in spec.load()["per_layer"]}
    m = by_name[NAME]
    assert m["workloads"] == ["tum1-rgbd.explore", "kitti00-stereo.revisit"]
    assert m["moves"] == "pose_ms_p90" and m["unit"] == "%"
    assert m["source"] == "program_counter" and m["layer"] == "keyframe insert and mapping"
