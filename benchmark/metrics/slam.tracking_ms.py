"""Median host ms of a frame's tracking against the map
(``models/slam.py::track_frame_with_map``), from the benchmark's span around
the call, with no sync added."""

import statistics


def read(w):
    if w.spans is None:
        return None
    ms = [1e3 * (b - a) for name, a, b, f in w.spans.items if name == "tracking" and f in w.hand]
    return statistics.median(ms) if ms else None
