"""Median host ms of a frame's front end (``process_stereo`` or
``process_rgbd`` as ``models/slam.py`` calls it), from the benchmark's span
around the call: the host's time to issue it, with no sync added."""

import statistics


def read(w):
    if w.spans is None:
        return None
    ms = [1e3 * (b - a) for name, a, b, f in w.spans.items if name == "frontend" and f in w.hand]
    return statistics.median(ms) if ms else None
