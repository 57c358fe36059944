"""Median over the window's frames of the host ms of the tracking step's
local-map window and search (``_local_point_window``,
``_search_local_points``), from the program's own span
``slam.track.local_map``."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    return None if pt is None else pt.median_ms("slam.track.local_map")
