"""Median over the window's frames of the host ms of the tracking step's
first pose solve (``robust_pose_estimate``: EPnP-RANSAC, then Gauss-Newton,
and the bindings inherited through the match), from the program's own span
``slam.track.first_solve``."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    return None if pt is None else pt.median_ms("slam.track.first_solve")
