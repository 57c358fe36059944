"""Median over the window's frames of the host ms of the tracking step's
second pose solve (``pose_optimize`` or the sharded solver, the outlier
drop, the found counts and the keyframe decision's statistics), from the
program's own span ``slam.track.second_solve``."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    return None if pt is None else pt.median_ms("slam.track.second_solve")
