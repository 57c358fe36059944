"""Median over the window's frames of the host ms of the tracking step's
motion-model match (``models/slam.py::track_frame_with_map``'s first stage,
``_motion_model_match``), from the program's own span
``slam.track.motion_match``."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    return None if pt is None else pt.median_ms("slam.track.motion_match")
