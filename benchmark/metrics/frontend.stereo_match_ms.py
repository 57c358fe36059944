"""Median host ms a frame of the stereo front end's matching of the two
eyes (the pyramids' atlases, the Hamming match along the rows and the SAD
refinement, ``ops/stereo.py::stereo_match``), from the program's span
``frontend.stereo_match`` inside ``frontend.process``."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    return None if pt is None else pt.median_ms("frontend.stereo_match")
