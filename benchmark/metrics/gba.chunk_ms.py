"""Median host ms of one chunk of the post-loop global BA (one LM
iteration of ``IncrementalGBA.step``, run between frames after a loop
closes), over the window's frames that run one, from the program's span
``gba.chunk``."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    return None if pt is None else pt.median_ms("gba.chunk")
