"""Median host ms of loop detection a frame (the dispatch of a keyframe's
BoW and geometric queries, ``LoopCloser.dispatch``, and the host logic over
a landed fetch, ``LoopCloser.harvest_detect``), over the window's frames
that run either, from the program's span ``loop.detect``."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    return None if pt is None else pt.median_ms("loop.detect")
