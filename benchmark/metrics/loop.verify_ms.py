"""Median host ms of a loop candidate's Sim3 verification (``verify_loop``,
which ``StereoSlam._dispatch_verify`` calls; a valid verdict's correction
is dispatched later, under ``loop.correct``), over the window's frames that
verify one, from the program's span ``loop.verify``.  None where no
verification ran in the window, or the program records no such span."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    return None if pt is None else pt.median_ms("loop.verify")
