"""Median host ms of a keyframe's place-recognition registration
(``StereoSlam._register_keyframe``: its BoW row from the vocabulary file,
the keyframe database row, the loop detection it dispatches), from the
benchmark's span around the call."""

import statistics


def read(w):
    if w.spans is None:
        return None
    ms = [1e3 * (b - a) for name, a, b, f in w.spans.items if name == "register" and f in w.hand]
    return statistics.median(ms) if ms else None
