"""Median over the window's frames of the host ms from the SLAM engine's
step returning (``StereoSlam.process`` or ``process_rgbd`` inside
``Selflocalization.track``) to the frame's Geolocation reaching the
benchmark's sink: what the service layer (``FramePublisher``'s fetch,
deferral and send) adds to the latency of a published pose."""

import statistics


def read(w):
    if w.spans is None:
        return None
    step_end = {f: b for name, a, b, f in w.spans.items if name == "slam"}
    waits = [1e3 * (w.sent[f] - step_end[f]) for f in w.frames if f in w.sent and f in step_end]
    return statistics.median(waits) if waits else None
