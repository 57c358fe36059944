"""Host ms the SLAM engine waited on its keyframe decision's statistics
(each ``.result()`` of the stats fetch in ``StereoSlam._step``, the
program's span ``slam.decision_wait``), summed over the window, over the
frames handed in it."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    if pt is None or not w.frames:
        return None
    return 1e3 * pt.total_s("slam.decision_wait") / len(w.frames)
