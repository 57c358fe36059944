"""Host ms of keyframe inserts and mapping stages (``models/slam.py::
insert_stage``, ``mapping_stage``) summed over the window, over the frames
handed in it: what keyframes cost a frame on average."""


def read(w):
    if w.spans is None or not w.frames:
        return None
    s = sum(b - a for name, a, b, f in w.spans.items
            if name in ("insert", "mapping") and f in w.hand)
    return 1e3 * s / len(w.frames)
