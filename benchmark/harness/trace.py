"""What a traced run (``--trace 1``) records, and the arithmetic that turns
it into per-layer metrics.

- Host spans around the calls into the program's layers, recorded from the
  benchmark's files: no device sync is added.
- ``torch.profiler`` (device activity only) over a fixed count of frames in
  the middle of the window: the device's busy time, the kernels by name, and
  the idle gaps, each named by the innermost host span open at the time.
- The inputs of the two hand-written kernels' calls in those frames, and the
  least time the card could take over them: each kernel's bytes and
  operations over the H100's published rates (a copy of the arithmetic the
  port's card script used, ``chip_smoke.py:268-325``).
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
import torch.nn.functional as F

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FAST+NMS operations: every pixel takes the compass test (4 subtract + 8
# compare) and the 3x3 NMS (8 max + 1 compare); every polarity that passes
# the compass test takes 16 subtract and the 9-arc tree (64 min + 15 max).
FAST_OPS_PER_PIXEL = 21
FAST_OPS_PER_POLARITY = 95
# the compass points of FAST's 16-point circle, (dy, dx)
COMPASS = ((-3, 0), (0, 3), (3, 0), (0, -3))
# kernel symbols of the port's two hand-written CUDA kernels
FAST_KERNEL = "fast_nms_pyramid_kernel"
GATHER_KERNEL = "gather_patches_kernel"


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def compass_test(img, threshold: float):
    """``(bright, dark)``: pixels where at least 2 of the 4 compass points
    differ from the centre by more than ``threshold`` either way, on an
    edge-padded image (FAST's early-out, as the kernel applies it)."""
    img = img.to(torch.float32)
    H, W = img.shape[-2:]
    p = F.pad(img.reshape(-1, 1, H, W), (3, 3, 3, 3), mode="replicate").reshape(
        img.shape[:-2] + (H + 6, W + 6))
    diff = [p[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - img for dy, dx in COMPASS]
    bright = sum((d > threshold).to(torch.int32) for d in diff) >= 2
    dark = sum((-d > threshold).to(torch.int32) for d in diff) >= 2
    return bright, dark


def fast_work(levels, threshold: float):
    """``(bytes, ops)`` of FAST+NMS over ``levels`` (each ``[H, W]`` or
    ``[B, H, W]``): each image read once and each map written once; the
    operations this data needs with the compass early-out."""
    n_bytes = n_ops = 0
    for lv in levels:
        bright, dark = compass_test(lv, threshold)
        n_bytes += 8 * lv.numel()
        n_ops += (FAST_OPS_PER_PIXEL * lv.numel()
                  + FAST_OPS_PER_POLARITY * int(bright.sum() + dark.sum()))
    return n_bytes, n_ops


def gather_bytes(jobs) -> int:
    """Bytes of window gathers ``(img, y0, x0, ph, pw)``: each window
    written once, each image pixel that some (clipped) window covers read
    once, and the int32 starts read once."""
    n_bytes = 0
    for img, y0, x0, ph, pw in jobs:
        H, W = img.shape
        y = torch.clamp(y0.long(), 0, H - ph)
        x = torch.clamp(x0.long(), 0, W - pw)
        corners = torch.zeros((H + 1) * (W + 1), dtype=torch.int64, device=img.device)
        for dy, dx, sign in ((0, 0, 1), (0, pw, -1), (ph, 0, -1), (ph, pw, 1)):
            corners.index_add_(0, (y + dy) * (W + 1) + x + dx, torch.full_like(y, sign))
        cover = corners.view(H + 1, W + 1).cumsum(0).cumsum(1)[:H, :W] > 0
        n_bytes += 4 * int(cover.sum()) + 4 * y0.shape[0] * ph * pw + 8 * y0.shape[0]
    return n_bytes


class Spans:
    """``(name, start, end, frame)`` on the host clock, for every call of the
    wrapped functions; ``frame`` is the index of the frame being tracked."""

    def __init__(self):
        self.items: list = []
        self.frame = -1
        self._saved: list = []

    def wrap(self, owner, attr: str, name: str, note=None) -> None:
        """Replace ``owner.<attr>`` by a version that records a span, and
        ``note(args, out)`` where given."""
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            self.items.append((name, t, time.perf_counter(), self.frame))
            if note is not None:
                note(args, out)
            return out

        self._saved.append((owner, attr, owner.__dict__.get(attr, _MISSING)))
        setattr(owner, attr, timed)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            if fn is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self._saved.clear()

    def add(self, name: str, start: float, end: float) -> None:
        self.items.append((name, start, end, self.frame))


_MISSING = object()


class DeviceWindow:
    """``torch.profiler`` over device activity between :meth:`start` and
    :meth:`stop` (both synchronise), and the host clock's span of it."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        # kineto stamps device activity in wall-clock ns
        self.wall_minus_host_ns = time.time_ns() - time.perf_counter_ns()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def events(self) -> list:
        """``(name, start, end)`` of every device operation, on the host
        clock (seconds)."""
        from torch.autograd import DeviceType

        off = self.wall_minus_host_ns
        return [(e.name(), (e.start_ns() - off) / 1e9, (e.start_ns() + e.duration_ns() - off) / 1e9)
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]


def busy_intervals(events, t0: float, t1: float) -> list:
    """The union of the events' intervals, clipped to ``[t0, t1]``."""
    out = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(busy, t0: float, t1: float, spans) -> dict:
    """Seconds of device idle time in ``[t0, t1]`` by the innermost host
    span open at each idle moment ("outside" where none is)."""
    spans = [(s, e, n) for n, s, e, _ in spans if e > t0 and s < t1]
    edges = sorted({t0, t1, *(max(s, t0) for s, _, _ in spans), *(min(e, t1) for _, e, _ in spans)})
    # the timeline in pieces, each with its innermost (latest started) span
    pieces = []
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2
        open_ = [(s, n) for s, e, n in spans if s <= mid < e]
        pieces.append((a, b, max(open_)[1] if open_ else "outside"))
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    out: dict = defaultdict(float)
    k = 0
    for a, b in gaps:
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            pa, pb, name = pieces[j]
            out[name] += min(b, pb) - max(a, pa)
            j += 1
    return dict(out)


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
