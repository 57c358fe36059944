"""The program's own spans and counters, read in the benchmark's process
after the window.

The port records them itself (``opendlv_perception_vision_orbslam2_tpu_torch/
utils/trace.py``): spans ``(name, start_ns, end_ns)`` and counts ``(name,
t_ns, n)`` on ``time.perf_counter_ns``, the clock of the benchmark's own
spans and of the mapping that ``trace.DeviceWindow`` makes of the device
trace.  Here:

1. each record goes to the window frame whose ``[w.hand[f], w.returned[f]]``
   holds it; the warm-up's records and those between frames go to none;
2. in a traced run on the card, the profiled frames' device operations are
   laid onto the program's spans: the device's idle time goes to the
   innermost program span open at the time, and each operation goes to the
   spans open when the host launched it, through the CUDA runtime's launch
   record that carries the operation's correlation id;
3. one line on standard error: idle seconds by program span, launches and
   device ms a profiled frame for each ``slam.track.*`` stage, the slowest
   window frame's spans, and the window's last frame and what followed it
   up to the window's close (the publisher's flush);
4. all of it once per ``Window``.

A program without the recorder reads as None, and so does every metric
that reads it.
"""

from __future__ import annotations

import bisect
import statistics
import weakref
from collections import defaultdict

from . import trace as tr
from .cell import log

TRACK = "slam.track"
STAGES = ("slam.track.motion_match", "slam.track.first_solve", "slam.track.local_map",
          "slam.track.second_solve")

_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _program_records():
    """The program's records as ``(record, is a span)``, or None where it
    has no recorder."""
    try:
        from opendlv_perception_vision_orbslam2_tpu_torch.utils import trace as recorder
    except ImportError:
        return None
    return [(r, isinstance(r, recorder.Span)) for r in recorder.records()]


class ProgramTrace:
    """What the program recorded in a window, by frame, in seconds on the
    host clock."""

    def __init__(self, w, records):
        order = sorted(w.frames, key=lambda f: w.hand[f])
        hands = [w.hand[f] for f in order]
        last = w.returned[order[-1]] if order else w.t1
        #: frame -> [(name, start, end)] and frame -> [(name, t, n)]
        self.spans: dict = defaultdict(list)
        self.counts: dict = defaultdict(list)
        #: spans after the window's last frame, up to its close (the flush)
        self.tail: list = []
        for r, is_span in records:
            a = r[1] / 1e9
            b = r[2] / 1e9 if is_span else a
            if is_span and last <= a and b <= w.t1:
                self.tail.append((r[0], a, b))
            k = bisect.bisect_right(hands, a) - 1
            if k < 0 or b > w.returned[order[k]]:
                continue
            if is_span:
                self.spans[order[k]].append((r[0], a, b))
            else:
                self.counts[order[k]].append((r[0], a, r[2]))
        self.frames = order
        self.idle: dict | None = None       # span name -> device idle seconds
        #: profiled frame -> span name -> (launches, device seconds)
        self.launched: dict | None = None
        self.launch_note = "no device trace"

    def span_s(self, f, name: str) -> float | None:
        """Seconds in spans ``name`` in frame ``f``; None where it has none."""
        ds = [b - a for n, a, b in self.spans.get(f, ()) if n == name]
        return sum(ds) if ds else None

    def median_ms(self, name: str) -> float | None:
        """Median over the window frames that have span ``name``."""
        ms = [1e3 * s for f in self.frames if (s := self.span_s(f, name)) is not None]
        return statistics.median(ms) if ms else None

    def total_s(self, name: str) -> float:
        return sum(b - a for f in self.frames for n, a, b in self.spans.get(f, ()) if n == name)

    def total_count(self, name: str) -> int:
        return sum(k for f in self.frames for n, _, k in self.counts.get(f, ()) if n == name)

    def launched_in(self, name: str) -> list:
        """``(launches, device seconds)`` in spans ``name`` of each profiled
        frame that has one."""
        if not self.launched:
            return []
        return [got[name] for got in self.launched.values() if name in got]


def read(w) -> ProgramTrace | None:
    """The window's :class:`ProgramTrace`, made and logged at the first read."""
    if w in _CACHE:
        return _CACHE[w]
    records = _program_records()
    pt = None if records is None else ProgramTrace(w, records)
    if pt is not None and w.device is not None:
        _lay_device(pt, w)
    _CACHE[w] = pt
    if pt is None:
        log("program trace: the program has no recorder")
    else:
        log(_summary(pt, w))
    return pt


def _lay_device(pt: ProgramTrace, w) -> None:
    """Idle time by innermost program span over the profiled window, and
    each profiled frame's launches and device seconds by the spans open at
    each launch."""
    from torch.autograd import DeviceType

    dev = w.device
    t0, t1 = dev.t0, dev.t1
    in_window = [(n, a, b, f) for f in pt.frames for n, a, b in pt.spans.get(f, ())
                 if b > t0 and a < t1]
    busy = tr.busy_intervals(dev.events(), t0, t1)
    pt.idle = tr.idle_by_span(busy, t0, t1, in_window)

    off = dev.wall_minus_host_ns
    ops, launches = [], {}
    try:
        for e in dev.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ops.append((e.correlation_id(), e.duration_ns()))
            elif e.correlation_id():
                launches[e.correlation_id()] = (e.start_ns() - off) / 1e9
    except (AttributeError, RuntimeError) as exc:     # a profiler without correlation ids
        pt.launch_note = f"none: {type(exc).__name__}: {exc}"
        return
    hit = [(launches[c], d / 1e9) for c, d in ops if c in launches]
    pt.launch_note = f"{len(hit)} of {len(ops)} device operations with a launch record"
    if not hit:
        return
    profiled = [f for f in pt.frames if w.hand[f] >= t0 and w.returned[f] <= t1]
    hands = [w.hand[f] for f in profiled]
    got: dict = {f: defaultdict(lambda: [0, 0.0]) for f in profiled}
    for t, d in hit:
        k = bisect.bisect_right(hands, t) - 1
        if k < 0 or t > w.returned[profiled[k]]:
            continue
        f = profiled[k]
        for n, a, b in pt.spans.get(f, ()):
            if a <= t <= b:
                got[f][n][0] += 1
                got[f][n][1] += d
    pt.launched = {f: {n: tuple(v) for n, v in g.items()} for f, g in got.items()}


def _summary(pt: ProgramTrace, w) -> str:
    n = sum(len(pt.spans.get(f, ())) + len(pt.counts.get(f, ())) for f in pt.frames)
    parts = [f"program trace: {n} records in {len(pt.frames)} window frames"]
    stage_ms = [pt.median_ms(s) for s in STAGES]
    track_ms = pt.median_ms(TRACK)
    if track_ms and None not in stage_ms:
        parts.append(f"median ms {TRACK} {track_ms:.2f}, stages "
                     + " / ".join(f"{m:.2f}" for m in stage_ms)
                     + f" (sum {100 * sum(stage_ms) / track_ms:.1f} %)")
    waits = sum(s[0] == "slam.decision_wait" for f in pt.frames for s in pt.spans.get(f, ()))
    parts.append(f"decisions sync {pt.total_count('slam.decision_sync')}, deferred "
                 f"{pt.total_count('slam.decision_deferred')}, {waits} waits for "
                 f"{1e3 * pt.total_s('slam.decision_wait'):.3f} ms")
    if pt.idle is not None:
        parts.append("device idle s by program span: "
                     + ", ".join(f"{k} {v:.4f}" for k, v in tr.top(pt.idle, 12)))
    parts.append(f"launches: {pt.launch_note}")
    if pt.launched:
        rows = []
        for s in (TRACK,) + STAGES:
            got = pt.launched_in(s)
            if got:
                rows.append(f"{s} {statistics.median(k for k, _ in got):g} launches, "
                            f"{1e3 * statistics.median(d for _, d in got):.3f} device ms")
        parts.append("a profiled frame (median of " + str(len(pt.launched)) + "): "
                     + "; ".join(rows))
    if pt.frames:
        f = max(pt.frames, key=lambda f: w.returned[f] - w.hand[f])
        h = w.hand[f]
        spans = sorted(pt.spans.get(f, ()), key=lambda s: s[1])
        parts.append(f"slowest frame {f} ({1e3 * (w.returned[f] - h):.2f} ms): "
                     + ", ".join(f"{n} +{1e3 * (a - h):.2f} {1e3 * (b - a):.2f}"
                                 for n, a, b in spans))
        end = w.returned[pt.frames[-1]]
        parts.append(f"window closed {1e3 * (w.t1 - end):.2f} ms after its last frame "
                     f"({pt.frames[-1]}, {1e3 * (end - w.hand[pt.frames[-1]]):.2f} ms): "
                     + ", ".join(f"{n} {1e3 * (b - a):.2f}" for n, a, b in pt.tail))
    return "; ".join(parts)
