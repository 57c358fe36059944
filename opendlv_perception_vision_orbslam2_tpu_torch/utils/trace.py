"""The program's own spans and counters, always on.

A span is ``(name, start_ns, end_ns)``, a count ``(name, t_ns, n)``, both
stamped with ``time.perf_counter_ns()``: the host clock onto which a
``torch.profiler`` trace of the card can be laid (kineto stamps device
activity in wall-clock ns; ``time.time_ns() - time.perf_counter_ns()``
taken once maps one onto the other).  Records go into one ring of
``RING_SIZE``; the oldest is dropped first, so after an overrun the last
few thousand frames are there to read.

Recording adds no device sync, CUDA event or profiler annotation: a span
costs two clock reads, a tuple and a ring append: a microsecond or two of
host time.  A layer writes the process's recorder through the module's functions::

    from ..utils import trace

    @trace.traced("slam.insert")          # every call a span
    def insert_stage(...): ...

    with trace.span("slam.track.local_map"):
        ...
    trace.count("slam.decision_sync")

and a reader takes ``trace.records(since_ns=t0)``.
"""

from __future__ import annotations

import functools
import time
from collections import deque
from typing import NamedTuple

RING_SIZE = 1 << 16

_clock = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int


class _Open:
    """The context of one span; ``seconds`` reads its length once closed."""

    __slots__ = ("_ring", "name", "start_ns", "end_ns")

    def __init__(self, ring: deque, name: str):
        self._ring = ring
        self.name = name

    def __enter__(self):
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        self._ring.append(Span(self.name, self.start_ns, self.end_ns))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """A bounded ring of spans and counts."""

    def __init__(self, size: int = RING_SIZE):
        self._ring: deque = deque(maxlen=size)

    def span(self, name: str) -> _Open:
        """``with rec.span(name) as s:`` records the block as a span (also
        when it raises); ``s.seconds`` is its length."""
        return _Open(self._ring, name)

    def traced(self, name: str):
        """A decorator: every call of the function is a span ``name``."""
        def wrap(fn):
            @functools.wraps(fn)
            def spanned(*args, **kwargs):
                with _Open(self._ring, name):
                    return fn(*args, **kwargs)
            return spanned
        return wrap

    def count(self, name: str, n: int = 1) -> None:
        self._ring.append(Count(name, _clock(), n))

    def records(self, since_ns: int | None = None) -> list:
        """The records, oldest first by the time each was closed, that
        start at ``since_ns`` or later (all of them without it)."""
        out = list(self._ring)
        if since_ns is None:
            return out
        return [r for r in out if r[1] >= since_ns]


#: the process's recorder, which the program's layers write
RECORDER = Recorder()
span = RECORDER.span
traced = RECORDER.traced
count = RECORDER.count
records = RECORDER.records
