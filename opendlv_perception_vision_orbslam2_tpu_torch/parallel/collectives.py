"""The collectives of the sharded solves, with counters.

``all_reduce_sum`` takes the place of the ``psum`` in the reference
package's ``parallel/sharded_ba.py`` and ``parallel/sharded_pose.py``:
every rank passes its partial sum and gets the total, the same bits on
every rank, added in rank order whatever the backend (an all-gather, then
the sum), so D ranks give the bits of one process adding the D blocks in
that order; NCCL's own all-reduce adds them in an order of its choosing,
which moved the CLI's trajectory on four cards by 12 mm of ATE against such
a process (``chip_smoke.py`` phase 21).  ``broadcast`` moves rank 0's operands to the workers
(``serve.py``).  ``STATS`` counts the calls of each kind and the host
seconds spent in them.  What those seconds are depends on the backend:
under gloo (CPU tensors, or CUDA tensors staged through host memory, which
waits for the device) each call returns when the collective is done, so
they are its round trip; under NCCL a call returns once the collective is
enqueued on the device, so they are the enqueue only, and the collective's
time is a device time (CUDA events around it, as ``chip_smoke.py`` phase
21 takes them).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

#: calls and host seconds of each kind since the last :func:`reset_stats`
#: (host seconds: a round trip under gloo, the enqueue under NCCL)
STATS = {"all_reduce": 0, "broadcast": 0, "all_reduce_s": 0.0, "broadcast_s": 0.0}


def reset_stats():
    STATS.update(all_reduce=0, broadcast=0, all_reduce_s=0.0, broadcast_s=0.0)


def group_active() -> bool:
    """True when the default process group is formed and spans more than
    one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank_and_size(group=None) -> tuple[int, int]:
    """``(rank in group, group size)``; ``(0, 1)`` without a formed group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``, on every rank: rank 0's + rank 1's +
    ... in that order (a new tensor; ``x`` is left as it is)."""
    y = x.contiguous()
    t = time.perf_counter()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    STATS["all_reduce_s"] += time.perf_counter() - t
    STATS["all_reduce"] += 1
    return total


def broadcast(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``x`` into every rank's ``x`` (contiguous, in place), over
    the default group."""
    t = time.perf_counter()
    dist.broadcast(x, src=0)
    STATS["broadcast_s"] += time.perf_counter() - t
    STATS["broadcast"] += 1
    return x


def reducer(group=None):
    """The ``reduce_fn`` of a solve sharded over ``group``."""
    return lambda x: all_reduce_sum(x, group)
