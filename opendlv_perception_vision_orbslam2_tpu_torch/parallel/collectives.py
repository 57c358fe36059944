"""The collectives of the sharded solves, with counters.

``all_reduce_sum`` takes the place of the ``psum`` in the reference
package's ``parallel/sharded_ba.py`` and ``parallel/sharded_pose.py``:
every rank passes its partial sum and gets the total, the same bits on
every rank.  ``broadcast`` moves rank 0's operands to the workers
(``serve.py``).  ``STATS`` counts the calls of each kind and the host
seconds spent in them; with gloo on CUDA tensors each call stages through
host memory and waits for the device, so each is one host round trip.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

#: calls and host seconds of each kind since the last :func:`reset_stats`
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
    """The sum of every rank's ``x``, on every rank.  Reduces a contiguous
    tensor in place (a non-contiguous one through a copy) and returns it."""
    y = x.contiguous()
    t = time.perf_counter()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    STATS["all_reduce_s"] += time.perf_counter() - t
    STATS["all_reduce"] += 1
    return y


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
