"""One rank a card: the CLI's counterpart of the reference package taking
every local device.

The reference CLI is one process that owns every device of its host:
``StereoSlam`` shards its local-map pose solve and ``IncrementalGBA`` its
post-loop GBA over ``jax.devices()`` by themselves.  A torch process drives
one card, so :class:`LocalRanks` makes the group those modules look for:
rank 0 is the caller's process, which runs the engine; ranks 1..D-1 are
workers started with ``spawn``, one a card, each running
``parallel.serve.serve`` until rank 0 stops it.  Nothing here reaches
another host.

- :func:`plan_ranks` decides the ranks from the device, an optional rank
  count and the visible cards: NCCL one rank a card (a ``cpu:gloo,cuda:nccl``
  group), gloo for ranks on the CPU or for more ranks than cards (NCCL
  refuses two ranks on one card), no group for one rank.  A failure to
  form the NCCL group raises; nothing falls back to gloo.
- Rendezvous: a ``TCPStore`` that rank 0 hosts on a free localhost port.
  The workers wait for rank 0's next op in that store (``serve``), not in a
  collective, so an idle camera of any length outlasts the group's timeout,
  which bounds every data collective.
- Startup costs land before the first frame, not inside it: each worker
  runs one pose solve alone (``serve.warm_up``) before it joins, and NCCL
  builds its communicators when the group forms (``device_id`` and one
  all-gather and one broadcast, the ops' collectives).
- Teardown on every exit path (normal exit, an exception, KeyboardInterrupt,
  SIGTERM): stop the workers, end rank 0's side of the group as they end
  theirs, join them with a deadline, kill any still alive.  A worker exits when its parent dies; a worker
  that dies makes rank 0's next op raise.
"""

from __future__ import annotations

import json
import multiprocessing
import multiprocessing.connection
import os
import signal
import sys
import threading
import time
from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from . import serve
from .collectives import STATS

NCCL = "cpu:gloo,cuda:nccl"     # CUDA tensors over NCCL, the CPU's over gloo
GLOO = "gloo"
#: a data collective that waits longer fails; also the slice in which an idle
#: worker re-arms its wait for rank 0's next op
GROUP_TIMEOUT_S = 120.0
JOIN_TIMEOUT_S = 120.0          # every worker is connected and warmed up by then
STOP_TIMEOUT_S = 20.0           # every worker exits this soon after the stop op
_READY = "launch/ready/"        # + rank: the worker is connected and warmed up
_REPORT = "launch/report/"      # + rank: what the worker did, set before it exits
#: a worker's exit code when its parent died
_EXIT_ORPHANED = 3


class RankPlan(NamedTuple):
    world: int
    backend: str | None          # None: one rank, no group
    devices: tuple               # rank r runs on devices[r]


def plan_ranks(device, ranks, n_cards: int) -> RankPlan:
    """The ranks of a run on ``device`` with ``n_cards`` visible cards.
    ``ranks`` None takes one rank a card on ``cuda`` and one rank on the
    CPU; more ranks than cards share them round robin over gloo."""
    dev = torch.device(device)
    if ranks is not None and ranks < 1:
        raise ValueError(f"ranks must be >= 1, got {ranks}")
    if dev.type != "cuda":
        world = 1 if ranks is None else ranks
        return RankPlan(world, GLOO if world > 1 else None, (dev,) * world)
    world = n_cards if ranks is None else ranks
    if world <= 1:
        return RankPlan(1, None, (dev,))   # without a card the engine raises
    if n_cards < 1:
        raise RuntimeError(f"{world} ranks on cuda: needs a CUDA device")
    return RankPlan(world, NCCL if world <= n_cards else GLOO,
                    tuple(torch.device("cuda", r % n_cards) for r in range(world)))


def describe(plan: RankPlan) -> str:
    """The line a formed group prints: ``D ranks (backend) on devices``."""
    return (f"{plan.world} ranks ({plan.backend}) on "
            + ", ".join(str(d) for d in plan.devices))


def local_ranks(device, ranks=None) -> LocalRanks:
    """:class:`LocalRanks` over the cards this process sees."""
    n_cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    return LocalRanks(plan_ranks(device, ranks, n_cards))


def _worker_threads(world: int) -> int:
    return max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // world))


def _timeout(seconds: float) -> timedelta:
    return timedelta(seconds=seconds)


def _form_group(plan: RankPlan, rank: int, store, timeout_s: float) -> None:
    """Join the default group and run the ops' two collectives once on this
    rank's device, in which NCCL builds its communicator and connects them."""
    dev = plan.devices[rank]
    nccl = {"device_id": dev} if plan.backend == NCCL else {}
    dist.init_process_group(plan.backend, store=store, rank=rank, world_size=plan.world,
                            timeout=_timeout(timeout_s), **nccl)
    x = torch.zeros(1, device=dev)
    dist.all_gather([torch.empty_like(x) for _ in range(plan.world)], x)
    dist.broadcast(x, src=0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _exit_with_parent() -> None:
    multiprocessing.parent_process().join()
    os._exit(_EXIT_ORPHANED)


def _worker(rank: int, plan: RankPlan, port: int, timeout_s: float, threads: int) -> None:
    """Rank ``rank``: serve rank 0's sharded solves, then report and exit."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)     # rank 0 stops the workers
    threading.Thread(target=_exit_with_parent, daemon=True).start()
    dev = plan.devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(threads)
    from ..ops import fast_kernel, gather_kernel

    store = dist.TCPStore("127.0.0.1", port, plan.world, is_master=False,
                          timeout=_timeout(timeout_s))
    serve.warm_up(dev)          # before rank 0 returns to its caller, not inside frame 1
    store.set(f"{_READY}{rank}", b"1")
    _form_group(plan, rank, store, timeout_s)
    served = serve.serve(dev)
    launches = {name: getattr(mod, name).launches
                for mod, names in ((fast_kernel, ("fast_nms", "fast_nms_pyramid")),
                                   (gather_kernel, ("gather_patches", "gather_patches_multi")))
                for name in names}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    store.set(f"{_REPORT}{rank}", json.dumps(
        {"served": served, "ops": serve.OP_STATS, "launches": launches,
         "collectives": dict(STATS), "peak_bytes": peak}))
    dist.destroy_process_group()


def _terminate(signum, frame):
    raise SystemExit(128 + signum)


class LocalRanks:
    """Rank 0's side of a run on ``plan``: ``with LocalRanks(plan) as
    device`` starts the workers and forms the default group (nothing for
    one rank) and yields rank 0's device; leaving the block tears it all
    down.  After it, ``exit_codes`` holds each worker's exit code (a killed
    worker's is negative) and ``reports`` what each said it did: ops served
    (``served``, and by name with their ms, ``ops``: ``serve.OP_STATS``),
    kernel launches, collective calls, peak device memory (``peak_bytes``,
    None on the CPU).  Leaving without an exception raises
    if a worker did not exit 0."""

    def __init__(self, plan: RankPlan):
        self.plan = plan
        self.timeout_s = GROUP_TIMEOUT_S
        self.procs: list = []
        self.exit_codes: list = []
        self.reports: dict = {}
        self._store = None
        self._formed = False
        self._stopping = False
        self._previous = {}          # the SIGTERM handler and excepthook to restore

    def __enter__(self) -> torch.device:
        if self.plan.backend is None:
            return self.plan.devices[0]
        try:
            self._start()
        except BaseException:
            self._teardown(failed=True)
            raise
        return self.plan.devices[0]

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.plan.backend is None:
            return False
        self._teardown(failed=exc_type is not None)
        if exc_type is None and any(code != 0 for code in self.exit_codes):
            raise RuntimeError(f"worker exit codes {self.exit_codes} (0 each wanted)")
        return False

    # ---- start ---------------------------------------------------------------

    def _start(self) -> None:
        plan = self.plan
        if plan.backend == NCCL and not dist.is_nccl_available():
            raise RuntimeError(f"{describe(plan)}: this torch has no NCCL")
        self._store = dist.TCPStore("127.0.0.1", 0, plan.world, is_master=True,
                                    timeout=_timeout(self.timeout_s), wait_for_workers=False)
        ctx = multiprocessing.get_context("spawn")         # fork is unsafe once CUDA or threads run
        threads = _worker_threads(plan.world)
        for r in range(1, plan.world):
            p = ctx.Process(target=_worker, name=f"orbslam2-rank{r}", daemon=True,
                            args=(r, plan, self._store.port, self.timeout_s, threads))
            p.start()
            self.procs.append(p)
        self._await_workers()
        if plan.devices[0].type == "cuda":
            torch.cuda.set_device(plan.devices[0])
        self._previous["excepthook"] = sys.excepthook   # init_process_group replaces it
        _form_group(plan, 0, self._store, self.timeout_s)
        self._formed = True
        threading.Thread(target=self._watch, args=(self._store.port,), daemon=True).start()
        if threading.current_thread() is threading.main_thread():
            self._previous["sigterm"] = signal.signal(signal.SIGTERM, _terminate)
        print(f"opendlv_perception_vision_orbslam2_tpu_torch: {describe(plan)}", flush=True)

    def _await_workers(self) -> None:
        """Until every worker is connected and warmed up; raises if one
        exits first or ``JOIN_TIMEOUT_S`` passes."""
        keys = [f"{_READY}{r}" for r in range(1, self.plan.world)]
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while not self._store.check(keys):
            for r, p in enumerate(self.procs, 1):
                if p.exitcode is not None:
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode} before "
                                       "joining the group")
            if time.monotonic() > deadline:
                raise RuntimeError(f"the workers did not join within {JOIN_TIMEOUT_S} s")
            time.sleep(0.02)

    def _watch(self, port: int) -> None:
        """Wait for the first worker to end; if the run is not stopping,
        record it where rank 0's next op looks (``serve.FAILED_KEY``)."""
        ended = multiprocessing.connection.wait([p.sentinel for p in self.procs])
        if self._stopping:
            return
        dead = [r for r, p in enumerate(self.procs, 1) if p.sentinel in ended]
        try:     # a client of its own: the main thread may be using rank 0's
            store = dist.TCPStore("127.0.0.1", port, self.plan.world, is_master=False,
                                  timeout=_timeout(self.timeout_s))
            store.set(serve.FAILED_KEY, f"worker ranks {dead} ended during the run")
        except dist.DistError:   # the run ended meanwhile and closed the store
            pass

    # ---- teardown ------------------------------------------------------------

    def _teardown(self, failed: bool) -> None:
        self._stopping = True
        try:
            try:
                if self._formed:
                    serve.stop_workers()
                    # while the workers end theirs: NCCL's teardown may wait for
                    # every rank, and a worker inside a collective sees it fail
                    self._end_group(failed)
                    deadline = time.monotonic() + STOP_TIMEOUT_S
                    for p in self.procs:
                        p.join(max(0.0, deadline - time.monotonic()))
            finally:
                for p in self.procs:
                    if p.is_alive():
                        p.kill()
                    p.join()
                self.exit_codes = [p.exitcode for p in self.procs]
            if self._formed:
                self._read_reports()
        finally:
            if "sigterm" in self._previous:
                signal.signal(signal.SIGTERM, self._previous.pop("sigterm"))
            self._end_group(failed)
            if "excepthook" in self._previous:
                sys.excepthook = self._previous.pop("excepthook")
            self._store = None       # closes the rendezvous server

    def _end_group(self, failed: bool) -> None:
        if not dist.is_initialized():
            return
        if failed and self.plan.backend == NCCL:
            dist.distributed_c10d._abort_process_group()   # pending NCCL work may never end
        else:
            dist.destroy_process_group()

    def _read_reports(self) -> None:
        for r in range(1, self.plan.world):
            key = f"{_REPORT}{r}"
            if self._store.check([key]):
                self.reports[r] = json.loads(self._store.get(key))
