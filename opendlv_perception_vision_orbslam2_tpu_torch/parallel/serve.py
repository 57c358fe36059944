"""One engine on rank 0, the other ranks serving its sharded solves.

The torch form of the reference package's production multi-device path,
where one process owns every device, the engine runs once and only the edge
reductions spread over the mesh (``models/slam.py`` and
``models/global_ba.py`` there).  Here rank 0 of the default process group
runs ``StereoSlam`` / ``MonocularSlam``; ranks 1..D-1 call :func:`serve`.
Each sharded solve on rank 0 first posts an op header in the group's store
(a small int64 vector: the op code, sizes, the GBA's CG steps and the
camera's float64 parameters by their bits, one key a worker and op), then
broadcasts its operands; every rank computes its shard and joins the same
all-reduces.  :func:`stop_workers` ends the serve loops.  The engine does
not run a copy per rank: its asynchronous stages are adopted when a CUDA
event has completed, which two processes reach at different frames, so
replicas would make different collective calls and hang the group.

Why the header goes through the store: a worker waits for the next op for
as long as rank 0 has none to send (a parked vehicle's camera pauses for
minutes), and a collective that waits longer than the group's timeout
fails (NCCL's watchdog ends the process).  The store's wait is re-armed
after each of its timeouts (``DistStoreError``), so an idle period of any
length passes, while the data collectives keep the group's bounded timeout.
A worker ended during the run is recorded at ``FAILED_KEY`` (by
``launch.LocalRanks``), and rank 0's next op raises with it.

Launch: ``parallel/launch.py`` (the CLI, one rank a card: NCCL in a
``cpu:gloo,cuda:nccl`` group; gloo on the CPU or with several ranks on one
card), or any code that forms the default group itself, starting ranks with
``spawn``; then rank 0 builds the engine, drives it and calls
``stop_workers()``, and the others call ``serve(device)``.  Everything here
runs on the default group and the reference's schedules (the pose solve's 4
rounds of 10 steps; one LM iteration a GBA chunk, the first pose held).  A
rank that raises exits; the collective the others wait in then fails (the
peer's connection closes) or times out at the group's timeout, so no rank
stays blocked.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..optim.ba import BAProblem
from ..optim.gba import edge_sums, gba_init_carry
from ..optim.pose_opt import PoseObs
from .collectives import broadcast, rank_and_size, reducer
from .sharded_ba import make_sharded_gba_chunk, pad_edges_to_multiple, shard_problem
from .sharded_pose import pad_obs_to_multiple, shard_obs, sharded_pose_solve

OP_STOP, OP_POSE, OP_GBA_INIT, OP_GBA_STEP = 0, 1, 2, 3
_OP_NAMES = {OP_STOP: "stop", OP_POSE: "pose", OP_GBA_INIT: "gba_init",
             OP_GBA_STEP: "gba_step"}
HEADER_LEN = 12
_N_INTS = 6             # header slots 1..6 hold integers, 7..11 the camera's float64 bits
_SEQ_KEY = "serve/seq"          # rank 0's op count
_OP_KEY = "serve/op/{rank}/{seq}"
#: set (to a message) when a worker ended during the run; rank 0's next op raises it
FAILED_KEY = "serve/failed"


def _store():
    """The store the default group was formed with (the rendezvous's own
    keys, where ``launch.LocalRanks`` writes ``FAILED_KEY``)."""
    return dist.distributed_c10d._get_default_store().underlying_store


def _send_header(op: int, ints=(), cam=()):
    rank, world = rank_and_size()
    if rank != 0:
        raise RuntimeError("the engine's sharded solves run on rank 0; the other ranks "
                           "call parallel.serve.serve")
    store = _store()
    if op != OP_STOP and store.check([FAILED_KEY]):
        raise RuntimeError(store.get(FAILED_KEY).decode())
    h = torch.zeros((HEADER_LEN,), dtype=torch.int64)
    h[0] = op
    h[1:1 + len(ints)] = torch.tensor(list(ints), dtype=torch.int64)
    if cam:
        h[1 + _N_INTS:] = torch.tensor(list(cam), dtype=torch.float64).view(torch.int64)
    seq = store.add(_SEQ_KEY, 1) - 1
    for r in range(1, world):
        store.set(_OP_KEY.format(rank=r, seq=seq), h.numpy().tobytes())


def _recv_header(store, rank: int, seq: int):
    """Worker ``rank``'s op number ``seq``, however long rank 0 takes to send
    it."""
    key = _OP_KEY.format(rank=rank, seq=seq)
    while True:
        try:
            store.wait([key])
            break
        except dist.DistStoreError:     # the store's timeout: rank 0 is idle
            continue
    h = torch.frombuffer(bytearray(store.get(key)), dtype=torch.int64)
    store.delete_key(key)
    return int(h[0]), h[1:1 + _N_INTS].tolist(), h[1 + _N_INTS:].view(torch.float64).tolist()


def _camera(fx, fy, cx, cy, bf):
    return (float(fx), float(fy), float(cx), float(cy), float(bf))


# ---- the pose solve ----------------------------------------------------------

_POSE_COLS = 8          # p_w 3, uv 2, u_right, sigma2, valid


def _pack_pose(T0, obs: PoseObs):
    cols = torch.cat([obs.p_w, obs.uv, obs.u_right[:, None], obs.sigma2[:, None],
                      obs.valid[:, None].to(obs.p_w.dtype)], dim=1)
    return torch.cat([T0.reshape(-1), cols.reshape(-1)])


def _unpack_pose(buf, k: int):
    cols = buf[16:].reshape(k, _POSE_COLS)
    return buf[:16].reshape(4, 4), PoseObs(p_w=cols[:, :3], uv=cols[:, 3:5],
                                           u_right=cols[:, 5], sigma2=cols[:, 6],
                                           valid=cols[:, 7] > 0)


def _pose_shard(buf, k: int, cam):
    """Every rank's part of one sharded pose solve of the ``k`` observation
    slots packed in ``buf``: ``(T, inliers [k], n_inliers)``."""
    rank, world = rank_and_size()
    T0, obs = _unpack_pose(buf, k)
    local = shard_obs(pad_obs_to_multiple(obs, world), rank, world)
    T, every, n = sharded_pose_solve(T0, local, cam, reducer(), rank, world)
    return T, every[:k], n


class EnginePoseSolver:
    """The engine's local-map pose solve sharded over the default group's
    ranks (``track_frame_with_map``'s ``pose_solver``): ``fn(T1, obs) -> (T,
    inliers, n_inliers)``, called on rank 0 while the others serve.  Per
    call: a header in the store, one operand broadcast, 40 all-reduces of
    the normal system and one of the inlier mask."""

    def __init__(self, *, fx, fy, cx, cy, bf):
        self.cam = _camera(fx, fy, cx, cy, bf)

    def __call__(self, T0, obs: PoseObs):
        k = obs.valid.shape[0]
        _send_header(OP_POSE, (k,), self.cam)
        return _pose_shard(broadcast(_pack_pose(T0, obs)), k, self.cam)


# ---- the global BA -----------------------------------------------------------

_FLOAT_FIELDS = ("T_opt", "T_fix", "pts", "e_uv", "e_ur", "e_sigma2")
_INT_FIELDS = ("opt_valid", "fix_valid", "pt_valid", "e_kf", "e_pt", "e_valid")


def _field_shapes(Ko: int, n_fix: int, P: int, E: int) -> dict:
    return dict(T_opt=(Ko, 4, 4), T_fix=(n_fix, 4, 4), pts=(P, 3), e_uv=(E, 2), e_ur=(E,),
                e_sigma2=(E,), opt_valid=(Ko,), fix_valid=(n_fix,), pt_valid=(P,), e_kf=(E,),
                e_pt=(E,), e_valid=(E,))


def _unpack_problem(fbuf, ibuf, shapes: dict) -> BAProblem:
    out = {}
    for names, buf in ((_FLOAT_FIELDS, fbuf), (_INT_FIELDS, ibuf)):
        parts = buf.split([math.prod(shapes[f]) for f in names])
        for name, part in zip(names, parts):
            a = part.reshape(shapes[name])
            out[name] = a > 0 if name.endswith("valid") else a
    return BAProblem(**out)


class ShardedGBA:
    """One rank's part of an edge-sharded incremental GBA: its block of the
    padded edges, their summation order and the replicated carry."""

    def __init__(self, prob: BAProblem, cam, cg_iters: int):
        rank, world = rank_and_size()
        self.prob = pad_edges_to_multiple(prob, world)
        self.shard = shard_problem(self.prob, rank, world)
        self.sums = edge_sums(self.shard)     # this rank's summation order, read once
        self.carry = gba_init_carry(self.prob)
        fx, fy, cx, cy, bf = cam
        self._chunk = make_sharded_gba_chunk(None, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf,
                                             cg_iters=cg_iters)

    def step(self):
        self.carry = self._chunk(self.shard, self.carry, self.sums)
        return self.carry


class EngineGBA(ShardedGBA):
    """Rank 0's side: broadcasts the problem once (the workers keep their
    shard and their ``EdgeSums``), then each :meth:`step` sends a header
    only, since the carry is replicated."""

    _next_handle = 0

    def __init__(self, prob: BAProblem, *, fx, fy, cx, cy, bf, cg_iters: int):
        EngineGBA._next_handle += 1
        self.handle = EngineGBA._next_handle
        cam = _camera(fx, fy, cx, cy, bf)
        Ko, n_fix, P, E = (prob.T_opt.shape[0], prob.T_fix.shape[0], prob.pts.shape[0],
                           prob.e_kf.shape[0])
        _send_header(OP_GBA_INIT, (self.handle, Ko, n_fix, P, E, cg_iters), cam)
        broadcast(torch.cat([getattr(prob, f).reshape(-1) for f in _FLOAT_FIELDS]))
        broadcast(torch.cat([getattr(prob, f).reshape(-1).to(torch.int32)
                             for f in _INT_FIELDS]))
        super().__init__(prob, cam, cg_iters)

    def step(self):
        _send_header(OP_GBA_STEP, (self.handle,))
        return super().step()


# ---- the worker side ---------------------------------------------------------

def serve(device, on_result=None) -> int:
    """Serve rank 0's sharded solves until it sends the stop op; returns the
    number of ops served.  ``on_result(op_name, result)``, when given, sees
    each op's result on this rank: the pose solve's ``(T, inliers,
    n_inliers)``, the GBA's carry after each step.  A GBA init drops the
    GBA served before it (the engine steps one at a time)."""
    device = torch.device(device)
    rank, world = rank_and_size()
    if rank == 0 or world < 2:
        raise RuntimeError("serve() runs on ranks 1..D-1 of a group of D > 1 ranks; "
                           "rank 0 runs the engine")
    store = _store()
    gba_handle, gba = None, None
    served = 0
    while True:
        op, ints, cam = _recv_header(store, rank, served)
        if op == OP_STOP:
            return served
        if op == OP_POSE:
            k = ints[0]
            buf = broadcast(torch.empty((16 + _POSE_COLS * k,), dtype=torch.float32,
                                        device=device))
            result = _pose_shard(buf, k, cam)
        elif op == OP_GBA_INIT:
            handle, Ko, n_fix, P, E, cg_iters = ints
            shapes = _field_shapes(Ko, n_fix, P, E)
            fbuf = broadcast(torch.empty((sum(math.prod(shapes[f]) for f in _FLOAT_FIELDS),),
                                         dtype=torch.float32, device=device))
            ibuf = broadcast(torch.empty((sum(math.prod(shapes[f]) for f in _INT_FIELDS),),
                                         dtype=torch.int32, device=device))
            gba_handle = handle
            gba = ShardedGBA(_unpack_problem(fbuf, ibuf, shapes), cam, cg_iters)
            result = None
        elif op == OP_GBA_STEP:
            if ints[0] != gba_handle:
                raise RuntimeError(f"GBA step for handle {ints[0]}, which this rank does "
                                   "not hold")
            result = gba.step()
        else:
            raise RuntimeError(f"unknown op {op} from rank 0")
        served += 1
        if on_result is not None:
            on_result(_OP_NAMES[op], result)


def warm_up(device) -> None:
    """One pose solve on this rank alone over a small made-up problem, so
    that the first op rank 0 sends does not wait for this rank's first use
    of the device (its kernels' loading, the solver libraries' handles):
    without it the CLI's frame 1 on two ranks of one H100 took 4.8 s, alone
    0.57 s (``chip_smoke.py`` phase 21)."""
    device = torch.device(device)
    k = 64
    obs = PoseObs(p_w=torch.tensor([0.0, 0.0, 5.0], device=device).repeat(k, 1),
                  uv=torch.zeros((k, 2), device=device), u_right=torch.zeros(k, device=device),
                  sigma2=torch.ones(k, device=device),
                  valid=torch.ones(k, dtype=torch.bool, device=device))
    sharded_pose_solve(torch.eye(4, device=device), obs, _camera(500, 500, 0, 0, 50),
                       lambda x: x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stop_workers():
    """Rank 0: end every rank's :func:`serve` loop."""
    _send_header(OP_STOP)
