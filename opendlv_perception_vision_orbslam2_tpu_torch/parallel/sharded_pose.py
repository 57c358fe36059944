"""Observation-sharded pose optimization over a process group.

Counterpart of the reference package's ``parallel/sharded_pose.py``: the
reprojection residuals and Jacobians of the observations split across the
ranks, each rank forms its 6x6 normal system, and one ``all_reduce_sum`` a
Gauss-Newton step assembles the whole (H and b packed into 42 floats; the
reference makes two psums).  The schedule is the sharded one, not
``optim/pose_opt.py``'s: ``n_rounds`` rounds of exactly ``n_iters`` steps
with no convergence exit, H damped by 1e-5, a non-finite step set to zero,
the Huber kernel dropped from round 3, and the chi2 inlier count reduced
over the group by one more all-reduce.

These are SPMD primitives: every rank calls them with its own shard.  The
engine's solver on rank 0 (``serve.py::EnginePoseSolver``) broadcasts each
frame's observations to the ranks that serve, and every rank runs
:func:`sharded_pose_solve` on its block.
"""

from __future__ import annotations

import math

import torch

from ..ops import lie
from ..optim.pose_opt import CHI2_MONO, CHI2_STEREO, PoseObs, _chi2, _classify, \
    _residuals_jacobian
from .collectives import rank_and_size, reducer

N_ITERS, N_ROUNDS = 10, 4     # the reference's schedule: 4 rounds of 10 steps

# the fills of padded slots: a monocular, unit-weight, invalid observation
_OBS_FILL = {"u_right": -1, "sigma2": 1, "valid": False}


def pad_obs_to_multiple(obs: PoseObs, n: int) -> PoseObs:
    """``obs`` with invalid slots appended until the slot count divides
    ``n``."""
    rem = (-obs.p_w.shape[0]) % n
    if rem == 0:
        return obs
    return PoseObs(*(torch.cat([a, torch.full((rem,) + a.shape[1:], _OBS_FILL.get(f, 0),
                                              dtype=a.dtype, device=a.device)])
                     for f, a in zip(PoseObs._fields, obs)))


def shard_obs(obs: PoseObs, rank: int, world: int) -> PoseObs:
    """Rank ``rank``'s contiguous block of the (padded) slots."""
    k = obs.p_w.shape[0]
    if k % world:
        raise ValueError(f"{k} observation slots do not split over {world} ranks")
    lo, hi = rank * (k // world), (rank + 1) * (k // world)
    return PoseObs(*(a[lo:hi] for a in obs))


def _normal_system(T, obs: PoseObs, inliers, use_huber: bool, cam):
    """This rank's ``[H (36) | b (6)]``."""
    r, J, is_stereo, behind = _residuals_jacobian(T[None], obs, *cam)
    active = obs.valid & inliers & ~behind[0]
    chi = torch.sqrt(torch.clamp(_chi2(r[0], obs.sigma2, is_stereo), min=1e-12))
    w = 1.0 / obs.sigma2
    if use_huber:
        delta = torch.where(is_stereo, math.sqrt(CHI2_STEREO), math.sqrt(CHI2_MONO))
        w = w * torch.where(chi <= delta, torch.ones_like(chi), delta / chi)
    w = torch.where(active, w, torch.zeros_like(w))
    ones = torch.ones_like(w)
    row_w = torch.stack([ones, ones, is_stereo.to(w.dtype)], dim=-1) * w[:, None]
    Jw = J[0] * row_w[..., None]
    H = torch.einsum("kri,krj->ij", Jw, J[0])
    b = -torch.einsum("kri,kr->i", Jw, r[0])
    return torch.cat([H.reshape(-1), b])


def sharded_pose_solve(T0, obs: PoseObs, cam, reduce_fn, rank: int = 0, world: int = 1,
                       n_iters: int = N_ITERS, n_rounds: int = N_ROUNDS):
    """``(T, inliers [world * K], n_inliers)``: ``T0 [4, 4]`` refined against
    every rank's block of ``K`` observations (``obs`` is this rank's), the
    chi2 inlier mask of every block in rank order, and the inlier count.
    ``cam`` is ``(fx, fy, cx, cy, bf)``; ``reduce_fn`` sums a tensor over
    the ranks (``collectives.reducer(group)``), and its result must be the
    same bits on every rank.  Makes ``n_rounds * n_iters + 1`` reductions."""
    eye6 = 1e-5 * torch.eye(6, dtype=T0.dtype, device=T0.device)
    T = T0
    inliers = torch.ones_like(obs.valid)
    for rnd in range(n_rounds):
        for _ in range(n_iters):
            Hb = reduce_fn(_normal_system(T, obs, inliers, rnd < 2, cam))
            dx, info = torch.linalg.solve_ex(Hb[:36].reshape(6, 6) + eye6, Hb[36:])
            ok = torch.isfinite(dx).all() & (info == 0)
            dx = torch.where(ok, dx, torch.zeros_like(dx))
            T = lie.exp_se3(dx) @ T
        inliers = _classify(T[None], obs, obs.valid[None], *cam)[0]
    k = obs.valid.shape[0]
    every = torch.zeros((world * k,), dtype=torch.int32, device=T.device)
    every[rank * k:(rank + 1) * k] = inliers.to(torch.int32)
    every = reduce_fn(every) > 0
    return T, every, every.sum()


def make_sharded_pose_optimizer(group, *, fx, fy, cx, cy, bf, n_iters: int = N_ITERS,
                                n_rounds: int = N_ROUNDS):
    """The observation-sharded pose solver of ``group``: ``fn(T0, obs_local)
    -> (T, inliers_local, n_inliers)``, the pose replicated on every rank,
    this rank's inlier mask, the count over the group.  Each rank passes the
    same ``T0`` and a block of the same size."""
    cam, red = (fx, fy, cx, cy, bf), reducer(group)

    def solve(T0, obs_local: PoseObs):
        rank, world = rank_and_size(group)
        T, every, n = sharded_pose_solve(T0, obs_local, cam, red, rank, world, n_iters, n_rounds)
        k = obs_local.valid.shape[0]
        return T, every[rank * k:(rank + 1) * k], n

    return solve
