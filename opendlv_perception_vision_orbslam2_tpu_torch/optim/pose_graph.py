"""Pose-graph optimization (essential graph) as dense batched Gauss-Newton.

Counterpart of the reference package's ``optim/pose_graph.py``
(OptimizeEssentialGraph, reference: src/orboptimizer.cpp:799-1061): Sim3
vertices (7-DoF) with loop, spanning-tree and strong-covisibility edges, then
SE3 recovery with ``t/s`` (:1044-1052).  Stereo fixes the scale
(``_fix_scale``, :830); monocular keeps the scale column so a loop can
absorb scale drift.

All K vertex states take one ``[K, 7]`` tangent update (rho, phi, sigma).
The per-edge 7x14 Jacobians come from forward-mode autodiff of the
relative-similarity residual (:func:`forward_jacobian`: the 14 directions
as one batched evaluation of dual tensors).  The
normal system sums four blocks per edge into a ``[K*K, 7, 7]`` block
table, viewed as the dense ``[7K, 7K]`` matrix, and is solved by
``solve_ex``: a singular system gives a flagged or non-finite step that the
guard zeroes, and nothing is read back.  The sums run in an order fixed by
the edges (:func:`block_order`): the order of the reference's
``.at[].add`` on the CPU, bit for bit, and the same order on every run on
the card, where a float ``index_add`` adds by atomics in arrival order
(the same correction as ``optim/gba.py``'s ``EdgeSums``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

from ..ops import lie

D = 7
#: the Levenberg-Marquardt damping, relative to the normal matrix's diagonal.
#: ORB-SLAM2 starts g2o's LM at 1e-16 in its essential-graph solve
#: (``setUserLambdaInit``); the reference package damps by 1e-3 at every step,
#: for its float32 LU on the TPU, and its 15 steps then leave most of a long
#: chain's correction undone (on the card, 0.29 of a KITTI-size loop's 0.43
#: deg off a float64 solve run to convergence, ``benchmark/reference/loop.py``).
#: 1e-6 lands within 4e-4 deg of it in the same 15 steps, in float32; a singular
#: system still gives a flagged or non-finite step, which is zeroed.
LM_DAMPING = 1e-6


class PoseGraphProblem(NamedTuple):
    T: torch.Tensor          # [K, 4, 4] initial vertex poses (T_cw, SE3)
    v_valid: torch.Tensor    # [K] bool
    v_fixed: torch.Tensor    # [K] bool (the loop keyframe is fixed, reference :858)
    e_i: torch.Tensor        # [E] int32 source vertex
    e_j: torch.Tensor        # [E] int32 target vertex
    e_T_ij: torch.Tensor     # [E, 4, 4] measured relative pose T_i * T_j^-1
    e_weight: torch.Tensor   # [E] float32 information scale
    e_valid: torch.Tensor    # [E] bool
    scale: Optional[torch.Tensor] = None   # [K] initial vertex scales (1.0)
    e_s_ij: Optional[torch.Tensor] = None  # [E] measured relative scales (1.0)


def _sim3_update(dx, R, t, s):
    """Retraction: left-compose the tangent (rho, phi, sigma) onto (R, t, s)."""
    return lie.exp_so3(dx[..., 3:6]) @ R, t + dx[..., :3], s * torch.exp(dx[..., 6])


def edge_residual(dx_i, dx_j, T_i, s_i, T_j, s_j, T_ij, s_ij):
    """7-vector residual of S_ij_meas o S_j o S_i^-1 against the identity:
    (t_err, log_so3(R_err), log(s_err)); it vanishes iff the measured
    relative similarity matches the vertices."""
    Ri, ti, si = _sim3_update(dx_i, T_i[..., :3, :3], T_i[..., :3, 3], s_i)
    Rj, tj, sj = _sim3_update(dx_j, T_j[..., :3, :3], T_j[..., :3, 3], s_j)
    Rji, tji, sji = lie.sim3_inverse(Ri, ti, si)
    Rm, tm, sm = lie.sim3_compose(T_ij[..., :3, :3], T_ij[..., :3, 3], s_ij, Rj, tj, sj)
    Re, te, se = lie.sim3_compose(Rm, tm, sm, Rji, tji, sji)
    return torch.cat([te, lie.log_so3(Re), torch.log(se)[..., None]], dim=-1)


def forward_jacobian(fn, x):
    """Jacobian ``[..., m, n]`` of ``fn`` at ``x [..., n]`` by forward-mode
    AD, the n directions evaluated at once along a new leading axis (``fn``
    broadcasts over leading axes and maps ``[..., n]`` to ``[..., m]``)."""
    n = x.shape[-1]
    shape = (n,) + tuple(x.shape)
    basis = torch.eye(n, dtype=x.dtype, device=x.device).reshape((n,) + (1,) * (x.dim() - 1) + (n,))
    with fwAD.dual_level():
        dual = fwAD.make_dual(x.expand(shape).contiguous(), basis.expand(shape).contiguous())
        tangent = fwAD.unpack_dual(fn(dual)).tangent
    return torch.movedim(tangent, 0, -1)


def block_order(targets, n: int):
    """The fixed summation order of contributions to ``n`` blocks, the
    contribution ``k`` going to block ``targets[k]``: the contributions
    sorted by block (stable, so each block adds its own in ``targets``'
    order) and each block's count.  No host read."""
    targets = targets.long()
    lengths = torch.zeros((n,), dtype=torch.int64, device=targets.device).index_add(
        0, targets, torch.ones_like(targets))
    return torch.argsort(targets, stable=True), lengths


def block_sum(vals, order, lengths):
    """``vals [N, ...]`` summed into the blocks of :func:`block_order`."""
    return torch.segment_reduce(vals[order], "sum", lengths=lengths, unsafe=True)


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20, fix_scale: bool = True):
    """Returns ``(T [K, 4, 4] SE3-recovered poses, scale [K])``.  ``fix_scale``
    pins every vertex's scale (stereo); ``False`` lets loop edges with a
    measured scale spread scale drift along the graph (monocular)."""
    T_all = prob.T
    K = T_all.shape[0]
    dt, dev = T_all.dtype, T_all.device
    E = prob.e_i.shape[0]
    s_all = prob.scale if prob.scale is not None else torch.ones((K,), dtype=dt, device=dev)
    es = prob.e_s_ij if prob.e_s_ij is not None else torch.ones((E,), dtype=dt, device=dev)
    e_i, e_j = prob.e_i.long(), prob.e_j.long()
    free = prob.v_valid & ~prob.v_fixed
    w = torch.where(prob.e_valid, prob.e_weight, 0.0)
    wi = w * free[e_i]
    wj = w * free[e_j]
    eyeD = torch.eye(D, dtype=dt, device=dev)
    diag_blocks = torch.arange(K, device=dev) * (K + 1)
    # pin fixed/invalid vertices with identity blocks, plus a 1e-6 floor
    diag_fix = torch.where(free[:, None, None], 0.0, eyeD) + 1e-6 * eyeD
    zeros = torch.zeros((E, D), dtype=dt, device=dev)
    zeros2 = torch.zeros((E, 2 * D), dtype=dt, device=dev)
    H_sums = block_order(torch.cat([e_i * K + e_i, e_j * K + e_j, e_i * K + e_j, e_j * K + e_i,
                                    diag_blocks]), K * K)
    b_sums = block_order(torch.cat([e_i, e_j]), K)
    for _ in range(n_iters):
        T_i, T_j = T_all[e_i], T_all[e_j]
        s_i, s_j = s_all[e_i], s_all[e_j]
        r = edge_residual(zeros, zeros, T_i, s_i, T_j, s_j, prob.e_T_ij, es)
        J = forward_jacobian(lambda dx: edge_residual(dx[..., :D], dx[..., D:], T_i, s_i, T_j,
                                                      s_j, prob.e_T_ij, es), zeros2)
        J_i, J_j = J[..., :D], J[..., D:]
        J_i = J_i * wi[:, None, None]
        J_j = J_j * wj[:, None, None]
        if fix_scale:
            # freezing sigma removes its COLUMN from the linear system
            J_i = torch.cat([J_i[..., :D - 1], torch.zeros_like(J_i[..., D - 1:])], dim=-1)
            J_j = torch.cat([J_j[..., :D - 1], torch.zeros_like(J_j[..., D - 1:])], dim=-1)
        rw = r * w[:, None]

        Jt_i, Jt_j = J_i.transpose(1, 2), J_j.transpose(1, 2)
        H = block_sum(torch.cat([Jt_i @ J_i, Jt_j @ J_j, Jt_i @ J_j, Jt_j @ J_i, diag_fix]),
                      *H_sums)
        b = block_sum(-torch.cat([Jt_i @ rw[:, :, None], Jt_j @ rw[:, :, None]])[:, :, 0],
                      *b_sums)
        # Levenberg-Marquardt damping RELATIVE to the diagonal (g2o runs LM
        # here too, src/orboptimizer.cpp:799-840): see LM_DAMPING
        Hd = H.reshape(K, K, D, D).permute(0, 2, 1, 3).reshape(K * D, K * D)
        Hd = Hd + torch.diag(LM_DAMPING * Hd.diagonal())
        if fix_scale:
            # pin every sigma component (the reference's _fix_scale)
            Hd = Hd + torch.diag((torch.arange(K * D, device=dev) % D == D - 1).to(dt))
        b = torch.where(free[:, None], b, 0.0)
        if fix_scale:
            b = torch.cat([b[:, :D - 1], torch.zeros_like(b[:, D - 1:])], dim=1)

        dx, info = torch.linalg.solve_ex(Hd, b.reshape(K * D))
        dx = torch.where(torch.isfinite(dx).all() & (info == 0), dx, 0.0).reshape(K, D)
        dx = torch.where(free[:, None], dx, 0.0)
        if fix_scale:
            dx = torch.cat([dx[:, :D - 1], torch.zeros_like(dx[:, D - 1:])], dim=1)
        R_new = lie.exp_so3(dx[:, 3:6]) @ T_all[:, :3, :3]
        T_all = lie.make_T(R_new, T_all[:, :3, 3] + dx[:, :3])
        s_all = s_all * torch.exp(dx[:, D - 1])
    # SE3 recovery: t / s (reference: src/orboptimizer.cpp:1044-1052)
    return lie.make_T(T_all[:, :3, :3], T_all[:, :3, 3] / s_all[:, None]), s_all


def relative_pose(T_i, T_j):
    """Measured edge transform ``T_ij = T_i * T_j^-1``."""
    return T_i @ lie.inv_T(T_j)
