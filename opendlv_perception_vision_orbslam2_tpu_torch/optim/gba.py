"""Global bundle adjustment: matrix-free Schur complement + conjugate gradient.

Counterpart of the reference package's ``optim/gba.py``
(GlobalBundleAdjustemnt / RunGlobalBundleAdjustment, reference:
src/orboptimizer.cpp:47-52, src/loopclosing.cpp:645-750).  The reduced
camera system is never formed:

    S v = Hpp v - W Hll^-1 W^T v

evaluates as per-edge products summed per pose and per point, and S is
solved by block-Jacobi-preconditioned CG.  Levenberg-Marquardt keeps or
reverts a step by comparing costs on the device (``torch.where``), so a
chunk of iterations reads nothing back.  Every edge reduction (the cost,
the gradient and diagonal blocks, the W / W^T products inside CG) passes
through one ``reduce_fn`` hook: the identity on one device, an all-reduce
over a process group when the edges are split across ranks
(``parallel/sharded_ba.py``).

The per-pose and per-point sums run in an order fixed by the problem
(:class:`EdgeSums`), so a solve gives the same bits on every run, where
``index_add`` (the reference's ``.at[].add``) adds on CUDA by float atomics
in whatever order the threads arrive.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie
from .ba import BAProblem, CHI2_MONO, CHI2_STEREO, _edge_chi2, _edge_residuals, _inv3x3


class EdgeSums(NamedTuple):
    """The fixed summation order of one problem's edges, built once per
    problem by :func:`edge_sums`: the live edges sorted by pose
    (``pose_order``, stable) and by point (``pt_order``), summed segment by
    segment (``pose_lengths [Ko]``, ``pt_lengths [P]``), each segment in
    edge order.  On the CPU that is the order of ``index_add`` and of the
    reference's scatter on XLA:CPU, bit for bit; on the card it is the
    same order on every run.  Edges left out of a sum carry zero weight in
    it."""

    pose_order: torch.Tensor
    pose_lengths: torch.Tensor
    pt_order: torch.Tensor
    pt_lengths: torch.Tensor


def _segments(keys, live, n: int):
    """The ``live`` edges sorted by ``keys`` (stable) and the length of each
    of the ``n`` segments.  Reads the count of live edges back (one sync)."""
    idx = torch.nonzero(live)[:, 0]
    k = keys[idx].long()
    order = idx[torch.argsort(k, stable=True)]
    lengths = torch.zeros((n,), dtype=torch.int64, device=keys.device).index_add(
        0, k, torch.ones_like(k))
    return order, lengths


def edge_sums(prob: BAProblem) -> EdgeSums:
    """The summation order of ``prob``'s edges (see :class:`EdgeSums`)."""
    Ko, P = prob.T_opt.shape[0], prob.pts.shape[0]
    live = prob.e_valid & prob.pt_valid[prob.e_pt.long()]
    return EdgeSums(*_segments(prob.e_kf, live & (prob.e_kf < Ko), Ko),
                    *_segments(prob.e_pt, live, P))


def _segment_sum(x, order, lengths):
    return torch.segment_reduce(x[order], "sum", lengths=lengths, unsafe=True)


def _edge_terms(T_all, pts, prob: BAProblem, fx, fy, cx, cy, bf, pose_free):
    """Residuals, Jacobians and robust row weights of all edges; pose
    Jacobians are zeroed on non-free poses.  Returns ``(r, J_pose, J_pt,
    row_w, kf_idx, active)``."""
    r, J_pose, J_pt, is_stereo, behind = _edge_residuals(T_all, pts, prob, fx, fy, cx, cy, bf)
    active = prob.e_valid & prob.pt_valid[prob.e_pt.long()] & ~behind
    chi = torch.sqrt(torch.clamp(_edge_chi2(r, prob.e_sigma2, is_stereo), min=1e-12))
    delta = torch.where(is_stereo, CHI2_STEREO ** 0.5, CHI2_MONO ** 0.5)
    huber_w = torch.where(chi <= delta, torch.ones_like(chi), delta / chi)
    w = torch.where(active, huber_w / prob.e_sigma2, torch.zeros_like(chi))
    ones = torch.ones_like(w)
    row_w = torch.stack([ones, ones, is_stereo.to(w.dtype)], dim=-1) * w[:, None]
    Ko = pose_free.shape[0]
    free_all = torch.cat([pose_free, torch.zeros_like(prob.fix_valid)])
    on_free = (prob.e_kf < Ko) & free_all[prob.e_kf.long()]
    J_pose = J_pose * on_free[:, None, None]
    kf_idx = torch.where(on_free, prob.e_kf, 0).long()
    return r, J_pose, J_pt, row_w, kf_idx, active


def _identity(x):
    return x


def _robust_cost(T_opt, pts, prob: BAProblem, fx, fy, cx, cy, bf, reduce_fn=_identity):
    """The Huber cost over the edges in front of their camera (reduced by
    ``reduce_fn``), and those edges' mask: ``(cost, active)``."""
    T_all = torch.cat([T_opt, prob.T_fix])
    r, _, _, is_stereo, behind = _edge_residuals(T_all, pts, prob, fx, fy, cx, cy, bf)
    active = prob.e_valid & prob.pt_valid[prob.e_pt.long()] & ~behind
    chi2 = _edge_chi2(r, prob.e_sigma2, is_stereo)
    d2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    c = torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(d2 * chi2) - d2)
    cost = reduce_fn(torch.sum(torch.where(active, c, torch.zeros_like(c))))
    return cost, active


def _outer(carry, prob: BAProblem, sums: EdgeSums, pose_free, fx, fy, cx, cy, bf,
           cg_iters: int, hold_cheirality: bool = False, reduce_fn=None):
    """One LM iteration with a CG inner solve; ``carry = (T_opt, pts, lam,
    cost)``.  With ``hold_cheirality`` a step that puts a point behind a
    camera that saw it in front is refused, whatever the cost says (the cost
    leaves such edges out).  ``reduce_fn`` (None: the identity) takes every
    per-pose and per-point sum and the cost: with the edges split across
    ranks, each rank sums its own edges and ``reduce_fn`` adds the ranks'
    sums (7 + 2 ``cg_iters`` calls)."""
    red = reduce_fn or _identity
    T_opt, pts, lam, prev_cost = carry
    dt, dev = T_opt.dtype, T_opt.device
    T_all = torch.cat([T_opt, prob.T_fix])
    r, Jp, Jl, row_w, kf_idx, active = _edge_terms(T_all, pts, prob, fx, fy, cx, cy, bf,
                                                    pose_free)
    e_pt = prob.e_pt.long()
    pt_ok = prob.pt_valid[:, None]

    def to_poses(x):      # [E, ...] -> [Ko, ...]; terms off the free poses are 0
        return red(_segment_sum(x, sums.pose_order, sums.pose_lengths))

    def to_points(x):     # [E, ...] -> [P, ...]; inactive edges' terms are 0
        return red(_segment_sum(x, sums.pt_order, sums.pt_lengths))

    wr = row_w * r
    b_p = to_poses(-torch.einsum("eri,er->ei", Jp, wr))
    b_l = torch.where(pt_ok, to_points(-torch.einsum("eri,er->ei", Jl, wr)), 0.0)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    # The landmark blocks are summed and inverted in float64.  Their
    # condition reaches ~1e4 on real maps, and there the float32 adjugate
    # inverse alone puts one chunk's poses ~1e-3 from the float64 solve (on
    # the KITTI loop circuit's closure map 9.6e-4, 1.4e-4 with these blocks
    # in float64), enough to part two devices' results by as much.
    eye3 = torch.eye(3, dtype=torch.float64, device=dev)
    Hll = to_points(torch.einsum("eri,er,erj->eij", Jl.double(), row_w.double(), Jl.double()))
    Hll = torch.where(prob.pt_valid[:, None, None], Hll + lam.double() * eye3, eye3)
    Hll_inv = _inv3x3(Hll).to(dt)
    Hpp = to_poses(torch.einsum("eri,er,erj->eij", Jp, row_w, Jp)) + lam * eye6
    Hpp = torch.where(pose_free[:, None, None], Hpp, eye6)
    M_inv, _ = torch.linalg.inv_ex(Hpp)      # block-Jacobi preconditioner

    def Wt_v(v):          # [Ko, 6] -> [P, 3]
        t = torch.einsum("eri,ei->er", Jp, v[kf_idx]) * row_w
        return to_points(torch.einsum("eri,er->ei", Jl, t))

    def W_y(y):           # [P, 3] -> [Ko, 6]
        t = torch.einsum("eri,ei->er", Jl, y[e_pt]) * row_w
        return to_poses(torch.einsum("eri,er->ei", Jp, t))

    def S_v(v):
        y = torch.where(pt_ok, (Hll_inv @ Wt_v(v)[:, :, None])[:, :, 0], 0.0)
        return (Hpp @ v[:, :, None])[:, :, 0] - W_y(y)

    def precond(x):
        return (M_inv @ x[:, :, None])[:, :, 0]

    rhs = b_p - W_y(torch.where(pt_ok, (Hll_inv @ b_l[:, :, None])[:, :, 0], 0.0))
    rhs = torch.where(pose_free[:, None], rhs, 0.0)
    x = torch.zeros_like(rhs)
    res = rhs
    z = precond(rhs)
    p_dir = z
    rz = torch.sum(rhs * z)
    for _ in range(cg_iters):
        Ap = S_v(p_dir)
        alpha = rz / torch.clamp(torch.sum(p_dir * Ap), min=1e-12)
        x = x + alpha * p_dir
        res = res - alpha * Ap
        z = precond(res)
        rz_new = torch.sum(res * z)
        beta = rz_new / torch.clamp(rz, min=1e-12)
        p_dir = z + beta * p_dir
        rz = rz_new
    dx_c = torch.where(torch.isfinite(x).all(), x, 0.0)
    dx_c = torch.where(pose_free[:, None], dx_c, 0.0)
    dx_l = torch.where(pt_ok, (Hll_inv @ (b_l - Wt_v(dx_c))[:, :, None])[:, :, 0], 0.0)

    T_new = torch.where(pose_free[:, None, None], lie.exp_se3(dx_c) @ T_opt, T_opt)
    pts_new = pts + dx_l
    new_cost, active_new = _robust_cost(T_new, pts_new, prob, fx, fy, cx, cy, bf, red)
    accept = new_cost < prev_cost
    if hold_cheirality:
        accept = accept & (red(torch.sum(active & ~active_new).to(lam.dtype)) == 0)
    return (torch.where(accept, T_new, T_opt), torch.where(accept, pts_new, pts),
            torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4),
            torch.where(accept, new_cost, prev_cost))


def gba_core(prob: BAProblem, *, fx: float, fy: float, cx: float, cy: float, bf: float,
             n_outer: int = 10, cg_iters: int = 40, fix_first_pose: bool = True,
             init_carry=None, return_carry: bool = False, sums: EdgeSums | None = None,
             hold_cheirality: bool = False, reduce_fn=None):
    """LM with matrix-free Schur-CG inner solves.  Returns ``(T_opt, pts,
    cost)``, or the LM carry ``(T_opt, pts, lam, cost)`` with
    ``return_carry``; ``init_carry`` resumes from one (the bounded chunks of
    the incremental GBA, the functional form of the reference's abortable
    GBA thread, src/loopclosing.cpp:576-580, 645-750).  ``sums`` is
    ``edge_sums(prob)``, built here when not given; ``hold_cheirality``
    and ``reduce_fn``: see :func:`_outer` (with ``reduce_fn``, ``prob``
    holds this rank's edges and ``sums`` their order)."""
    pose_free = prob.opt_valid
    if fix_first_pose:
        pose_free = pose_free & (torch.arange(pose_free.shape[0], device=pose_free.device) > 0)
    if init_carry is None:
        carry = (prob.T_opt, prob.pts,
                 torch.full((), 1e-4, dtype=prob.T_opt.dtype, device=prob.T_opt.device),
                 _robust_cost(prob.T_opt, prob.pts, prob, fx, fy, cx, cy, bf,
                              reduce_fn or _identity)[0])
    else:
        carry = init_carry
    if sums is None:
        sums = edge_sums(prob)
    for _ in range(n_outer):
        carry = _outer(carry, prob, sums, pose_free, fx, fy, cx, cy, bf, cg_iters,
                       hold_cheirality, reduce_fn)
    if return_carry:
        return carry
    return carry[0], carry[1], carry[3]


def global_bundle_adjust(prob: BAProblem, *, fx: float, fy: float, cx: float, cy: float,
                         bf: float, n_outer: int = 10, cg_iters: int = 40,
                         fix_first_pose: bool = True):
    """The one-shot solve (see :func:`gba_core`)."""
    return gba_core(prob, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, n_outer=n_outer,
                    cg_iters=cg_iters, fix_first_pose=fix_first_pose)


def global_bundle_adjust_chunk(prob: BAProblem, carry, *, fx: float, fy: float, cx: float,
                               cy: float, bf: float, n_outer: int = 1, cg_iters: int = 40,
                               fix_first_pose: bool = True, sums: EdgeSums | None = None,
                               reduce_fn=None):
    """``n_outer`` LM iterations from an explicit ``(T, pts, lam, cost)``
    carry (start with :func:`gba_init_carry`); returns the new carry.  Pass
    ``sums = edge_sums(prob)`` to chunks of one problem: building it reads
    back to the host.  ``reduce_fn``: see :func:`gba_core`."""
    return gba_core(prob, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, n_outer=n_outer,
                    cg_iters=cg_iters, fix_first_pose=fix_first_pose, init_carry=carry,
                    return_carry=True, sums=sums, reduce_fn=reduce_fn)


def gba_init_carry(prob: BAProblem):
    """The first carry of :func:`global_bundle_adjust_chunk`: the cost starts
    at +inf so the first chunk's accept test always fires."""
    kw = dict(dtype=prob.T_opt.dtype, device=prob.T_opt.device)
    return (prob.T_opt, prob.pts, torch.full((), 1e-4, **kw), torch.full((), float("inf"), **kw))
