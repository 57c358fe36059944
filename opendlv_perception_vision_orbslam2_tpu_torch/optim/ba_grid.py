"""Local bundle adjustment on the dense (window-KF x feature) grid.

Counterpart of the reference package's ``optim/ba_grid.py`` (g2o's
LocalBundleAdjustment solve, reference: src/orboptimizer.cpp:463-798):
Levenberg-Marquardt over ``KO`` optimizable poses and ``PL`` points, the
edges laid out as the per-point observation table ``[PL, KW]`` (one slot
per point x window keyframe).  Every normal-equation block is a reduction
over that table, the landmarks are eliminated by their analytic damped 3x3
inverses, and the Schur-reduced ``[6*KO, 6*KO]`` camera system is solved
densely.

The reference writes each Jacobian component as its own ``[KW, PL]`` array
(a TPU tiling choice); here the components are stacked on two leading axes,
``J_pose [3, 6, KW, PL]`` and ``J_pt [3, 3, KW, PL]`` (residual row, column),
so each block is one ``einsum``.  The reference's ``while_loop`` with an
early exit becomes a fixed trip count whose carry freezes once converged:
the same result, with no host sync per iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import lie
from .ba import CHI2_MONO, CHI2_STEREO


class GridBAProblem(NamedTuple):
    """Dense-grid local BA problem: ``KW = KO + KFIX`` window keyframes
    (first ``KO`` optimizable), ``F`` feature slots each, ``PL`` points.
    The solve runs on the observation table ``o_*``; the ``g_*`` grid views
    drive the final per-feature inlier gate."""

    T_all: torch.Tensor      # [KW, 4, 4] window poses (first KO optimized)
    kf_valid: torch.Tensor   # [KW] bool
    pose_free: torch.Tensor  # [KO] bool (valid AND not gauge-pinned)
    pts: torch.Tensor        # [PL, 3]
    pt_valid: torch.Tensor   # [PL] bool
    g_pt: torch.Tensor       # [KW, F] int32 local point idx (<0 none)
    g_uv: torch.Tensor       # [KW, F, 2]
    g_ur: torch.Tensor       # [KW, F] (<0 mono)
    g_sigma2: torch.Tensor   # [KW, F]
    g_valid: torch.Tensor    # [KW, F] bool
    obs_table: torch.Tensor  # [PL, KW] int32 feature idx (-1 none)
    o_uv: torch.Tensor       # [PL, KW, 2]
    o_ur: torch.Tensor       # [PL, KW] right-u (<0 mono)
    o_sigma2: torch.Tensor   # [PL, KW]
    o_valid: torch.Tensor    # [PL, KW] bool

    @property
    def n_opt(self) -> int:
        return self.pose_free.shape[0]


class GridBAResult(NamedTuple):
    T_opt: torch.Tensor        # [KO, 4, 4]
    pts: torch.Tensor          # [PL, 3]
    grid_inlier: torch.Tensor  # [KW, F] bool (post-optimization chi2 gate)
    cost: torch.Tensor


def _projection_jacobians(p_c, R, fx, fy, bf):
    """``d_pix [..., 3, 3]`` (d(u, v, u_r)/d p_c) and ``d_pc [..., 3, 6]``
    (d p_c / d xi for xi = (rho, phi)) at camera points ``p_c [..., 3]``."""
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    inv_z = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(z)
    du = torch.stack([fx * inv_z, zeros, -fx * x * inv_z2], dim=-1)
    dv = torch.stack([zeros, fy * inv_z, -fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zeros, zeros, bf * inv_z2], dim=-1)
    d_pix = torch.stack([du, dv, dur], dim=-2)
    I3 = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(p_c.shape + (3,))
    d_pc = torch.cat([I3, -lie.hat(p_c)], dim=-1)
    return d_pix, d_pc, inv_z


def _grid_terms(T_all, pts, prob: GridBAProblem, fx, fy, cx, cy, bf):
    """Residuals + Jacobians over the whole [KW, F] grid."""
    PL = prob.pts.shape[0]
    p_w = pts[prob.g_pt.clamp(0, PL - 1).long()]                 # [KW, F, 3]
    R = T_all[:, :3, :3]
    p_c = torch.einsum("wij,wfj->wfi", R, p_w) + T_all[:, None, :3, 3]
    d_pix, d_pc, inv_z = _projection_jacobians(p_c, R, fx, fy, bf)
    u_hat = fx * p_c[..., 0] * inv_z + cx
    v_hat = fy * p_c[..., 1] * inv_z + cy
    is_stereo = prob.g_ur >= 0
    r = torch.stack([prob.g_uv[..., 0] - u_hat, prob.g_uv[..., 1] - v_hat,
                     torch.where(is_stereo, prob.g_ur - (u_hat - bf * inv_z), 0.0)], dim=-1)
    J_pose = -(d_pix @ d_pc)                                       # [KW, F, 3, 6]
    J_pt = -(d_pix @ R[:, None])                                   # [KW, F, 3, 3]
    return r, J_pose, J_pt, is_stereo, p_c[..., 2] <= 1e-6


def _grid_chi2(r, sigma2, is_stereo):
    w = 1.0 / sigma2
    return torch.where(is_stereo, torch.sum(r * r, dim=-1) * w,
                       (r[..., 0] ** 2 + r[..., 1] ** 2) * w)


def _obs_terms(T_all, pts, prob: GridBAProblem, fx, fy, cx, cy, bf):
    """Residuals + Jacobians on the [PL, KW] observation layout."""
    R = T_all[:, :3, :3]
    p_c = torch.einsum("wij,pj->pwi", R, pts) + T_all[None, :, :3, 3]   # [PL, KW, 3]
    d_pix, d_pc, inv_z = _projection_jacobians(p_c, R, fx, fy, bf)
    u_hat = fx * p_c[..., 0] * inv_z + cx
    v_hat = fy * p_c[..., 1] * inv_z + cy
    is_stereo = prob.o_ur >= 0
    r = torch.stack([prob.o_uv[..., 0] - u_hat, prob.o_uv[..., 1] - v_hat,
                     torch.where(is_stereo, prob.o_ur - (u_hat - bf * inv_z), 0.0)], dim=-1)
    J_pose = -(d_pix @ d_pc)
    J_pt = -(d_pix @ R[None])
    return r, J_pose, J_pt, is_stereo, p_c[..., 2] <= 1e-6


def _scalar_residuals(T_all, pts, o_uT, o_vT, o_qT, fx, fy, cx, cy, bf):
    """Residual components in the [KW, PL] layout:
    ``(x, y, z, 1/z, stereo, behind, r_u, r_v, r_q, R)``."""
    R = T_all[:, :3, :3]
    pc = torch.einsum("wij,pj->wip", R, pts) + T_all[:, :3, 3, None]   # [KW, 3, PL]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    behind = z <= 1e-6
    iz = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    u_hat = fx * x * iz + cx
    v_hat = fy * y * iz + cy
    st = o_qT >= 0
    r_u = o_uT - u_hat
    r_v = o_vT - v_hat
    r_q = torch.where(st, o_qT - (u_hat - bf * iz), 0.0)
    return x, y, z, iz, st, behind, r_u, r_v, r_q, R


def _scalar_cost(T_all, pts, o_uT, o_vT, o_qT, infoT, activeT, fx, fy, cx, cy, bf):
    """Huber-robust total cost on the [KW, PL] layout."""
    _, _, _, _, st, behind, r_u, r_v, r_q, _ = _scalar_residuals(
        T_all, pts, o_uT, o_vT, o_qT, fx, fy, cx, cy, bf)
    chi2 = (r_u * r_u + r_v * r_v + r_q * r_q) * infoT
    d2 = torch.where(st, CHI2_STEREO, CHI2_MONO)
    c = torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(d2 * chi2) - d2)
    c = torch.where(behind, 2.0 * torch.sqrt(d2 * 1e8), c)
    return torch.sum(torch.where(activeT, c, 0.0))


def bundle_adjust_grid(prob: GridBAProblem, *, fx: float, fy: float, cx: float,
                       cy: float, bf: float, iters_first: int = 5,
                       iters_second: int = 10) -> GridBAResult:
    """Two-phase LM (5 iterations, chi2 cut, 10 iterations; reference:
    src/orboptimizer.cpp:681-730) with the convergence exit of g2o's gain
    test, as fixed trip counts with a frozen carry."""
    KO = prob.n_opt
    PL = prob.pts.shape[0]
    dt, dev = prob.pts.dtype, prob.pts.device
    T_fix = prob.T_all[KO:]
    delta_mono = math.sqrt(CHI2_MONO)
    delta_stereo = math.sqrt(CHI2_STEREO)

    o_uT = prob.o_uv[..., 0].T
    o_vT = prob.o_uv[..., 1].T
    o_qT = prob.o_ur.T
    infoT = 1.0 / prob.o_sigma2.T
    base_activeT = ((prob.obs_table >= 0).T & prob.o_valid.T
                    & prob.pt_valid[None, :] & prob.kf_valid[:, None])
    free_k = prob.pose_free                                        # [KO]
    pt_ok = prob.pt_valid                                          # [PL]
    eye6 = torch.eye(6, dtype=dt, device=dev)
    free_im = free_k[None, :].expand(6, KO).reshape(-1)           # i-major [6*KO]

    def robust_cost(T_opt, pts, activeT):
        return _scalar_cost(torch.cat([T_opt, T_fix]), pts, o_uT, o_vT, o_qT, infoT,
                            activeT, fx, fy, cx, cy, bf)

    def lm_step(T_opt, pts, lam, prev_cost, activeT):
        T_all = torch.cat([T_opt, T_fix])
        x, y, z, iz, st, behind, r_u, r_v, r_q, R = _scalar_residuals(
            T_all, pts, o_uT, o_vT, o_qT, fx, fy, cx, cy, bf)
        iz2 = iz * iz
        ok = activeT & ~behind
        chi = torch.sqrt(torch.clamp((r_u * r_u + r_v * r_v + r_q * r_q) * infoT, min=1e-12))
        delta = torch.where(st, delta_stereo, delta_mono)
        w = torch.where(ok, torch.where(chi <= delta, 1.0, delta / chi) * infoT, 0.0)
        wr = torch.stack([w, w, torch.where(st, w, 0.0)])                # [3, KW, PL]
        res = torch.stack([r_u, r_v, r_q])                               # [3, KW, PL]

        zeros = torch.zeros_like(z)
        # pose-Jacobian rows (translation cols 0-2, rotation cols 3-5)
        Ju = [-fx * iz, zeros, fx * x * iz2, fx * x * y * iz2,
              -fx * (1.0 + x * x * iz2), fx * y * iz]
        Jv = [zeros, -fy * iz, fy * y * iz2, fy * (1.0 + y * y * iz2),
              -fy * x * y * iz2, -fy * x * iz]
        Jq = [Ju[0], Ju[1], Ju[2] - bf * iz2, Ju[3] - bf * iz2 * y,
              Ju[4] + bf * iz2 * x, Ju[5]]
        J = torch.stack([torch.stack(Ju), torch.stack(Jv), torch.stack(Jq)])   # [3, 6, KW, PL]
        # landmark-Jacobian rows: Jl[r][l] = -(d_pix[r] . R[:, l])
        d_pix = torch.stack([
            torch.stack([fx * iz, zeros, -fx * x * iz2]),
            torch.stack([zeros, fy * iz, -fy * y * iz2]),
            torch.stack([fx * iz, zeros, -fx * x * iz2 + bf * iz2]),
        ])                                                               # [3, 3c, KW, PL]
        Jl = -torch.einsum("rcwp,wcl->rlwp", d_pix, R)                   # [3, 3, KW, PL]

        # pose blocks over the optimizable window
        wo, Jo, ro, Jlo = wr[:, :KO], J[:, :, :KO], res[:, :KO], Jl[:, :, :KO]
        Hpp = torch.einsum("rkp,rikp,rjkp->kij", wo, Jo, Jo)             # [KO, 6, 6]
        b_p = -torch.einsum("rkp,rikp,rkp->ki", wo, Jo, ro)              # [KO, 6]
        # landmark blocks and the coupling
        Hll = torch.einsum("rwp,rawp,rbwp->pab", wr, Jl, Jl)             # [PL, 3, 3]
        b_l = -torch.einsum("rwp,rawp,rwp->pa", wr, Jl, res)             # [PL, 3]
        b_l = torch.where(pt_ok[:, None], b_l, 0.0)
        Hpl = torch.einsum("rkp,rikp,rlkp->kipl", wo, Jo, Jlo)           # [KO, 6, PL, 3]

        # damped 3x3 landmark inverse (analytic, per point)
        a00 = Hll[:, 0, 0] + lam
        a11 = Hll[:, 1, 1] + lam
        a22 = Hll[:, 2, 2] + lam
        a01, a02, a12 = Hll[:, 0, 1], Hll[:, 0, 2], Hll[:, 1, 2]
        c00 = a11 * a22 - a12 * a12
        c01 = a02 * a12 - a01 * a22
        c02 = a01 * a12 - a02 * a11
        c11 = a00 * a22 - a02 * a02
        c12 = a01 * a02 - a00 * a12
        c22 = a00 * a11 - a01 * a01
        det = a00 * c00 + a01 * c01 + a02 * c02
        big = torch.abs(det) > 1e-12
        idet = torch.where(pt_ok & big, 1.0 / torch.where(big, det, 1.0), 0.0)
        Hinv = torch.stack([torch.stack([c00, c01, c02], -1),
                            torch.stack([c01, c11, c12], -1),
                            torch.stack([c02, c12, c22], -1)], -2) * idet[:, None, None]

        A = torch.einsum("kipj,pjl->kipl", Hpl, Hinv)                    # [KO, 6, PL, 3]
        # Schur coupling, i-major flattening (index = i * KO + k)
        S_off = torch.einsum("kipl,qmpl->ikmq", A, Hpl).reshape(6 * KO, 6 * KO)
        Hpp_d = Hpp + lam * eye6
        Hpp_d = torch.where(free_k[:, None, None], Hpp_d, eye6)
        b_p_m = torch.where(free_k[:, None], b_p, 0.0)
        Hpp_im = torch.einsum("kij,kq->ikjq", Hpp_d,
                              torch.eye(KO, dtype=dt, device=dev)).reshape(6 * KO, 6 * KO)
        S_off = torch.where(free_im[:, None] & free_im[None, :], S_off, 0.0)
        S = Hpp_im - S_off
        rhs = b_p_m.T.reshape(-1) - torch.einsum("kipl,pl->ik", A, b_l).reshape(-1)
        rhs = torch.where(free_im, rhs, 0.0)
        dx, _ = torch.linalg.solve_ex(S + 1e-8 * torch.eye(6 * KO, dtype=dt, device=dev), rhs)
        dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
        dx6 = dx.reshape(6, KO)                                          # [i, k]

        # back-substitute landmarks
        Wt = torch.einsum("kipl,ik->pl", Hpl, dx6)
        dxl = torch.einsum("plj,pj->pl", Hinv, b_l - Wt)

        T_new = lie.exp_se3(dx6.T) @ T_opt
        T_new = torch.where(free_k[:, None, None], T_new, T_opt)
        pts_new = pts + torch.where(pt_ok[:, None], dxl, 0.0)

        new_cost = robust_cost(T_new, pts_new, activeT)
        accept = new_cost < prev_cost
        T_keep = torch.where(accept, T_new, T_opt)
        pts_keep = torch.where(accept, pts_new, pts)
        lam_next = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        cost_keep = torch.where(accept, new_cost, prev_cost)
        # an accepted step with negligible relative gain ends the phase
        done = accept & ((prev_cost - new_cost) <= 1e-4 * torch.clamp(prev_cost, min=1e-6))
        return T_keep, pts_keep, lam_next, cost_keep, done

    def lm_phase(T_opt, pts, activeT, n_iters):
        lam = torch.full((), 1e-4, dtype=dt, device=dev)
        cost = robust_cost(T_opt, pts, activeT)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(n_iters):
            T_n, pts_n, lam_n, cost_n, done_n = lm_step(T_opt, pts, lam, cost, activeT)
            T_opt = torch.where(done, T_opt, T_n)
            pts = torch.where(done, pts, pts_n)
            lam = torch.where(done, lam, lam_n)
            cost = torch.where(done, cost, cost_n)
            done = done | done_n
        return T_opt, pts, cost

    T_opt, pts, _ = lm_phase(prob.T_all[:KO], prob.pts, base_activeT, iters_first)

    # chi2 outlier cut between phases
    _, _, _, _, st, behind, r_u, r_v, r_q, _ = _scalar_residuals(
        torch.cat([T_opt, T_fix]), pts, o_uT, o_vT, o_qT, fx, fy, cx, cy, bf)
    chi2 = (r_u * r_u + r_v * r_v + r_q * r_q) * infoT
    activeT = base_activeT & (chi2 <= torch.where(st, CHI2_STEREO, CHI2_MONO)) & ~behind

    T_opt, pts, _ = lm_phase(T_opt, pts, activeT, iters_second)

    # final per-feature inlier gate on the [KW, F] grid
    rg, _, _, st_g, behind_g = _grid_terms(torch.cat([T_opt, T_fix]), pts, prob,
                                           fx, fy, cx, cy, bf)
    chi2_g = _grid_chi2(rg, prob.g_sigma2, st_g)
    g_active = (prob.g_valid & prob.pt_valid[prob.g_pt.clamp(0, PL - 1).long()]
                & prob.kf_valid[:, None])
    inlier = g_active & (chi2_g <= torch.where(st_g, CHI2_STEREO, CHI2_MONO)) & ~behind_g
    cost = robust_cost(T_opt, pts, activeT)
    return GridBAResult(T_opt=T_opt, pts=pts, grid_inlier=inlier, cost=cost)
