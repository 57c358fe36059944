"""Pose-only optimization: masked batched Gauss-Newton on one SE3 vertex.

Counterpart of the reference package's ``optim/pose_opt.py`` (g2o
PoseOptimization, reference: src/orboptimizer.cpp:248-461): monocular (2D)
and stereo (3D) projection edges, Huber deltas sqrt(5.991) / sqrt(7.815),
4 rounds x 10 iterations with chi2 inlier reclassification between rounds
and the robust kernel dropped from round 3.

Every function carries a leading chain axis C (the robust estimate runs two
GN chains at once).  The reference's early exit (``while_loop`` until
``||dx||^2 <= 1e-13``) becomes a per-chain ``done`` mask that freezes T
after the step that converged: the same result with no host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
ITS_PER_ROUND = 10
N_ROUNDS = 4


class PoseObs(NamedTuple):
    """Pose-optimization problem over K observation slots."""

    p_w: torch.Tensor       # [K, 3] world points
    uv: torch.Tensor        # [K, 2] measured pixel
    u_right: torch.Tensor   # [K] measured right-x, <0 => monocular edge
    sigma2: torch.Tensor    # [K] per-observation sigma^2 (scale^2*octave)
    valid: torch.Tensor     # [K] bool, or [C, K] per chain


def _residuals_jacobian(T_cw, obs: PoseObs, fx, fy, cx, cy, bf):
    """``T_cw [C, 4, 4]`` -> r [C,K,3], J [C,K,3,6], is_stereo [K], behind
    [C,K] for stereo-augmented reprojection; J is wrt a left se3
    perturbation p_c' = exp(xi) T p_w."""
    p_c = lie.transform_points(T_cw, obs.p_w)                    # [C, K, 3]
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    z_safe = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u_hat = fx * x * inv_z + cx
    v_hat = fy * y * inv_z + cy
    ur_hat = u_hat - bf * inv_z

    is_stereo = obs.u_right >= 0
    r = torch.stack(
        [
            obs.uv[:, 0] - u_hat,
            obs.uv[:, 1] - v_hat,
            torch.where(is_stereo, obs.u_right - ur_hat, torch.zeros_like(ur_hat)),
        ],
        dim=-1,
    )

    zero = torch.zeros_like(z)
    du = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * inv_z2], dim=-1)
    d_pix = torch.stack([du, dv, dur], dim=-2)                   # [C, K, 3, 3]

    # d(p_c)/d(xi) = [I | -hat(p_c)] for xi = (rho, phi)
    I3 = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(p_c.shape + (3,))
    d_pc = torch.cat([I3, -lie.hat(p_c)], dim=-1)                # [C, K, 3, 6]

    J = -(d_pix @ d_pc)                                          # [C, K, 3, 6]
    behind = z <= 1e-6
    return r, J, is_stereo, behind


def _chi2(r, sigma2, is_stereo):
    w = 1.0 / sigma2
    c_mono = (r[..., 0] ** 2 + r[..., 1] ** 2) * w
    c_stereo = torch.sum(r * r, dim=-1) * w
    return torch.where(is_stereo, c_stereo, c_mono)


def _classify(T, obs: PoseObs, valid, fx, fy, cx, cy, bf):
    """chi2 inlier mask of every slot under pose ``T [C, 4, 4]``."""
    r, _, is_stereo, behind = _residuals_jacobian(T, obs, fx, fy, cx, cy, bf)
    chi2 = _chi2(r, obs.sigma2, is_stereo)
    th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    return valid & (chi2 <= th) & ~behind


def _gn_iterations(T, obs: PoseObs, valid, inlier_mask, use_huber: bool,
                   fx, fy, cx, cy, bf):
    delta_mono = math.sqrt(CHI2_MONO)
    delta_stereo = math.sqrt(CHI2_STEREO)
    C = T.shape[0]
    done = torch.zeros(C, dtype=torch.bool, device=T.device)
    eye6 = 1e-5 * torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(ITS_PER_ROUND):
        r, J, is_stereo, behind = _residuals_jacobian(T, obs, fx, fy, cx, cy, bf)
        active = valid & inlier_mask & ~behind
        info = 1.0 / obs.sigma2
        chi = torch.sqrt(torch.clamp(_chi2(r, obs.sigma2, is_stereo), min=1e-12))
        delta = torch.where(is_stereo, delta_stereo, delta_mono)
        w = info
        if use_huber:
            w = info * torch.where(chi <= delta, torch.ones_like(chi), delta / chi)
        w = torch.where(active, w, torch.zeros_like(chi))
        # zero the ur row for mono edges
        row_mask = torch.stack([torch.ones_like(is_stereo), torch.ones_like(is_stereo),
                                is_stereo], dim=-1).to(w.dtype)   # [K, 3]
        row_w = row_mask * w[..., None]                            # [C, K, 3]
        Jw = J * row_w[..., None]
        H = torch.einsum("ckri,ckrj->cij", Jw, J) + eye6
        b = -torch.einsum("ckri,ckr->ci", Jw, r)
        dx, info_solve = torch.linalg.solve_ex(H, b)
        ok = torch.isfinite(dx).all(dim=-1) & (info_solve == 0)
        dx = torch.where(ok[:, None], dx, torch.zeros_like(dx))
        T_next = lie.exp_se3(dx) @ T
        T = torch.where(done[:, None, None], T, T_next)
        done = done | (torch.sum(dx * dx, dim=-1) <= 1e-13)
    return T


def _pose_optimize_chains(T_init, obs: PoseObs, fx, fy, cx, cy, bf):
    """``T_init [C, 4, 4]``, ``obs.valid [C, K]`` -> (T [C,4,4], inliers
    [C,K], n_inliers [C])."""
    valid = obs.valid
    T = T_init
    inliers = torch.ones_like(valid)
    for rnd in range(N_ROUNDS):
        use_huber = rnd < 2  # the reference drops the kernel at round 3 (:436)
        T = _gn_iterations(T, obs, valid, inliers, use_huber, fx, fy, cx, cy, bf)
        inliers = _classify(T, obs, valid, fx, fy, cx, cy, bf)
    return T, inliers, inliers.sum(dim=-1)


def pose_optimize(T_cw_init, obs: PoseObs, *, fx: float, fy: float,
                  cx: float, cy: float, bf: float):
    """Optimize a single pose against fixed world points.  Returns
    ``(T_cw, inlier_mask, n_inliers)`` (reference: src/orboptimizer.cpp:444-459)."""
    T, inl, n = _pose_optimize_chains(
        T_cw_init[None], obs._replace(valid=obs.valid[None]), fx, fy, cx, cy, bf
    )
    return T[0], inl[0], n[0]


def classify_inliers(T_cw, obs: PoseObs, *, fx: float, fy: float, cx: float,
                     cy: float, bf: float):
    """chi2 inlier mask ``[K]`` of ``obs`` (within ``obs.valid``) under the
    single pose ``T_cw``: the test that ends every round of
    ``pose_optimize``."""
    return _classify(T_cw[None], obs, obs.valid[None], fx, fy, cx, cy, bf)[0]


def robust_pose_estimate(T_pred, obs: PoseObs, generator=None, *, fx: float,
                         fy: float, cx: float, cy: float, bf: float,
                         pnp_idx=None):
    """Pose optimization with a RANSAC rescue branch.

    Two GN chains run as one batch: from the motion prediction over all
    matches, and from an EPnP-RANSAC seed over its consensus set
    (PnPsolver::Refine semantics, reference: src/pnpsolver.cpp:234-281).
    The chain with more chi2 inliers over the FULL observation set wins,
    branch-free.  ``generator`` draws the RANSAC sets; ``pnp_idx`` replaces
    the draw (tests inject the reference package's sets).
    """
    from .pnp import pnp_ransac

    res = pnp_ransac(obs.p_w, obs.uv, obs.sigma2, obs.valid, generator,
                     fx=fx, fy=fy, cx=cx, cy=cy, idx=pnp_idx)
    T_pnp = lie.make_T(res.R, res.t)
    T_inits = torch.stack([T_pred, T_pnp])
    valids = torch.stack([obs.valid, obs.valid & res.inliers])
    T_ab, _, _ = _pose_optimize_chains(T_inits, obs._replace(valid=valids),
                                       fx, fy, cx, cy, bf)
    inl = _classify(T_ab, obs, obs.valid, fx, fy, cx, cy, bf)   # [2, K]
    n = inl.sum(dim=-1)
    use_b = n[1] > n[0]
    T = torch.where(use_b, T_ab[1], T_ab[0])
    inliers = torch.where(use_b, inl[1], inl[0])
    return T, inliers, torch.maximum(n[0], n[1])
