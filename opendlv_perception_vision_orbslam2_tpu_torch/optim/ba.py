"""Shared bundle-adjustment problem, residuals and helpers.

The subset of the reference package's ``optim/ba.py`` that the grid local
BA and the global BA import: the chi2 gates (g2o's 95 % quantiles for 2 and
3 DoF, reference: src/orboptimizer.cpp:537-538), the flat-edge problem
``BAProblem`` with its batched residuals and Jacobians, and the closed-form
3x3 inverse (the global BA's landmark blocks).  The dense-W
``bundle_adjust`` itself is not ported: the grid solver replaced it on the
production path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    """Fixed-shape BA problem.  ``e_kf`` indexes ``[0, Ko+Kf)``; indices >=
    Ko are fixed poses (observers that constrain but are not optimized, the
    LocalBundleAdjustment fixed-camera set, reference:
    src/orboptimizer.cpp:527-557)."""

    T_opt: torch.Tensor      # [Ko, 4, 4] optimizable keyframe poses
    opt_valid: torch.Tensor  # [Ko] bool
    T_fix: torch.Tensor      # [Kf, 4, 4] fixed poses
    fix_valid: torch.Tensor  # [Kf] bool
    pts: torch.Tensor        # [P, 3] landmark positions
    pt_valid: torch.Tensor   # [P] bool
    e_kf: torch.Tensor       # [E] int32 pose index (combined opt+fix)
    e_pt: torch.Tensor       # [E] int32 landmark index
    e_uv: torch.Tensor       # [E, 2] measured pixels
    e_ur: torch.Tensor       # [E] measured right-u (<0 mono)
    e_sigma2: torch.Tensor   # [E]
    e_valid: torch.Tensor    # [E] bool


def _edge_residuals(T_all, pts, prob: BAProblem, fx, fy, cx, cy, bf):
    """``(r [E,3], J_pose [E,3,6], J_pt [E,3,3], is_stereo, behind)``."""
    T_e = T_all[prob.e_kf.long()]
    p_w = pts[prob.e_pt.long()]
    R = T_e[:, :3, :3]
    p_c = (R @ p_w[:, :, None])[:, :, 0] + T_e[:, :3, 3]
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    inv_z = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    inv_z2 = inv_z * inv_z
    u_hat = fx * x * inv_z + cx
    v_hat = fy * y * inv_z + cy
    ur_hat = u_hat - bf * inv_z
    is_stereo = prob.e_ur >= 0
    zero = torch.zeros_like(z)
    r = torch.stack([prob.e_uv[:, 0] - u_hat, prob.e_uv[:, 1] - v_hat,
                     torch.where(is_stereo, prob.e_ur - ur_hat, zero)], dim=-1)
    du = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * inv_z2], dim=-1)
    d_pix = torch.stack([du, dv, dur], dim=1)                          # [E, 3, 3]
    I3 = torch.eye(3, dtype=r.dtype, device=r.device).expand(r.shape[0], 3, 3)
    d_pc_dxi = torch.cat([I3, -lie.hat(p_c)], dim=-1)                  # [E, 3, 6]
    J_pose = -(d_pix @ d_pc_dxi)
    J_pt = -(d_pix @ R)
    return r, J_pose, J_pt, is_stereo, z <= 1e-6


def _edge_chi2(r, sigma2, is_stereo):
    w = 1.0 / sigma2
    return torch.where(is_stereo, torch.sum(r * r, dim=-1) * w,
                       (r[:, 0] ** 2 + r[:, 1] ** 2) * w)


def _inv3x3(A):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A12 + c * A13
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]
