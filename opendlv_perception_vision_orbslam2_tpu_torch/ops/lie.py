"""SE(3) operations and the pinhole camera on batched ``[..., 4, 4]`` tensors.

Counterpart of the reference package's ``ops/lie.py``: SE3 and its log map,
the Sim3 operations loop closing needs (carried as ``(R, t, s)`` triples),
pose re-orthonormalization and the closed-form DLT triangulation.

Conventions:
- SE3 tangent ``xi = [rho(3), phi(3)]`` (translation part first, like g2o).
- Sim3 tangent ``zeta = [rho(3), phi(3), sigma(1)]`` with scale ``s = exp(sigma)``.
- ``T_cw`` maps world points to camera points: ``x_c = R x_w + t``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """Skew-symmetric matrix of ``[..., 3]`` -> ``[..., 3, 3]``
    (Mapping::SkewSymmetricMatrix, reference: src/mapping.cpp:726-736)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def exp_so3(phi):
    """Rodrigues: ``[..., 3]`` axis-angle -> ``[..., 3, 3]`` rotation."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / (theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, a)
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    K = hat(phi)
    return _eye3_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R):
    """Inverse Rodrigues: ``[..., 3, 3]`` -> ``[..., 3]`` axis-angle.  theta
    comes from atan2(|w|, cos) with an epsilon-padded norm, so forward-mode
    Jacobians at the identity are finite; near theta = pi the axis comes
    from the symmetric part."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sqrt(torch.sum(w * w, dim=-1) + _EPS * _EPS)
    theta = torch.atan2(sin_theta, cos_theta)
    w_gen = w * (theta / sin_theta)[..., None]
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS),
                          0.0, 1.0)
    axis = torch.sqrt(axis_sq)
    sign_xy = torch.sign(R[..., 0, 1] + R[..., 1, 0] + _EPS)
    sign_xz = torch.sign(R[..., 0, 2] + R[..., 2, 0] + _EPS)
    sx = torch.where(w[..., 0] < 0, -1.0, 1.0)
    axis = axis * torch.stack([sx, sx * sign_xy, sx * sign_xz], dim=-1)
    return torch.where(near_pi[..., None], axis * theta[..., None], w_gen)


def _so3_left_jacobian(phi):
    """Left Jacobian J of SO(3): the exp_se3 translation column uses V = J."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    a = (1.0 - torch.cos(theta)) / (theta2 + _EPS)
    b = (theta - torch.sin(theta)) / (theta2 * theta + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0, a)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, b)
    return _eye3_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def exp_se3(xi):
    """``[..., 6]`` (rho, phi) -> ``[..., 4, 4]`` homogeneous transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    V = _so3_left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return make_T(R, t)


def log_se3(T):
    """``[..., 4, 4]`` -> ``[..., 6]`` (rho, phi)."""
    phi = log_so3(T[..., :3, :3])
    V = _so3_left_jacobian(phi)
    rho, _ = torch.linalg.solve_ex(V, T[..., :3, 3:])
    return torch.cat([rho[..., 0], phi], dim=-1)


def make_T(R, t):
    """Assemble ``[..., 4, 4]`` from rotation ``[..., 3, 3]`` and translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # built on the device: a host tensor here would cost a synced copy
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom.select(-1, 3).fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def inv_T(T):
    """Closed-form inverse of a rigid transform (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T, pts):
    """Apply ``[..., 4, 4]`` to points ``[..., N, 3]``."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


# ---------------------------------------------------------------------------
# Sim(3), carried as (R [..., 3, 3], t [..., 3], s [...]) triples (loop
# closing: src/sim3solver.cpp:240-351, the essential graph's g2o::Sim3
# vertices, src/orboptimizer.cpp:799-1061)
# ---------------------------------------------------------------------------


def exp_sim3(zeta):
    """``[..., 7]`` (rho, phi, sigma) -> ``(R, t, s)`` with the series-safe W
    matrix of the Sim(3) exponential (Strasdat's thesis)."""
    rho, phi, sig = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    s = torch.exp(sig)
    R = exp_so3(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    one = torch.ones_like(sig)
    small_sig = torch.abs(sig) < 1e-6
    A = torch.where(small_sig, 1.0 + sig / 2.0, (s - 1.0) / torch.where(small_sig, one, sig))
    st, ct = torch.sin(theta), torch.cos(theta)
    denom = sig * sig + theta2
    small_d = denom < 1e-10
    safe_d = torch.where(small_d, one, denom)
    B = torch.where(small_d, 0.5 * one,
                    (s * st * sig + (1.0 - s * ct) * theta) / (theta * safe_d))
    c_num = A - (s * ct - 1.0) * sig / safe_d - s * st * theta / safe_d
    C = torch.where(small_d, one / 6.0, c_num / torch.where(theta2 < 1e-10, one, theta2))
    W = (A[..., None, None] * _eye3_like(K) + B[..., None, None] * K
         + C[..., None, None] * (K @ K))
    return R, (W @ rho[..., None])[..., 0], s


def sim3_inverse(R, t, s):
    """(s R x + t)^-1 as ``(R', t', s')`` with s' = 1/s."""
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0], s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(a o b)(x) = sa Ra (sb Rb x + tb) + ta."""
    return Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta, sa * sb


def sim3_apply(R, t, s, pts):
    """Apply a Sim3 to points ``[..., N, 3]``."""
    return s[..., None, None] * (pts @ R.transpose(-1, -2)) + t[..., None, :]


def project(pts_cam, fx, fy, cx, cy):
    """Project camera-frame points ``[..., N, 3]`` -> pixels ``[..., N, 2]``.

    Z is NOT clamped; callers mask on z > 0 (OrbFrame::IsInFrustum,
    reference: src/orbframe.cpp:239-305)."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * pts_cam[..., 0] * inv_z + cx
    v = fy * pts_cam[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def backproject(uv, depth, fx, fy, cx, cy):
    """Pixels + depth -> camera-frame 3D (OrbFrame::UnprojectStereo,
    reference: src/orbframe.cpp:730-744)."""
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def orthonormalize_T(T):
    """Project the rotation block back onto SO(3) (Gram-Schmidt columns) and
    return the cleaned SE(3): long chains of pose compositions accumulate
    scale in R, which ``inv_T`` assumes away."""
    R = T[..., :3, :3]
    x = R[..., :, 0]
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    y = R[..., :, 1]
    y = y - torch.sum(x * y, dim=-1, keepdim=True) * x
    y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-12)
    z = torch.linalg.cross(x, y, dim=-1)
    R_o = torch.stack([x, y, z], dim=-1)
    return torch.cat([torch.cat([R_o, T[..., :3, 3:]], dim=-1), T[..., 3:, :]], dim=-2)


def det3(R):
    """Closed-form determinant of ``[..., 3, 3]`` (no LU, no host sync)."""
    return (R[..., 0, 0] * (R[..., 1, 1] * R[..., 2, 2] - R[..., 1, 2] * R[..., 2, 1])
            - R[..., 0, 1] * (R[..., 1, 0] * R[..., 2, 2] - R[..., 1, 2] * R[..., 2, 0])
            + R[..., 0, 2] * (R[..., 1, 0] * R[..., 2, 1] - R[..., 1, 1] * R[..., 2, 0]))


def _inv3x3_sym(B):
    """Closed-form inverse of batched symmetric 3x3 (adjugate / det)."""
    a, b, c = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    e, f = B[..., 1, 1], B[..., 1, 2]
    i = B[..., 2, 2]
    A11 = e * i - f * f
    A12 = c * f - b * i
    A13 = b * f - c * e
    A22 = a * i - c * c
    A23 = c * b - a * f
    A33 = a * e - b * b
    det = a * A11 + b * A12 + c * A13
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18), det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A12, A22, A23], -1),
            torch.stack([A13, A23, A33], -1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def triangulate_linear(P1, P2, uv1, uv2):
    """DLT triangulation of pixel pairs under 3x4 projections ``P1, P2``
    (OrbInitializer::Triangulate, reference: src/orbinitializer.cpp:732-745),
    as the inhomogeneous DLT with w = 1 solved through its 3x3 normal
    equations in closed form: elementwise math, no batched SVD.
    uv: ``[..., N, 2]``; returns ``[..., N, 3]`` world points."""
    def rows(P, uv):
        return torch.stack(
            [
                uv[..., 0, None] * P[..., 2, :] - P[..., 0, :],
                uv[..., 1, None] * P[..., 2, :] - P[..., 1, :],
            ],
            dim=-2,
        )

    A = torch.cat([rows(P1[..., None, :, :], uv1), rows(P2[..., None, :, :], uv2)], dim=-2)
    # row normalization keeps the normal equations well-scaled
    A = A / (torch.linalg.vector_norm(A, dim=-1, keepdim=True) + 1e-12)
    M = A[..., :3]
    b = A[..., 3]
    MtM = torch.einsum("...ri,...rj->...ij", M, M)
    Mtb = torch.einsum("...ri,...r->...i", M, b)
    return -torch.einsum("...ij,...j->...i", _inv3x3_sym(MtM), Mtb)
