"""SE(3) operations and the pinhole camera on batched ``[..., 4, 4]`` tensors.

Counterpart of the SE3 subset of the reference package's ``ops/lie.py`` that
the VO slice calls (Sim3 and triangulation come with the mapping slice).

Conventions:
- SE3 tangent ``xi = [rho(3), phi(3)]`` (translation part first, like g2o).
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


def make_T(R, t):
    """Assemble ``[..., 4, 4]`` from rotation ``[..., 3, 3]`` and translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
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
