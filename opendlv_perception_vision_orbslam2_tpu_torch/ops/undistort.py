"""Keypoint undistortion (cv::undistortPoints in OrbFrame::UndistortKeyPoints,
reference: src/orbframe.cpp:448-479) and live-ingest stereo rectification
(setUpRealtime, reference: src/selflocalization.cpp:380-531).

Counterpart of the reference package's ``ops/undistort.py``.  The rectify
maps are built in float32 like the reference package's; ``remap_bilinear``
is a plain gather on the image's device.
"""

from __future__ import annotations

import torch


def distort_normalized(xy, k1, k2, p1, p2, k3):
    """Forward radial/tangential distortion of normalized coords [..., 2]."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(uv, fx, fy, cx, cy, k1, k2, p1, p2, k3=0.0,
                     iters: int = 8):
    """Pixel coords -> undistorted pixel coords (fixed-point iteration, the
    scheme cv::undistortPoints uses)."""
    xd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    x = xd
    for _ in range(iters):
        x = xd - (distort_normalized(x, k1, k2, p1, p2, k3) - x)
    return torch.stack([x[..., 0] * fx + cx, x[..., 1] * fy + cy], dim=-1)


def build_rectify_map(height: int, width: int, fx, fy, cx, cy,
                      k1, k2, p1, p2, k3, R_rect, fx_new, fy_new,
                      cx_new, cy_new):
    """Sampling grid [H, W, 2] mapping rectified pixels -> source pixels
    (initUndistortRectifyMap semantics: for each destination pixel, rotate
    by R_rect^-1 into the original camera, then apply forward distortion).
    Built on ``R_rect``'s device."""
    R_rect = torch.as_tensor(R_rect, dtype=torch.float32)
    ys, xs = torch.meshgrid(torch.arange(height, device=R_rect.device),
                            torch.arange(width, device=R_rect.device), indexing="ij")
    xn = (xs.to(torch.float32) - cx_new) / fx_new
    yn = (ys.to(torch.float32) - cy_new) / fy_new
    rays = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    rays = torch.einsum("ij,hwj->hwi", torch.linalg.inv(R_rect), rays)
    xy = rays[..., :2] / torch.clamp(rays[..., 2:3], min=1e-9)
    xyd = distort_normalized(xy, k1, k2, p1, p2, k3)
    return torch.stack([xyd[..., 0] * fx + cx, xyd[..., 1] * fy + cy], dim=-1)


def remap_bilinear(img, grid):
    """cv::remap equivalent: sample ``img [H, W]`` at ``grid [H', W', 2]``
    (both on one device)."""
    H, W = img.shape
    x = torch.clamp(grid[..., 0], 0.0, W - 1.0)
    y = torch.clamp(grid[..., 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    fx_ = x - x0
    fy_ = y - y0
    flat = img.reshape(-1)

    def at(yy, xx):
        return flat[yy * W + xx]

    return (at(y0, x0) * (1 - fx_) * (1 - fy_)
            + at(y0, x0 + 1) * fx_ * (1 - fy_)
            + at(y0 + 1, x0) * (1 - fx_) * fy_
            + at(y0 + 1, x0 + 1) * fx_ * fy_)


def rodrigues(rvec):
    """Rotation vector -> matrix (cv::Rodrigues for the reference's
    ``Camera.rx/cv/rz`` relative-rotation flags,
    reference: src/selflocalization.cpp:486-487)."""
    rvec = torch.as_tensor(rvec, dtype=torch.float32)
    theta = torch.linalg.norm(rvec) + 1e-12
    k = rvec / theta
    zero = torch.zeros((), dtype=rvec.dtype, device=rvec.device)
    K = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)


def stereo_rectify(R, T, fx_l, fy_l, cx_l, cy_l, fx_r, fy_r, cx_r, cy_r):
    """Rectifying rotations + shared pinhole for a stereo pair.

    Geometric core of cv::stereoRectify with CALIB_ZERO_DISPARITY
    (reference: src/selflocalization.cpp:493): both cameras are rotated so
    their x-axes align with the baseline and share one orientation, making
    epipolar lines horizontal with equal y.  ``R, T``: pose of the right
    camera w.r.t. the left (p_r = R p_l + T).  Returns
    ``(R1, R2, (fx, fy, cx, cy), baseline)`` — new shared intrinsics keep
    the left focal length and average the principal points (the reference
    adopts P1's values the same way, :497-501; alpha-cropping is framing
    only and intentionally omitted).
    """
    R = torch.as_tensor(R, dtype=torch.float32)
    T = torch.as_tensor(T, dtype=torch.float32)
    c2 = -R.T @ T                       # right camera centre in left coords
    baseline = torch.linalg.norm(c2)
    e1 = c2 / (baseline + 1e-12)
    e1 = torch.where(e1[0] < 0, -e1, e1)  # +x toward the right camera
    z = torch.tensor([0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    z_avg = z + R.T @ z
    e2 = torch.linalg.cross(z_avg, e1)
    e2 = e2 / (torch.linalg.norm(e2) + 1e-12)
    e3 = torch.linalg.cross(e1, e2)
    R1 = torch.stack([e1, e2, e3])      # rows: rectified axes in left coords
    R2 = R1 @ R.T
    f_new = fx_l
    cx_new = 0.5 * (cx_l + cx_r)
    cy_new = 0.5 * (cy_l + cy_r)
    return R1, R2, (f_new, f_new, cx_new, cy_new), baseline
