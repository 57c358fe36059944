"""Keypoint undistortion (cv::undistortPoints in OrbFrame::UndistortKeyPoints,
reference: src/orbframe.cpp:448-479).

Counterpart of ``undistort_points`` in the reference package's
``ops/undistort.py``; rectification maps wait for a later slice.
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
