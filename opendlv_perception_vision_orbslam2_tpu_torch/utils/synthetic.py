"""Synthetic stereo world in numpy: rendered corner sprites + ground truth.

Counterpart of the stereo parts of the reference package's
``utils/synthetic.py``: a random 3-D point cloud rendered as textured square
sprites with bilinear sub-pixel splatting, so the whole front end and the
tracker run with known ground truth and measurable ATE.  Rendering stays on
the host in float32, so frames are deterministic and need no device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .config import SystemConfig

SPRITE_R_DEF = 3


class SyntheticWorld(NamedTuple):
    points: np.ndarray       # [M, 3] float32 world points
    patterns: np.ndarray     # [M, (2R+1)^2] float32 per-point sprite texture


def _sprite_patterns(rng, n_points: int, sprite_r: int, coarse: int):
    """Band-limited random sprite textures [n, (2r+1)^2]: a coarse random
    grid bilinearly upsampled (white noise would alias under sub-pixel
    splatting)."""
    side = 2 * sprite_r + 1
    base = rng.uniform(40.0, 250.0, (n_points, coarse, coarse)).astype(np.float32)
    t = np.linspace(0.0, coarse - 1.0, side)
    i0 = np.clip(np.floor(t).astype(np.int64), 0, coarse - 2)
    f = (t - i0).astype(np.float32)
    rows = (1 - f)[None, :, None] * base[:, i0, :] + f[None, :, None] * base[:, i0 + 1, :]
    return (
        (1 - f)[None, None, :] * rows[:, :, i0] + f[None, None, :] * rows[:, :, i0 + 1]
    ).reshape(n_points, side * side)


def make_world(n_points: int = 600, seed: int = 0,
               x_range=(-25.0, 25.0), y_range=(-4.0, 3.0),
               z_range=(2.0, 60.0), sprite_r: int = SPRITE_R_DEF,
               coarse: int = 4) -> SyntheticWorld:
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [
            rng.uniform(*x_range, n_points),
            rng.uniform(*y_range, n_points),
            rng.uniform(*z_range, n_points),
        ],
        axis=-1,
    ).astype(np.float32)
    patterns = _sprite_patterns(rng, n_points, sprite_r, coarse)
    return SyntheticWorld(pts, patterns)


def straight_trajectory(n_frames: int, step: float = 0.35,
                        yaw_rate: float = 0.0, step_x: float = 0.0):
    """Ground-truth camera poses T_cw [N, 4, 4] float32: forward motion along
    +z (plus optional lateral ``step_x``) with optional constant yaw."""
    poses = []
    T_wc = np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        poses.append(np.linalg.inv(T_wc).astype(np.float32))
        dR = np.array(
            [
                [np.cos(yaw_rate), 0, np.sin(yaw_rate)],
                [0, 1, 0],
                [-np.sin(yaw_rate), 0, np.cos(yaw_rate)],
            ],
            dtype=np.float32,
        )
        step_T = np.eye(4, dtype=np.float32)
        step_T[:3, :3] = dR
        step_T[0, 3] = step_x
        step_T[2, 3] = step
        T_wc = T_wc @ step_T
    return np.stack(poses)


def render_view(T_cw, world: SyntheticWorld, height: int, width: int,
                fx: float, fy: float, cx: float, cy: float):
    """Render one grayscale view [H, W] float32 with bilinear sub-pixel splats
    (``np.add.at`` accumulates overlapping sprites)."""
    T_cw = np.asarray(T_cw, np.float32)
    r = (int(round(world.patterns.shape[1] ** 0.5)) - 1) // 2
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pts_cam = (world.points @ R.T + t).astype(np.float32)
    z = pts_cam[:, 2]
    inv_z = np.float32(1.0) / np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
    # The final multiply-add rounds once (float64 holds the float32 product
    # exactly), as a fused multiply-add does: sub-pixel positions then agree
    # with the reference package's fused render to float32 precision.
    u = ((np.float32(fx) * pts_cam[:, 0]).astype(np.float64) * inv_z + cx).astype(np.float32)
    v = ((np.float32(fy) * pts_cam[:, 1]).astype(np.float64) * inv_z + cy).astype(np.float32)
    visible = (z > 0.5) & (u > r + 1) & (u < width - r - 2) \
        & (v > r + 1) & (v < height - r - 2)
    u, v, pat = u[visible], v[visible], world.patterns[visible]

    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = (u - u0).astype(np.float32)
    fv = (v - v0).astype(np.float32)

    img = np.full((height, width), 12.0, np.float32)  # dim flat background
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    dy, dx = dy.reshape(-1), dx.reshape(-1)
    for (oy, ox, w) in (
        (0, 0, (1 - fu) * (1 - fv)),
        (0, 1, fu * (1 - fv)),
        (1, 0, (1 - fu) * fv),
        (1, 1, fu * fv),
    ):
        ys = v0[:, None] + dy[None, :] + oy
        xs = u0[:, None] + dx[None, :] + ox
        np.add.at(img, (ys, xs), pat * w[:, None])
    return np.clip(img, 0.0, 255.0)


def render_stereo_sequence(config: SystemConfig, n_frames: int = 30,
                           n_points: int = 600, seed: int = 0,
                           step: float = 0.35, yaw_rate: float = 0.0,
                           step_x: float = 0.0, z_range=(2.0, 60.0)):
    """Returns (imgs_left [N,H,W], imgs_right [N,H,W], T_cw_gt [N,4,4], world),
    all numpy float32."""
    cam = config.camera
    world = make_world(n_points, seed, z_range=z_range)
    poses = straight_trajectory(n_frames, step, yaw_rate, step_x)
    T_rl = np.array(
        [[1, 0, 0, -cam.baseline_m], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    view = lambda T: render_view(T, world, cam.height, cam.width,  # noqa: E731
                                 cam.fx, cam.fy, cam.cx, cam.cy)
    lefts = np.stack([view(T) for T in poses])
    rights = np.stack([view(T_rl @ T) for T in poses])
    return lefts, rights, poses, world
