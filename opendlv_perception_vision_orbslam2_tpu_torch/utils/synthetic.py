"""Synthetic world in numpy: rendered corner sprites, depth maps + ground truth.

Counterpart of the reference package's ``utils/synthetic.py``: a random 3-D
point cloud rendered as textured square sprites with bilinear sub-pixel
splatting (and, for RGB-D, a registered depth map), so the whole front end
and the tracker run with known ground truth and measurable ATE.  Rendering
stays on the host in float32, so frames are deterministic and need no
device.
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


def _sprite_radius(world: SyntheticWorld) -> int:
    return (int(round(world.patterns.shape[1] ** 0.5)) - 1) // 2


def _project_world(T_cw, world: SyntheticWorld, height: int, width: int,
                   fx: float, fy: float, cx: float, cy: float):
    """``(u, v, z, visible)`` of every world point: pixel coords, camera-frame
    depth, and whether its sprite lies inside the image."""
    T_cw = np.asarray(T_cw, np.float32)
    r = _sprite_radius(world)
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
    return u, v, z, visible


def render_view(T_cw, world: SyntheticWorld, height: int, width: int,
                fx: float, fy: float, cx: float, cy: float):
    """Render one grayscale view [H, W] float32 with bilinear sub-pixel splats
    (``np.add.at`` accumulates overlapping sprites)."""
    r = _sprite_radius(world)
    u, v, _, visible = _project_world(T_cw, world, height, width, fx, fy, cx, cy)
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


def render_depth_map(T_cw, world: SyntheticWorld, height: int, width: int,
                     fx: float, fy: float, cx: float, cy: float):
    """Per-pixel depth map [H, W] float32 for the RGB-D fixture, 0 where
    there is no measurement (the d > 0 rule of ComputeStereoFromRGBD,
    reference: src/orbframe.cpp:707-728).  Each visible point stamps its
    camera-frame z over its sprite's footprint plus a one-pixel rim, so
    every FAST corner of the gray render has a depth sample; the nearest
    depth wins where footprints overlap (out-of-image pixels are dropped,
    then ``np.minimum.at``)."""
    r = _sprite_radius(world)
    u, v, z, visible = _project_world(T_cw, world, height, width, fx, fy, cx, cy)
    dy, dx = np.mgrid[-r - 1: r + 2, -r - 1: r + 2]
    ys = np.round(v).astype(np.int64)[:, None] + dy.reshape(-1)[None, :]
    xs = np.round(u).astype(np.int64)[:, None] + dx.reshape(-1)[None, :]
    big = np.float32(1e9)
    stamp = np.broadcast_to(np.where(visible, z, big)[:, None], ys.shape)
    inside = (ys >= 0) & (ys < height) & (xs >= 0) & (xs < width)
    depth = np.full((height, width), big, np.float32)
    np.minimum.at(depth, (ys[inside], xs[inside]), stamp[inside])
    return np.where(depth >= big, np.float32(0.0), depth)


def render_rgbd_sequence(config: SystemConfig, n_frames: int = 30, n_points: int = 600,
                         seed: int = 0, step: float = 0.35, yaw_rate: float = 0.0):
    """Returns (imgs [N,H,W], depth_maps [N,H,W], T_cw_gt [N,4,4], world), all
    numpy float32: the left eye of :func:`render_stereo_sequence` with its
    depth maps."""
    cam = config.camera
    world = make_world(n_points, seed)
    poses = straight_trajectory(n_frames, step, yaw_rate)
    args = (world, cam.height, cam.width, cam.fx, cam.fy, cam.cx, cam.cy)
    grays = np.stack([render_view(T, *args) for T in poses])
    depths = np.stack([render_depth_map(T, *args) for T in poses])
    return grays, depths, poses, world


def circular_trajectory(n_frames: int, radius: float = 15.0, laps: float = 1.0):
    """Ground-truth poses T_cw [N, 4, 4] driving ``laps`` closed circles with
    the heading tangent (the loop-closure fixture: the camera re-enters its
    start region once per lap).  The circle's center is (radius, 0, 0): the
    drive starts at the origin facing +z, turning right."""
    poses = []
    for i in range(n_frames):
        th = 2.0 * np.pi * laps * i / n_frames
        c = np.array([radius * (1.0 - np.cos(th)), 0.0, radius * np.sin(th)])
        R_wc = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                        dtype=np.float32)
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = c
        poses.append(np.linalg.inv(T_wc).astype(np.float32))
    return np.stack(poses)


def make_ring_world(n_points: int = 1200, radius: float = 15.0, seed: int = 0,
                    r_off_range=(2.5, 12.0), y_range=(-3.5, 2.5), lateral_range=(-8.0, 8.0),
                    sprite_r: int = SPRITE_R_DEF, coarse: int = 4) -> SyntheticWorld:
    """World points in a band around the circular trajectory, ahead of the
    tangent, so every lap segment (the revisit included) sees dense texture.
    KITTI-size cameras have a narrow vertical field of view: push the band
    deeper (``r_off_range``) and flatter (``y_range``) for them."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n_points)
    r_off = rng.uniform(*r_off_range, n_points)
    y = rng.uniform(*y_range, n_points)
    cx = radius * (1 - np.cos(th))
    cz = radius * np.sin(th)
    tangent = np.stack([np.sin(th), np.zeros_like(th), np.cos(th)], -1)
    outward = np.stack([-np.cos(th), np.zeros_like(th), np.sin(th)], -1)
    lateral = rng.uniform(*lateral_range, n_points)
    pts = (np.stack([cx, np.zeros_like(cx), cz], -1) + tangent * r_off[:, None]
           + outward * lateral[:, None])
    pts[:, 1] = y
    patterns = _sprite_patterns(rng, n_points, sprite_r, coarse)
    return SyntheticWorld(pts.astype(np.float32), patterns)


def render_loop_sequence(config: SystemConfig, n_frames: int = 200, n_points: int = 1200,
                         seed: int = 0, radius: float = 15.0, laps: float = 2.0,
                         **world_kwargs):
    """Stereo render of a multi-lap circular drive (keyframe culling,
    capacity growth and loop closures).  ``world_kwargs`` go to
    :func:`make_ring_world`.  Returns (lefts, rights, T_cw_gt, world)."""
    cam = config.camera
    world = make_ring_world(n_points, radius, seed, **world_kwargs)
    poses = circular_trajectory(n_frames, radius, laps)
    T_rl = np.array([[1, 0, 0, -cam.baseline_m], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                    dtype=np.float32)
    view = lambda T: render_view(T, world, cam.height, cam.width,  # noqa: E731
                                 cam.fx, cam.fy, cam.cx, cam.cy)
    lefts = np.stack([view(T) for T in poses])
    rights = np.stack([view(T_rl @ T) for T in poses])
    return lefts, rights, poses, world


# ---------------------------------------------------------------------------
# A DBoW2 text vocabulary of ORBvoc's shape
# ---------------------------------------------------------------------------

ORBVOC_BRANCHING = 10      # ORBvoc.txt: k = 10, L = 6, 10^6 words
ORBVOC_LEVELS = 6
ORBVOC_TRAINED_LEVELS = 3
_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _flip_masks(rng, n: int, n_bits: int, chunk: int = 1 << 16) -> np.ndarray:
    """``[n, 32]`` uint8 masks with ``n_bits`` distinct bits set each, drawn
    ``chunk`` rows at a time (the draw does not depend on the machine)."""
    out = np.empty((n, 32), np.uint8)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        pos = np.argpartition(rng.random((m, 256), dtype=np.float32), n_bits, axis=1)[:, :n_bits]
        bits = np.zeros((m, 256), np.uint8)
        np.put_along_axis(bits, pos, 1, axis=1)
        out[s:s + m] = np.packbits(bits, axis=1, bitorder="little")
    return out


def _descend(level_desc, descs: np.ndarray, branching: int) -> np.ndarray:
    """Leaf index of each descriptor ``[M, 32]`` uint8 in a full tree stored
    level by level (``level_desc[d]``: the nodes at depth d + 1 in
    breadth-first order); among children at equal Hamming distance the
    first wins, as ``models.vocabulary.transform`` decides."""
    cur = np.zeros(len(descs), np.int64)
    lane = np.arange(branching)
    for nodes in level_desc:
        kids = cur[:, None] * branching + lane[None, :]
        d = _POPCOUNT8[descs[:, None, :] ^ nodes[kids]].sum(axis=-1, dtype=np.int32)
        cur = kids[np.arange(len(descs)), np.argmin(d, axis=1)]
    return cur


def write_orbvoc_text(path, descs, branching: int = ORBVOC_BRANCHING,
                      levels: int = ORBVOC_LEVELS, trained_levels: int = ORBVOC_TRAINED_LEVELS,
                      seed: int = 0) -> dict:
    """Write a DBoW2/ORB-SLAM2 text vocabulary of ORBvoc.txt's shape (the
    format ``models.vocabulary.load_text_vocabulary`` reads, reference:
    src/orbvocabulary.cpp:39-118): header ``k L 0 0`` (TF-IDF, L1), then one
    line per node below the root, ``parent_id is_leaf d0..d31 weight``, in
    breadth-first order, so node ``i`` is line ``i``.  Every internal node
    has ``branching`` children and every leaf sits at depth ``levels``:
    ``sum(k^d, d=1..L)`` lines and ``k^L`` words (1,111,110 and 10^6 with
    the defaults, ORBvoc's shape).

    ``descs [M, 8]`` (int32 or uint32 words of 256-bit ORB descriptors) are
    the training set, taken from images other than those the vocabulary
    will see, as ORBvoc's were.  The tree:

    - depths 1..``trained_levels``: ``train_vocabulary_np(descs, branching,
      trained_levels, seed)``, the port's hierarchical k-means;
    - every node that k-means left short of ``branching`` children, and
      every node below ``trained_levels``, gets the missing children from
      its own descriptor with ``16 + 8 * (levels - depth)`` distinct bits
      flipped (16 at the leaves, a mask drawn per child from
      ``np.random.default_rng(seed)``), fewer at each deeper level;
    - the weights are DBoW2's idf, ``ln(N / n_i)`` over the ``N`` training
      descriptors pushed through the finished tree, ``n_i`` of them reaching
      word ``i``; a word that none reaches gets ``ln(N)``; internal nodes 0.

    numpy only: the same descriptors and seed give the same file byte for
    byte.  Returns ``{"nodes", "words", "bytes"}``."""
    from ..models.vocabulary import _as_uint32, train_vocabulary_np

    u32 = _as_uint32(descs)
    node_desc, children, _, _, _, _, _ = train_vocabulary_np(u32, branching, trained_levels,
                                                             seed)
    node_u8 = node_desc.view(np.uint8).reshape(len(node_desc), 32)
    rng = np.random.default_rng(seed)
    # per level: the nodes' descriptors and their node ids in the trained
    # tree (-1 for a made node)
    parent_desc = node_u8[:1]
    parent_trained = np.zeros(1, np.int64)
    level_desc = []
    for depth in range(1, levels + 1):
        n = len(parent_desc) * branching
        desc = np.repeat(parent_desc, branching, axis=0) ^ _flip_masks(
            rng, n, 16 + 8 * (levels - depth))
        trained = -np.ones(n, np.int64)
        if depth <= trained_levels:
            for p, t in enumerate(parent_trained):
                kids = children[t][children[t] >= 0] if t >= 0 else ()
                for j, c in enumerate(kids):
                    desc[p * branching + j] = node_u8[c]
                    trained[p * branching + j] = c
        level_desc.append(desc)
        parent_desc, parent_trained = desc, trained

    n_words = branching ** levels
    word = _descend(level_desc, u32.view(np.uint8).reshape(len(u32), 32), branching)
    reached = np.bincount(word, minlength=n_words)
    idf = np.log(len(u32) / np.maximum(reached, 1))

    fmt = "%d %d " + " ".join(["%d"] * 32) + " %s\n"
    n_lines = 0              # the nodes above the level, the root left out
    with open(path, "w") as f:
        f.write(f"{branching} {levels} 0 0\n")
        for depth, desc in enumerate(level_desc, start=1):
            leaf = int(depth == levels)
            first_parent = n_lines - len(desc) // branching + 1     # 0 at depth 1: the root
            for s in range(0, len(desc), 1 << 16):
                part = desc[s:s + (1 << 16)]
                ids = np.arange(s, s + len(part))
                rows = np.concatenate([(first_parent + ids // branching)[:, None],
                                       np.full((len(part), 1), leaf), part], axis=1).tolist()
                weights = ([f"{w:.6f}" for w in idf[s:s + len(part)]] if leaf
                           else ["0"] * len(part))
                f.writelines(fmt % (*r, w) for r, w in zip(rows, weights))
            n_lines += len(desc)
        n_bytes = f.tell()
    return {"nodes": n_lines, "words": n_words, "bytes": n_bytes}
