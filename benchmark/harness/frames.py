"""Camera frames of a sprite world along a path, made from a seed.

The one general generator of the benchmark's traffic.  A traffic file
(``benchmark/traffic/<name>.json``) gives its parameters: the path (a circle
or a line with a swinging heading), the step a frame, the world's band of
points around the path, its density, the depth range, and the frame kind
(a stereo pair, or gray and depth as TUM's PNGs hold them).  The camera comes
from the configuration.

The renderer is a frozen copy of the port's synthetic renderer
(``utils/synthetic.py``: band-limited 7x7 sprites splatted bilinearly on a
dim background, depth stamped over each sprite's footprint), so the program
never supplies its own inputs.  Frames are quantised to uint8 (depth to
uint16 at the configuration's DepthMapFactor) as KITTI's and TUM's PNGs are.
Only numpy is imported: :func:`serve_frames` runs in a process of its own.
"""

from __future__ import annotations

import math

import numpy as np

SPRITE_R = 3
BACKGROUND = 12.0


class Camera:
    """Intrinsics of the left (or only) camera, its baseline and distortion."""

    def __init__(self, width, height, fx, fy, cx, cy, bf=0.0, k1=0.0, k2=0.0, p1=0.0,
                 p2=0.0, k3=0.0, fps=15.0, depth_factor=1.0):
        self.width, self.height = int(width), int(height)
        self.fx, self.fy, self.cx, self.cy = float(fx), float(fy), float(cx), float(cy)
        self.baseline = float(bf) / float(fx)
        self.dist = (float(k1), float(k2), float(p1), float(p2), float(k3))
        self.fps = float(fps)
        self.depth_factor = float(depth_factor)


def camera_from_flags(flags) -> Camera:
    """The :class:`Camera` of a configuration's ``--key=value`` flags."""
    kv = dict(f[2:].split("=", 1) for f in flags if f.startswith("--") and "=" in f)
    g = lambda k, d=0.0: float(kv.get(k, d))  # noqa: E731
    return Camera(kv["width"], kv["height"], g("Camera.fx"), g("Camera.fy"), g("Camera.cx"),
                  g("Camera.cy"), g("Camera.bf"), g("Camera.k1"), g("Camera.k2"),
                  g("Camera.p1"), g("Camera.p2"), g("Camera.k3"), g("Camera.fps", 15.0),
                  g("DepthMapFactor", 1.0))


# ---------------------------------------------------------------------------
# The path
# ---------------------------------------------------------------------------

def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def pose(traffic: dict, i: int, fps: float) -> np.ndarray:
    """Ground truth ``T_cw`` [4, 4] float64 of frame ``i``; frame 0 is the
    identity.

    - ``circle``: a circle of ``radius`` m turning right, ``step`` m a frame,
      the heading tangent (the port's ``circular_trajectory``);
    - ``weave``: forward along the heading, ``step`` m a frame, the heading
      swinging ``swing_deg`` either way with a period of ``swing_period_s``."""
    p = traffic["path"]
    if p["kind"] == "circle":
        th = i * p["step"] / p["radius"]
        c = np.array([p["radius"] * (1.0 - math.cos(th)), 0.0, p["radius"] * math.sin(th)])
        R_wc = _rot_y(th)
    elif p["kind"] == "weave":
        amp = math.radians(p["swing_deg"])
        w = 2.0 * math.pi / (p["swing_period_s"] * fps)
        # the centre is the sum of the steps taken along each earlier heading
        k = np.arange(i)
        head = amp * np.sin(w * k)
        c = p["step"] * np.array([np.sin(head).sum(), 0.0, np.cos(head).sum()])
        R_wc = _rot_y(amp * math.sin(w * i))
    else:
        raise ValueError(f"unknown path kind {p['kind']!r}")
    T_cw = np.eye(4)
    T_cw[:3, :3] = R_wc.T
    T_cw[:3, 3] = -R_wc.T @ c
    return T_cw


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------

def _sprite_patterns(rng, n_points: int, coarse: int = 4) -> np.ndarray:
    """Band-limited random sprite textures [n, 49]: a coarse random grid
    bilinearly upsampled (white noise would alias under sub-pixel
    splatting)."""
    side = 2 * SPRITE_R + 1
    base = rng.uniform(40.0, 250.0, (n_points, coarse, coarse)).astype(np.float32)
    t = np.linspace(0.0, coarse - 1.0, side)
    i0 = np.clip(np.floor(t).astype(np.int64), 0, coarse - 2)
    f = (t - i0).astype(np.float32)
    rows = (1 - f)[None, :, None] * base[:, i0, :] + f[None, :, None] * base[:, i0 + 1, :]
    return ((1 - f)[None, None, :] * rows[:, :, i0]
            + f[None, None, :] * rows[:, :, i0 + 1]).reshape(n_points, side * side)


def make_world(traffic: dict, seed: int):
    """``(points [M, 3] float32, patterns [M, 49] float32)``.

    The points are drawn from ``seed`` in a band around the path's base
    curve, exactly ``points_per_m`` of it (each point's place along the
    curve jittered within its own stretch), so that every stretch holds the
    same number.  The sprites' textures are drawn from ``seed`` too.

    - ``circle``: the port's ``make_ring_world`` band: each point sits
      ``ahead`` m along the tangent and ``lateral`` m outward of a point of
      the whole circle, at height ``y``;
    - ``weave``: a corridor along +z over ``z`` m, ``lateral`` m wide and
      ``y`` m high."""
    w, p = traffic["world"], traffic["path"]
    rng = np.random.default_rng(seed)
    if p["kind"] == "circle":
        R = p["radius"]
        n = int(round(w["points_per_m"] * 2.0 * math.pi * R))
        th = (np.arange(n) + rng.uniform(0.0, 1.0, n)) * (2.0 * math.pi / n)
        ahead = rng.uniform(*w["ahead"], n)
        y = rng.uniform(*w["y"], n)
        lateral = rng.uniform(*w["lateral"], n)
        tangent = np.stack([np.sin(th), np.zeros_like(th), np.cos(th)], -1)
        outward = np.stack([-np.cos(th), np.zeros_like(th), np.sin(th)], -1)
        base = np.stack([R * (1 - np.cos(th)), np.zeros_like(th), R * np.sin(th)], -1)
        pts = base + tangent * ahead[:, None] + outward * lateral[:, None]
        pts[:, 1] = y
    else:
        z0, z1 = w["z"]
        n = int(round(w["points_per_m"] * (z1 - z0)))
        z = z0 + (np.arange(n) + rng.uniform(0.0, 1.0, n)) * ((z1 - z0) / n)
        pts = np.stack([rng.uniform(*w["lateral"], n), rng.uniform(*w["y"], n), z], -1)
    # the textures from a generator of their own, started anew from the seed
    return pts.astype(np.float32), _sprite_patterns(np.random.default_rng(seed), len(pts))


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _project(T_cw, points, cam: Camera, depth_range):
    """``(u, v, z, visible)``: each point's (distorted) pixel position, its
    camera-frame depth, and whether its sprite lies inside the image within
    the depth range."""
    T = np.asarray(T_cw, np.float32)
    pc = points @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    # points behind or beside the camera overflow here; they are not visible
    with np.errstate(over="ignore", invalid="ignore"):
        inv_z = np.float32(1.0) / np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
        x, y = pc[:, 0] * inv_z, pc[:, 1] * inv_z
        k1, k2, p1, p2, k3 = cam.dist
        r2 = x * x + y * y
        if any(cam.dist):
            # the OpenCV radial-tangential model, at each sprite's centre;
            # the polynomial is monotonic only near the axis, so rays beyond
            # 45 degrees off it are left out
            radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            x, y = (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                    y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)
        u = (np.float32(cam.fx) * x + np.float32(cam.cx)).astype(np.float32)
        v = (np.float32(cam.fy) * y + np.float32(cam.cy)).astype(np.float32)
    r = SPRITE_R
    visible = ((z > depth_range[0]) & (z < depth_range[1]) & (r2 < 1.0) & (u > r + 1)
               & (u < cam.width - r - 2) & (v > r + 1) & (v < cam.height - r - 2))
    return u, v, z, visible


def render_view(T_cw, points, patterns, cam: Camera, depth_range) -> np.ndarray:
    """One gray view [H, W] uint8: each visible sprite splatted bilinearly at
    its sub-pixel position (``np.add.at`` sums overlaps), then rounded."""
    r = SPRITE_R
    u, v, _, vis = _project(T_cw, points, cam, depth_range)
    u, v, pat = u[vis], v[vis], patterns[vis]
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = (u - u0).astype(np.float32)
    fv = (v - v0).astype(np.float32)
    img = np.full((cam.height, cam.width), BACKGROUND, np.float32)
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    dy, dx = dy.reshape(-1), dx.reshape(-1)
    for oy, ox, w in ((0, 0, (1 - fu) * (1 - fv)), (0, 1, fu * (1 - fv)),
                      (1, 0, (1 - fu) * fv), (1, 1, fu * fv)):
        np.add.at(img, (v0[:, None] + dy[None, :] + oy, u0[:, None] + dx[None, :] + ox),
                  pat * w[:, None])
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def render_depth(T_cw, points, cam: Camera, depth_range) -> np.ndarray:
    """Depth [H, W] uint16 at ``cam.depth_factor`` units a metre, 0 where
    nothing is measured: each visible sprite stamps its depth over its
    footprint and a one-pixel rim, the nearest winning where they overlap."""
    r = SPRITE_R
    u, v, z, vis = _project(T_cw, points, cam, depth_range)
    dy, dx = np.mgrid[-r - 1:r + 2, -r - 1:r + 2]
    ys = np.round(v[vis]).astype(np.int64)[:, None] + dy.reshape(-1)[None, :]
    xs = np.round(u[vis]).astype(np.int64)[:, None] + dx.reshape(-1)[None, :]
    stamp = np.broadcast_to(z[vis][:, None], ys.shape)
    inside = (ys >= 0) & (ys < cam.height) & (xs >= 0) & (xs < cam.width)
    big = np.float32(1e9)
    depth = np.full((cam.height, cam.width), big, np.float32)
    np.minimum.at(depth, (ys[inside], xs[inside]), stamp[inside])
    raw = np.where(depth >= big, 0.0, np.rint(depth * cam.depth_factor))
    return np.clip(raw, 0, 65535).astype(np.uint16)


class Sequence:
    """Frame ``i`` of a traffic mix on a camera, from a seed."""

    def __init__(self, traffic: dict, cam: Camera, seed: int):
        self.traffic, self.cam = traffic, cam
        self.points, self.patterns = make_world(traffic, seed)
        self.depth_range = tuple(traffic["world"].get("depth_range", (0.5, 1e9)))
        self.kind = traffic["frames"]

    def pose(self, i: int) -> np.ndarray:
        return pose(self.traffic, i, self.cam.fps)

    def frame(self, i: int):
        """``(a, b)``: the left and right uint8 images of a stereo pair, or
        the uint8 gray image and its uint16 depth."""
        T = self.pose(i)
        left = render_view(T, self.points, self.patterns, self.cam, self.depth_range)
        if self.kind == "stereo":
            T_rl = np.eye(4)
            T_rl[0, 3] = -self.cam.baseline
            return left, render_view(T_rl @ T, self.points, self.patterns, self.cam,
                                     self.depth_range)
        if self.kind == "rgbd":
            return left, render_depth(T, self.points, self.cam, self.depth_range)
        raise ValueError(f"unknown frame kind {self.kind!r}")


def slot_views(buf, cam: Camera, kind: str, n_slots: int) -> list:
    """``[(a, b)] * n_slots``: numpy views of a shared buffer, one frame a
    slot (``b`` is uint16 depth for ``rgbd``)."""
    shape = (cam.height, cam.width)
    n = cam.height * cam.width
    b_type = np.uint16 if kind == "rgbd" else np.uint8
    per = n + n * np.dtype(b_type).itemsize
    return [(np.ndarray(shape, np.uint8, buf, k * per),
             np.ndarray(shape, b_type, buf, k * per + n)) for k in range(n_slots)]


def slot_bytes(cam: Camera, kind: str) -> int:
    n = cam.height * cam.width
    return n * (3 if kind == "rgbd" else 2)


def serve_frames(traffic: dict, cam: Camera, seed: int, shm_name: str, n_slots: int,
                 free, ready, stop) -> None:
    """Render frames i = 0, 1, ... into free slots of the shared buffer
    ``shm_name`` and put ``(i, slot)`` on ``ready`` until ``stop`` is set:
    ``n_slots`` bounds how far this process runs ahead of the loop that
    takes the frames and hands their slots back on ``free``."""
    import queue as queue_mod
    from multiprocessing import shared_memory

    # the creating process owns the buffer and unlinks it
    shm = shared_memory.SharedMemory(name=shm_name)
    seq = Sequence(traffic, cam, seed)
    views = slot_views(shm.buf, cam, seq.kind, n_slots)
    i = 0
    try:
        while not stop.is_set():
            a, b = seq.frame(i)
            while not stop.is_set():
                try:
                    slot = free.get(timeout=0.2)
                    break
                except queue_mod.Empty:
                    continue
            else:
                break
            views[slot][0][...] = a
            views[slot][1][...] = b
            ready.put((i, slot))
            i += 1
    finally:
        del views
        shm.close()
