"""FAST-9/16 corner scores as dense tensor ops (the plain PyTorch chain).

Counterpart of the reference package's ``ops/fast.py`` (OpenCV ``cv::FAST``
per cell, reference: src/orbextractor.cpp:950-956): the segment test runs on
every pixel at once over 16 shifted views, the response is OpenCV's V-score
(max over circular 9-arcs of the min of |p_i - p|), and NMS is a 3x3 max-pool
compare.  Every function takes ``[H, W]`` or ``[B, H, W]``.

This chain is also the plain version of the CUDA ``fast_nms`` kernel
(``ops/fast_kernel.py``); both use the same op tree, and since min/max and
negation are exact the two agree bit for bit.
"""

from __future__ import annotations

import torch

from .image import edge_pad, max_pool_3x3_same

# Full 16-point Bresenham circle of radius 3 in circular order, (dy, dx).
CIRCLE16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # contiguous run length for FAST-9/16


def _neighbor_views(img):
    """16 shifted ``[..., H, W]`` views of the circle neighbours over an
    edge-padded image (``jnp.pad(img, 3, mode="edge")`` in the reference)."""
    H, W = img.shape[-2:]
    p = edge_pad(img, 3, 3, 3, 3)
    return [p[..., 3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] for (dy, dx) in CIRCLE16]


def _arc_response(d):
    """Best circular 9-arc per pixel: min over each arc via a prefix-min
    doubling tree, then max over the 16 arcs."""
    p2 = [torch.minimum(d[i], d[(i + 1) % 16]) for i in range(16)]
    p4 = [torch.minimum(p2[i], p2[(i + 2) % 16]) for i in range(16)]
    p8 = [torch.minimum(p4[i], p4[(i + 4) % 16]) for i in range(16)]
    w9 = [torch.minimum(p8[i], d[(i + 8) % 16]) for i in range(16)]
    out = w9[0]
    for i in range(1, 16):
        out = torch.maximum(out, w9[i])
    return out


def fast_v_score(img):
    """Un-gated FAST V-score surface (no corner threshold applied)."""
    img = img.to(torch.float32)
    diff = [n - img for n in _neighbor_views(img)]   # p_i - p
    bright = _arc_response(diff)
    dark = _arc_response([-x for x in diff])
    return torch.maximum(bright, dark)


def fast_score_map(img, threshold: float):
    """Dense FAST-9/16 response: 0 where not a corner, else the V-score."""
    v = fast_v_score(img)
    return torch.where(v > threshold, v, torch.zeros_like(v))


COMPASS = (0, 4, 8, 12)  # indices into CIRCLE16: (-3, 0), (0, 3), (3, 0), (0, -3)


def compass_test(img, threshold: float):
    """FAST's classic early-out, as the CUDA kernel applies it: ``(bright,
    dark)`` masks of the pixels where at least 2 of the 4 compass points
    have ``d_i > threshold`` (bright) or ``-d_i > threshold`` (dark).

    Exact for any threshold: a polarity's 9-arc minimum exceeds the
    threshold only if all 9 ``d_i`` of some arc do, and any 9 consecutive
    circle points hold at least 2 compass points.  So where a mask is False
    that polarity's arc response is <= threshold, and where both are False
    ``fast_score_map`` is 0."""
    img = img.to(torch.float32)
    views = _neighbor_views(img)
    diff = [views[k] - img for k in COMPASS]
    bright = sum((d > threshold).to(torch.int32) for d in diff) >= 2
    dark = sum((-d > threshold).to(torch.int32) for d in diff) >= 2
    return bright, dark


def nms_scores(scores):
    """3x3 non-max suppression: keep only values >= all 8 neighbours."""
    local_max = max_pool_3x3_same(scores)
    return torch.where(scores >= local_max, scores, torch.zeros_like(scores))


def mask_border(scores, border: int):
    """Zero responses within ``border`` px of the image edge (reference:
    src/orbextractor.cpp:133-135, 916-921)."""
    H, W = scores.shape[-2:]
    out = torch.zeros_like(scores)
    if H <= 2 * border or W <= 2 * border:
        return out
    out[..., border : H - border, border : W - border] = \
        scores[..., border : H - border, border : W - border]
    return out


def subpixel_peak_from_patches(patches, center: int):
    """``[N, S, S]`` raw patches centred on corners -> ``[N, 2]`` (dx, dy)
    sub-pixel offsets: a 1-D parabola per axis through the un-gated V-score
    at the central 3x3 (reference: src/orbframe.cpp:641-649)."""
    crops = patches[:, center - 4 : center + 5, center - 4 : center + 5]
    v = fast_v_score(crops)[:, 3:6, 3:6]

    def fit(s_m, c, s_p):
        den = s_m + s_p - 2.0 * c
        off = torch.where(den < -1e-6, 0.5 * (s_m - s_p) / den,
                          torch.zeros_like(den))
        return torch.clamp(off, -0.5, 0.5)

    dx = fit(v[:, 1, 0], v[:, 1, 1], v[:, 1, 2])
    dy = fit(v[:, 0, 1], v[:, 1, 1], v[:, 2, 1])
    return torch.stack([dx, dy], dim=-1)
