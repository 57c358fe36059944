"""Scale pyramid, 3x3 max pool and edge padding on ``[..., H, W]`` tensors.

Counterpart of the reference package's ``ops/image.py`` (cv::resize pyramid,
reference: src/orbextractor.cpp:654-678).  Images are float32 in 0..255.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static per-level (H, W) list, mirroring the reference's rounding
    (reference: src/orbextractor.cpp:657-659 cvRound(cols/scale))."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


@functools.lru_cache(maxsize=None)
def _pyramid_matrices(height: int, width: int, n_levels: int,
                      scale_factor: float):
    """Per-level precomposed interpolation matrices ``(Mh [H_l, H], Mw [W_l, W])``.

    Level l of the reference pyramid is a chain of bilinear resizes (level l
    from level l-1).  Each resize is linear, so the chain composes on the
    host (float64) into one pair of matrices per level:
    ``level_l = Mh_l @ img @ Mw_l^T``."""
    from . import resample
    shapes = pyramid_shapes(height, width, n_levels, scale_factor)
    mh = np.eye(height, dtype=np.float64)
    mw = np.eye(width, dtype=np.float64)
    out = []
    for lvl in range(1, n_levels):
        (h2, w2), (h1, w1) = shapes[lvl], shapes[lvl - 1]
        mh = resample._interp_matrix(h2, h1).astype(np.float64) @ mh
        mw = resample._interp_matrix(w2, w1).astype(np.float64) @ mw
        out.append((mh.astype(np.float32), mw.astype(np.float32)))
    return out


@functools.lru_cache(maxsize=None)
def _pyramid_tensors(height: int, width: int, n_levels: int,
                     scale_factor: float, device: torch.device):
    """The matrices of :func:`_pyramid_matrices` as ``(Mh, Mw^T)`` tensors
    on ``device``, uploaded once per shape (7 pairs are ~45 MB at KITTI
    size, too much to copy every frame)."""
    return [
        (torch.from_numpy(mh).to(device), torch.from_numpy(mw.T.copy()).to(device))
        for mh, mw in _pyramid_matrices(height, width, n_levels, scale_factor)
    ]


def build_pyramid(img, n_levels: int, scale_factor: float):
    """List of per-level float32 images ``[..., H_l, W_l]`` matching the
    reference's chained per-level resize, one matmul pair per level.

    Plain ``torch.matmul`` in full float32 (TF32 is off package-wide), the
    counterpart of the reference's ``Precision.HIGHEST`` matmuls."""
    h, w = img.shape[-2:]
    x = img.to(torch.float32)
    levels = [x]
    for mh, mwt in _pyramid_tensors(h, w, n_levels, scale_factor, x.device):
        levels.append(torch.matmul(mh, torch.matmul(x, mwt)))
    return levels


def edge_pad(x, top: int, bottom: int, left: int, right: int):
    """Replicate-pad the last two dims of ``[H, W]`` or ``[B, H, W]``
    (``jnp.pad(mode="edge")``; ``F.pad`` needs a channel dim for it)."""
    lead = x.shape[:-2]
    x4 = x.reshape(-1, 1, *x.shape[-2:])
    p = F.pad(x4, (left, right, top, bottom), mode="replicate")
    return p.reshape(*lead, *p.shape[-2:])


def max_pool_3x3_same(x):
    """3x3 max pool, stride 1, same shape, over the last two dims (for FAST
    non-max suppression); outside the image counts as ``finfo.min``."""
    neg = torch.finfo(x.dtype).min
    p = F.pad(x, (1, 1, 1, 1), mode="constant", value=neg)
    H, W = x.shape[-2:]
    best = x
    for dy in range(3):
        for dx in range(3):
            best = torch.maximum(best, p[..., dy : dy + H, dx : dx + W])
    return best
