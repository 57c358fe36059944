"""Bilinear resampling as a banded interpolation matrix, built on the host.

Counterpart of the reference package's ``ops/resample.py``: a bilinear
resize along one axis is exactly a banded matrix, so a resize becomes
``R_h @ img @ R_w^T``.  Replaces cv::resize in the reference front end
(reference: src/orbextractor.cpp:654-678) and at live ingest
(reference: src/selflocalization.cpp:279-294).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_out: int, n_in: int):
    """Bilinear interpolation matrix [n_out, n_in], half-pixel centers
    (the plain INTER_LINEAR convention of the reference's cv::resize —
    deliberately no antialias prefilter)."""
    m = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        c = (i + 0.5) * scale - 0.5
        c0 = int(np.floor(c))
        f = c - c0
        m[i, np.clip(c0, 0, n_in - 1)] += 1.0 - f
        m[i, np.clip(c0 + 1, 0, n_in - 1)] += f
    return m


@functools.lru_cache(maxsize=None)
def _interp_tensor(n_out: int, n_in: int, device: torch.device):
    """``_interp_matrix`` on ``device``, copied there once per shape."""
    return torch.from_numpy(_interp_matrix(n_out, n_in)).to(device)


def resize_bilinear(img, out_shape):
    """``[H, W] -> [H2, W2]`` bilinear resize as two matmuls on the image's
    device."""
    h2, w2 = out_shape
    h, w = img.shape
    rh = _interp_tensor(h2, h, img.device)
    rw = _interp_tensor(w2, w, img.device)
    return rh @ (img @ rw.T)
