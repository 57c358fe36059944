"""Shared bundle-adjustment constants and helpers.

The subset of the reference package's ``optim/ba.py`` that the grid local
BA and the global BA import: the chi2 gates (g2o's 95 % quantiles for 2 and
3 DoF, reference: src/orboptimizer.cpp:537-538) and the closed-form 3x3
inverse (the global BA's landmark blocks).  The dense-W ``bundle_adjust``
itself is not ported: the grid solver replaced it on the production path.
"""

from __future__ import annotations

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _inv3x3(A):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A12 + c * A13
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]
