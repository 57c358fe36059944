"""Hypothesis-batched EPnP RANSAC.

Counterpart of the reference package's ``optim/pnp.py`` (PnPsolver,
reference: src/pnpsolver.cpp): all 256 hypotheses run at once as a batch
dimension — identity-axis control points with closed-form barycentrics, the
M^T M null vector by Cholesky inverse iteration, R, t by Newton polar
iteration — and one batched projection scores every hypothesis on every
correspondence.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

N_HYPOTHESES = 256
SET_SIZE = 6   # 2n >= 12 equations for the dominant-null-space beta (N=1)


def _inv3(A):
    """Closed-form adjugate inverse of batched ``[..., 3, 3]``."""
    a = lambda i, j: A[..., i, j]  # noqa: E731
    c00 = a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)
    c01 = a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)
    c02 = a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)
    det = a(0, 0) * c00 + a(0, 1) * c01 + a(0, 2) * c02
    adj = torch.stack([
        torch.stack([c00,
                     a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2),
                     a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)], dim=-1),
        torch.stack([c01,
                     a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0),
                     a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)], dim=-1),
        torch.stack([c02,
                     a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1),
                     a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)], dim=-1),
    ], dim=-2)
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    return adj / det[..., None, None]


def _polar_rt(p_src, p_dst):
    """Rigid (R, t) aligning ``p_src -> p_dst`` (``[..., n, 3]``) by Newton
    polar iteration on the 3x3 cross-covariance."""
    mu_s = p_src.mean(dim=-2)
    mu_d = p_dst.mean(dim=-2)
    H = (p_dst - mu_d[..., None, :]).transpose(-1, -2) @ (p_src - mu_s[..., None, :])
    X = H / (torch.linalg.matrix_norm(H)[..., None, None] + 1e-12)
    for _ in range(8):  # Newton polar: X <- (X + X^-T)/2
        X = 0.5 * (X + _inv3(X).transpose(-1, -2))
    R = X
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t


def _epnp_single(p_w, uv, fx, fy, cx, cy):
    """EPnP on minimal sets ``p_w [..., n, 3]``, ``uv [..., n, 2]`` -> (R, t,
    ok): control points are the centroid + spread-scaled identity axes, the
    M^T M null vector comes from three Cholesky inverse iterations, R, t from
    Newton polar iteration (reference: src/pnpsolver.cpp:349-541).  ``ok`` is
    False where the Cholesky factorization failed (R, t are NaN there)."""
    dt, dev = p_w.dtype, p_w.device
    c0 = p_w.mean(dim=-2)
    centered = p_w - c0[..., None, :]
    s = torch.sqrt(torch.mean(torch.sum(centered * centered, dim=-1), dim=-1) / 3.0 + 1e-9)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    cw = torch.cat([c0[..., None, :], c0[..., None, :] + s[..., None, None] * eye3], dim=-2)

    beta3 = centered / s[..., None, None]                          # [..., n, 3]
    alpha = torch.cat([1.0 - beta3.sum(dim=-1, keepdim=True), beta3], dim=-1)

    # M matrix [..., 2n, 12] (reference: fill_M :410-433)
    u, v = uv[..., 0], uv[..., 1]
    zeros = torch.zeros_like(alpha)
    row_u = torch.cat([alpha * fx, zeros, alpha * (cx - u)[..., None]], dim=-1)
    row_v = torch.cat([zeros, alpha * fy, alpha * (cy - v)[..., None]], dim=-1)
    M = torch.cat([row_u, row_v], dim=-2)
    MtM = M.transpose(-1, -2) @ M
    tr = torch.diagonal(MtM, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-8 * tr + 1e-12
    eye12 = torch.eye(12, dtype=dt, device=dev)
    L, info = torch.linalg.cholesky_ex(MtM + eps[..., None, None] * eye12)
    ok = info == 0
    vker = torch.full(MtM.shape[:-1], 1.0 / math.sqrt(12.0), dtype=dt, device=dev)
    for _ in range(3):
        y = torch.linalg.solve_triangular(L, vker[..., None], upper=False)
        vker = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
        vker = vker / (torch.linalg.vector_norm(vker, dim=-1, keepdim=True) + 1e-20)
    cc = torch.stack([vker[..., 0:4], vker[..., 4:8], vker[..., 8:12]], dim=-1)  # [..., 4, 3]

    # beta (case N=1): match control-point distances, fix cheirality
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    dw = torch.stack([torch.linalg.vector_norm(cw[..., i, :] - cw[..., j, :], dim=-1)
                      for i, j in pairs], dim=-1)
    dc = torch.stack([torch.linalg.vector_norm(cc[..., i, :] - cc[..., j, :], dim=-1)
                      for i, j in pairs], dim=-1)
    beta = torch.sum(dw * dc, dim=-1) / (torch.sum(dc * dc, dim=-1) + 1e-12)
    cc = cc * beta[..., None, None]
    p_c = alpha @ cc                                               # [..., n, 3]
    flip = torch.sum(p_c[..., 2], dim=-1) < 0
    p_c = torch.where(flip[..., None, None], -p_c, p_c)

    R, t = _polar_rt(p_w, p_c)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    R = torch.where(ok[..., None, None], R, nan)
    t = torch.where(ok[..., None], t, nan)
    return R, t


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor   # [N] bool (best hypothesis)
    n_inliers: torch.Tensor


def sample_sets(valid, generator, n_hypotheses: int = N_HYPOTHESES):
    """``[n_hypotheses, SET_SIZE]`` correspondence indices drawn with
    replacement, biased to valid slots (the reference package draws the same
    distribution with ``jax.random.categorical`` over ``log(valid + 1e-9)``)."""
    weights = valid.to(torch.float32) + 1e-9
    idx = torch.multinomial(weights, n_hypotheses * SET_SIZE, replacement=True,
                            generator=generator)
    return idx.reshape(n_hypotheses, SET_SIZE)


def pnp_ransac(p_w, uv, sigma2, valid, generator=None, *, fx: float, fy: float,
               cx: float, cy: float, n_hypotheses: int = N_HYPOTHESES, idx=None):
    """Batched EPnP RANSAC over ``N`` 3D-2D correspondences.

    Hypothesis sets come from ``idx [n_hypotheses, 6]`` when given, else are
    drawn from ``generator``.  Inlier test: squared reprojection error <=
    5.991 * sigma2 (reference: src/pnpsolver.cpp:62-84, 282-347).
    """
    if idx is None:
        idx = sample_sets(valid, generator, n_hypotheses)
    idx = idx.to(device=p_w.device, dtype=torch.int64)
    sets_ok = torch.all(valid[idx], dim=1)

    Rs, ts = _epnp_single(p_w[idx], uv[idx], fx, fy, cx, cy)

    # score all hypotheses on all correspondences
    p_c = torch.einsum("bij,nj->bni", Rs, p_w) + ts[:, None, :]
    z = p_c[..., 2]
    z_ok = z > 1e-3
    zs = torch.where(z_ok, z, torch.ones_like(z))
    u_hat = fx * p_c[..., 0] / zs + cx
    v_hat = fy * p_c[..., 1] / zs + cy
    err2 = (uv[None, :, 0] - u_hat) ** 2 + (uv[None, :, 1] - v_hat) ** 2
    inl = (err2 <= 5.991 * sigma2[None, :]) & z_ok & valid[None, :] & sets_ok[:, None]
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts)[None]   # index_select keeps it on the device
    pick = lambda x: x.index_select(0, best)[0]  # noqa: E731
    return PnPResult(R=pick(Rs), t=pick(ts), inliers=pick(inl), n_inliers=pick(counts))
