"""Monocular two-view initialization: batched H/F RANSAC + reconstruction.

Counterpart of the reference package's ``models/initializer.py``
(OrbInitializer, reference: src/orbinitializer.cpp): 200 sets of 8 matches
each give a normalized-DLT homography and an eight-point fundamental
matrix (batched SVDs of ``[200, 16, 9]`` and ``[200, 8, 9]``), every
hypothesis of both models is scored against every match at once, the best
of each is refined by least squares over its inliers, and the model is
chosen by the score ratio RH > 0.40 (reference: :114-120).  The candidate
motions (the full 8-solution Faugeras set of the homography, the 4 of the
essential matrix) are triangulated and checked for cheirality, reprojection
and parallax as one batch, and the chosen model's acceptance gate decides
(ReconstructH / ReconstructF, reference: :468-730).

Ties go as in the reference package: ``argmax`` takes the first maximum, the
second-best homography motion is the second-largest count (``sort[-2]``).
The winners are read by ``index_select`` (indexing with a 0-d CUDA tensor
reads it back); the SVDs still read their convergence flags back to the
host on CUDA, which the initializer, running only until a map exists,
accepts.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import lie
from ..ops.indexing import row
from .triangulation import _intrinsics

N_RANSAC = 200          # reference: :84
SET_SIZE = 8
SIGMA = 1.0
TH_H = 5.991            # chi2 for H score (reference: CheckHomography :303)
TH_F = 3.841            # chi2 for F point-line (reference: CheckFundamental :388)
SCORE_GAMMA = 5.991     # score offset (reference uses th/thScore)


@functools.lru_cache(maxsize=8)
def _constants(device):
    """The sign patterns of the Faugeras cases and DecomposeE's W, copied to
    ``device`` once."""
    t = lambda v: torch.tensor(v, dtype=torch.float32).to(device)  # noqa: E731
    return (t([1.0, 1.0, -1.0, -1.0]), t([1.0, -1.0, 1.0, -1.0]), t([1.0, -1.0, -1.0, 1.0]),
            t([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]))


def _inv(A):
    return torch.linalg.inv_ex(A)[0]


def _normalize(pts, valid):
    """Zero-mean unit-average-abs-deviation normalization (reference:
    Normalize :747-792).  Returns ``(normalized pts, 3x3 transform)``."""
    n = torch.clamp(valid.sum(), min=1).to(pts.dtype)
    mean = torch.where(valid[:, None], pts, 0.0).sum(0) / n
    dev = torch.where(valid[:, None], torch.abs(pts - mean), 0.0).sum(0) / n
    s = 1.0 / torch.clamp(dev, min=1e-9)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * s, T


def _null_vector(A):
    """The right singular vector of the smallest singular value of
    ``[..., m, 9]`` (full ``V``: an 8x9 system needs the ninth)."""
    return torch.linalg.svd(A)[2][..., -1, :].reshape(A.shape[:-2] + (3, 3))


def _dlt_homography(p1, p2, w=None):
    """H from point pairs ``[..., n, 2]`` (reference: ComputeHomographyMatrix
    :225-264); row weights ``w`` give the least-squares refinement."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows_a = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    rows_b = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    return _null_vector(A)


def _eight_point_fundamental(p1, p2, w=None):
    """F from pairs with the rank-2 projection (reference:
    ComputeFundamentalMatrix :266-301)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], dim=-1)
    if w is not None:
        A = A * w[..., None]
    u, s, vt = torch.linalg.svd(_null_vector(A))
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ torch.diag_embed(s) @ vt


def _homogeneous(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)


def _score_homography(H, H_inv, p1, p2, valid):
    """Symmetric transfer chi2 score of ``H [..., 3, 3]`` (reference:
    CheckHomography :303-386).  Returns ``(score [...], inliers [..., N])``."""
    def transfer(Hm, a, b):
        proj = _homogeneous(a) @ Hm.transpose(-1, -2)
        w = torch.where(torch.abs(proj[..., 2]) < 1e-9, 1e-9, proj[..., 2])
        uv = proj[..., :2] / w[..., None]
        return ((uv - b) ** 2).sum(-1) / (SIGMA * SIGMA)

    c21 = transfer(H, p1, p2)
    c12 = transfer(H_inv, p2, p1)
    ok = (c21 <= TH_H) & (c12 <= TH_H) & valid
    score = (torch.where(valid & (c21 <= TH_H), SCORE_GAMMA - c21, 0.0)
             + torch.where(valid & (c12 <= TH_H), SCORE_GAMMA - c12, 0.0)).sum(-1)
    return score, ok


def _score_fundamental(F, p1, p2, valid):
    """Epipolar point-line chi2 score (reference: CheckFundamental
    :388-466)."""
    def line_dist2(Fm, a, b):
        line = _homogeneous(a) @ Fm.transpose(-1, -2)       # epipolar lines in image 2
        num = (line[..., 0] * b[..., 0] + line[..., 1] * b[..., 1] + line[..., 2]) ** 2
        den = line[..., 0] ** 2 + line[..., 1] ** 2
        return num / torch.clamp(den, min=1e-12) / (SIGMA * SIGMA)

    c2 = line_dist2(F, p1, p2)
    c1 = line_dist2(F.transpose(-1, -2), p2, p1)
    ok = (c2 <= TH_F) & (c1 <= TH_F) & valid
    score = (torch.where(valid & (c2 <= TH_F), SCORE_GAMMA - c2, 0.0)
             + torch.where(valid & (c1 <= TH_F), SCORE_GAMMA - c1, 0.0)).sum(-1)
    return score, ok


def _decompose_E(E):
    """The 4 candidate motions of an essential matrix (reference: DecomposeE
    :906-930).  Returns ``(R [4, 3, 3], t [4, 3])``."""
    u, _, vt = torch.linalg.svd(E)
    W = _constants(E.device)[3]
    R1 = u @ W @ vt
    R1 = R1 * torch.sign(lie.det3(R1))
    R2 = u @ W.T @ vt
    R2 = R2 * torch.sign(lie.det3(R2))
    t = u[:, 2]
    t = t / (torch.linalg.vector_norm(t) + 1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_homography(H, K):
    """Full 8-motion Faugeras decomposition of a pixel-space homography
    (ReconstructH, reference: src/orbinitializer.cpp:573-730): the 4 sign
    cases of (x1, x3) for each of the branches d' = d2 (rotation by theta)
    and d' = -d2 (rotation by phi with a reflection).  Returns ``(R [8, 3,
    3], t [8, 3])`` with unit ``t``."""
    A = _inv(K) @ H @ K
    Ua, sa, Vta = torch.linalg.svd(A)
    d1, d2, d3 = sa[0], sa[1], sa[2]
    s_det = lie.det3(Ua) * lie.det3(Vta)
    sx1, sx3, s_sin, _ = _constants(H.device)
    # x1/x3 terms (reference: :600-607)
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    x1s, x3s = sx1 * aux1, sx3 * aux3
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros_like(x1s), torch.ones_like(x1s)

    def motions(rp_rows, tp):
        Rp = torch.stack([torch.stack(r, dim=-1) for r in rp_rows], dim=-2)    # [4, 3, 3]
        R = (s_det * Ua) @ Rp @ Vta
        t = (Ua @ tp[..., None])[..., 0]
        return R, t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)

    # branch 1: d' = d2 (reference: :609-650)
    d13 = torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / d13 * one
    st = s_sin * (root / d13)
    R1, t1 = motions(((cos_t, zero, -st), (zero, one, zero), (st, zero, cos_t)),
                     torch.stack([x1s, zero, -x3s], dim=-1) * (d1 - d3))
    # branch 2: d' = -d2 (reference: :652-718)
    dm3 = torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / dm3 * one
    sp = s_sin * (root / dm3)
    R2, t2 = motions(((cos_p, zero, sp), (zero, -one, zero), (sp, zero, -cos_p)),
                     torch.stack([x1s, zero, x3s], dim=-1) * (d1 + d3))
    return torch.cat([R1, R2]), torch.cat([t1, t2])


def _check_motion(R, t, p1, p2, valid, K, th2: float = 4.0 * SIGMA * SIGMA):
    """Triangulate every match under each candidate ``(R [M, 3, 3], t [M,
    3])`` and count the cheirality + reprojection inliers, measuring the
    parallax (reference: CheckRT :795-904).  Returns ``(n_good [M], point_ok
    [M, N], X [M, N, 3], parallax_cos [M])``."""
    M, N = R.shape[0], p1.shape[0]
    P1 = K @ torch.cat([torch.eye(3, dtype=K.dtype, device=K.device),
                        torch.zeros((3, 1), dtype=K.dtype, device=K.device)], dim=1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)                       # [M, 3, 4]
    X = lie.triangulate_linear(P1.expand(M, 3, 4), P2, p1.expand(M, N, 2),
                               p2.expand(M, N, 2))
    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    z2 = Xc2[..., 2]

    def reproj2(P, uv):
        pr = _homogeneous(X) @ P.transpose(-1, -2)
        w = torch.where(torch.abs(pr[..., 2]) < 1e-9, 1e-9, pr[..., 2])
        return ((pr[..., :2] / w[..., None] - uv) ** 2).sum(-1)

    e1 = reproj2(P1, p1)
    e2 = reproj2(P2, p2)
    # parallax: the angle between the two rays
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    r2 = X - c2[:, None, :]
    cosp = (X * r2).sum(-1) / (torch.linalg.vector_norm(X, dim=-1)
                               * torch.linalg.vector_norm(r2, dim=-1) + 1e-12)
    # cheirality only where parallax is measurable (CheckRT,
    # reference: src/orbinitializer.cpp:848-858); only real-parallax points
    # become map points (:895-899)
    low_plx = cosp >= 0.99998
    cheir_ok = ((z1 > 0) | low_plx) & ((z2 > 0) | low_plx)
    passing = valid & cheir_ok & (e1 <= th2) & (e2 <= th2)
    n_good = passing.sum(-1)
    point_ok = passing & ~low_plx & (z1 > 0) & (z2 > 0)
    cos_sorted = torch.sort(torch.where(passing, cosp, 1.0), dim=-1).values
    k = torch.clamp(n_good - 1, max=50)
    k = torch.where(k < 0, k + N, k)              # index -1 is the last, as in the reference
    parallax_cos = cos_sorted.gather(-1, k[:, None])[:, 0]
    return n_good, point_ok, X, parallax_cos


class InitResult(NamedTuple):
    success: torch.Tensor          # [] bool
    T_21: torch.Tensor             # [4, 4] pose of frame 2 wrt frame 1 (t up to scale)
    points: torch.Tensor           # [N, 3] triangulated points in frame-1 coords
    point_ok: torch.Tensor         # [N] bool
    used_homography: torch.Tensor  # [] bool


def sample_sets(valid, generator):
    """``[N_RANSAC, SET_SIZE]`` match indices drawn with replacement, biased to
    valid matches (the reference package draws the same distribution with
    ``jax.random.categorical`` over ``log(valid + 1e-9)``)."""
    weights = valid.to(torch.float32) + 1e-9
    idx = torch.multinomial(weights, N_RANSAC * SET_SIZE, replacement=True,
                            generator=generator)
    return idx.reshape(N_RANSAC, SET_SIZE)


def initialize_two_view(xy1, xy2, valid, generator=None, *, fx: float, fy: float,
                        cx: float, cy: float, min_triangulated: int = 50,
                        sets=None) -> InitResult:
    """Monocular bootstrap from the matched keypoints ``xy1, xy2 [N, 2]``
    (``valid [N]``) of two frames.  The RANSAC sets are ``sets [200, 8]``
    when given, else drawn from ``generator``.  ``min_triangulated`` is the
    reference's minTriangulated = 50 (src/orbinitializer.cpp:468-571,
    700-730), which assumes its 2000-feature budget; smaller budgets scale
    it down."""
    dev = xy1.device
    K = _intrinsics(fx, fy, cx, cy, dev)[0]

    p1n, T1 = _normalize(xy1, valid)
    p2n, T2 = _normalize(xy2, valid)
    T2_inv = _inv(T2)
    if sets is None:
        sets = sample_sets(valid, generator)
    sets = sets.to(device=dev, dtype=torch.int64)
    a, b = p1n[sets], p2n[sets]                                         # [200, 8, 2]
    Hs = T2_inv @ _dlt_homography(a, b) @ T1
    h22 = Hs[:, 2, 2]
    Hs = Hs / torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)[:, None, None]
    Fs = T2.T @ _eight_point_fundamental(a, b) @ T1
    eye3 = torch.eye(3, dtype=Hs.dtype, device=dev)
    H_invs = _inv(Hs + 1e-12 * eye3)

    h_scores, _ = _score_homography(Hs, H_invs, xy1, xy2, valid)
    f_scores, _ = _score_fundamental(Fs, xy1, xy2, valid)
    bh, bf = torch.argmax(h_scores), torch.argmax(f_scores)
    SH, SF = row(h_scores, bh), row(f_scores, bf)
    H_best, F_best = row(Hs, bh), row(Fs, bf)
    _, h_inliers = _score_homography(H_best, _inv(H_best), xy1, xy2, valid)
    _, f_inliers = _score_fundamental(F_best, xy1, xy2, valid)

    # least-squares refinement on all inliers (normalized coords)
    H_ref = T2_inv @ _dlt_homography(p1n, p2n, h_inliers.to(p1n.dtype)) @ T1
    H_ref = H_ref / torch.where(torch.abs(H_ref[2, 2]) < 1e-12, 1e-12, H_ref[2, 2])
    F_ref = T2.T @ _eight_point_fundamental(p1n, p2n, f_inliers.to(p1n.dtype)) @ T1
    _, h_inl2 = _score_homography(H_ref, _inv(H_ref), xy1, xy2, valid)
    _, f_inl2 = _score_fundamental(F_ref, xy1, xy2, valid)
    better_h = h_inl2.sum() >= h_inliers.sum()
    better_f = f_inl2.sum() >= f_inliers.sum()
    H_best = torch.where(better_h, H_ref, H_best)
    h_inliers = torch.where(better_h, h_inl2, h_inliers)
    F_best = torch.where(better_f, F_ref, F_best)
    f_inliers = torch.where(better_f, f_inl2, f_inliers)
    use_H = SH / torch.clamp(SH + SF, min=1e-9) > 0.40   # reference: :114-120

    # candidate motions: 4 from E (DecomposeE, :906-930), the 8 Faugeras
    # solutions of the calibrated homography (ReconstructH, :573-730); each
    # model against its own inliers, each with the reference's own gate
    R_f, t_f = _decompose_E(K.T @ F_best @ K)
    R_h, t_h = decompose_homography(H_best, K)
    nh, gh, Xh, ph = _check_motion(R_h, t_h, xy1, xy2, h_inliers, K)
    nf, gf, Xf, pf = _check_motion(R_f, t_f, xy1, xy2, f_inliers, K)

    # H: a clear winner (second < 0.75 best), best > 0.9 N, enough points
    # and parallax (ReconstructH, :700-730)
    bh_i = torch.argmax(nh)
    nh_best = row(nh, bh_i)
    nh_second = torch.sort(nh).values[-2]
    ok_h = ((nh_second < 0.75 * nh_best) & (nh_best > 0.9 * h_inliers.sum())
            & (nh_best >= min_triangulated) & (row(ph, bh_i) < 0.9998))
    # F: maxGood >= max(0.9 N, minTriangulated) and no second similar
    # solution at 0.7 maxGood (ReconstructF, :468-571)
    bf_i = torch.argmax(nf)
    nf_best = row(nf, bf_i)
    nsimilar = (nf > 0.7 * nf_best).sum()
    ok_f = ((nf_best > 0.9 * f_inliers.sum()) & (nf_best >= min_triangulated)
            & (nsimilar == 1) & (row(pf, bf_i) < 0.9998))

    return InitResult(
        success=torch.where(use_H, ok_h, ok_f),
        T_21=lie.make_T(torch.where(use_H, row(R_h, bh_i), row(R_f, bf_i)),
                        torch.where(use_H, row(t_h, bh_i), row(t_f, bf_i))),
        points=torch.where(use_H, row(Xh, bh_i), row(Xf, bf_i)),
        point_ok=torch.where(use_H, row(gh, bh_i), row(gf, bf_i)),
        used_homography=use_H,
    )
