"""Matching gated by projection or by BoW node (frame <-> frame / keyframe).

Counterpart of the reference package's ``ops/matching.py`` (ORBmatcher
SearchByProjection, reference: src/orbmatcher.cpp:1337-1483): the grid query
and per-point loops become one dense ``[S, K]`` boolean gate, the best match
per source point is a masked argmin over the Hamming matrix, and the
rotation histogram filter is shared with ``ops/hamming.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .hamming import MAX_DIST, TH_HIGH, TH_LOW, hamming_matrix, rotation_consistency_mask


class ProjectionMatches(NamedTuple):
    """Per-source-slot match results (padded, masked)."""

    dst_idx: torch.Tensor   # [S] int64 best destination feature index
    dist: torch.Tensor      # [S] Hamming distance (MAX_DIST+1 when no match)
    valid: torch.Tensor     # [S] bool


def _take(x, idx):
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _best_and_second(d, big: int):
    """Row argmin, its value, and the row minimum with that entry masked."""
    best = torch.argmin(d, dim=1)
    best_d = _take(d, best)
    d2 = d.scatter(1, best[:, None], big)
    return best, best_d, d2.min(dim=1).values


def search_by_projection(
    p_w, src_valid, src_desc, src_octave, src_angle, dst_features, T_cw, *,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    width: int, height: int, radius_th: float, scale_factor: float,
    max_dist: int = TH_HIGH, check_rotation: bool = True,
    forward_backward_gating: bool = True, z_motion=None, baseline: float = 0.0,
    dist=None, nn_ratio: float = 0.0,
):
    """Returns :class:`ProjectionMatches` over source slots.

    ``forward_backward_gating`` mirrors the reference's octave window choice
    by dominant camera z-motion (reference: src/orbmatcher.cpp:1361-1366,
    1395-1417); ``radius_th`` is 7 for stereo, x2 on retry (reference:
    src/tracking.cpp:718-748).
    """
    p_c = lie.transform_points(T_cw, p_w)
    z = p_c[:, 2]
    uv = lie.project(p_c, fx, fy, cx, cy)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < height)
        & (z > 0.1)
    )
    proj_ur = uv[:, 0] - bf / torch.clamp(z, min=0.1)

    sf = torch.full((), scale_factor, dtype=torch.float32, device=p_w.device)
    radius = radius_th * torch.pow(sf, src_octave.to(torch.float32))

    d_uv = dst_features.xy[None, :, :] - uv[:, None, :]
    within = torch.maximum(torch.abs(d_uv[..., 0]), torch.abs(d_uv[..., 1])) <= radius[:, None]

    oct_d = dst_features.octave[None, :]
    oct_s = src_octave[:, None]
    if forward_backward_gating and z_motion is not None:
        forward = z_motion > baseline
        backward = z_motion < -baseline
        oct_ok = torch.where(
            forward, oct_d >= oct_s,
            torch.where(backward, oct_d <= oct_s, torch.abs(oct_d - oct_s) <= 1),
        )
    else:
        oct_ok = torch.abs(oct_d - oct_s) <= 1

    # stereo right-u agreement (reference: src/orbmatcher.cpp:1422-1427)
    has_ur = dst_features.u_right[None, :] >= 0
    ur_ok = ~has_ur | (
        torch.abs(proj_ur[:, None] - dst_features.u_right[None, :]) <= radius[:, None]
    )

    gate = (
        within & oct_ok & ur_ok
        & src_valid[:, None] & in_img[:, None]
        & dst_features.valid[None, :]
    )

    if dist is None:
        dist = hamming_matrix(src_desc, dst_features.desc)
    big = MAX_DIST + 1
    d = torch.where(gate, dist, big)
    best, best_d, second = _best_and_second(d, big)
    ok = best_d <= max_dist

    if nn_ratio > 0.0:
        ok = ok & (best_d.to(torch.float32) <= nn_ratio * second.to(torch.float32))

    if check_rotation:
        ok = rotation_consistency_mask(src_angle, dst_features.angle, best, ok)

    return ProjectionMatches(dst_idx=best, dist=best_d, valid=ok)


def search_by_bow(desc_a, node_a, valid_a, angle_a, desc_b, node_b, valid_b, angle_b, *,
                  max_dist: int = TH_LOW, nn_ratio: float = 0.75,
                  check_rotation: bool = True):
    """BoW-node-gated descriptor matching (SearchByBoW, reference:
    src/orbmatcher.cpp:164-292 KF<->frame and :531-663 KF<->KF).  The
    reference walks the two feature vectors' shared vocabulary nodes; here
    the node agreement is a dense boolean gate on the Hamming matrix: the
    same association rule (same-node candidates, best + ratio test +
    rotation histogram), one masked argmin.  Returns
    ``(b_idx_per_a [A] int64, valid [A])``."""
    gate = ((node_a[:, None] == node_b[None, :]) & (node_a[:, None] >= 0)
            & valid_a[:, None] & valid_b[None, :])
    big = MAX_DIST + 1
    d = torch.where(gate, hamming_matrix(desc_a, desc_b), big)
    best, best_d, second = _best_and_second(d, big)
    ok = (best_d <= max_dist) & (
        best_d.to(torch.float32) <= nn_ratio * second.to(torch.float32))
    if check_rotation:
        ok = rotation_consistency_mask(angle_a, angle_b, best, ok)
    # one a per b (cross-duplicate resolution)
    m = resolve_duplicate_targets(ProjectionMatches(dst_idx=best, dist=best_d, valid=ok),
                                  desc_b.shape[0])
    return m.dst_idx, m.valid


def search_for_initialization(feats_a, feats_b, *, window: float = 100.0,
                              nn_ratio: float = 0.9, max_dist: int = TH_LOW,
                              check_rotation: bool = True):
    """Window-gated matching for monocular initialization
    (SearchForInitialization, reference: src/orbmatcher.cpp:411-529): only
    level-0 keypoints, a +-``window`` px search box, the best/second ratio
    0.9 and the rotation-consistency histogram, one a per b.  Returns
    ``(b_idx [A] int64, valid [A])``."""
    d_uv = feats_b.xy[None, :, :] - feats_a.xy[:, None, :]
    within = torch.maximum(torch.abs(d_uv[..., 0]), torch.abs(d_uv[..., 1])) <= window
    lvl0 = (feats_a.octave[:, None] == 0) & (feats_b.octave[None, :] == 0)
    gate = within & lvl0 & feats_a.valid[:, None] & feats_b.valid[None, :]
    big = MAX_DIST + 1
    d = torch.where(gate, hamming_matrix(feats_a.desc, feats_b.desc), big)
    best, best_d, second = _best_and_second(d, big)
    ok = (best_d <= max_dist) & (
        best_d.to(torch.float32) <= nn_ratio * second.to(torch.float32))
    if check_rotation:
        ok = rotation_consistency_mask(feats_a.angle, feats_b.angle, best, ok)
    m = resolve_duplicate_targets(ProjectionMatches(dst_idx=best, dist=best_d, valid=ok),
                                  feats_b.xy.shape[0])
    return m.dst_idx, m.valid


def resolve_duplicate_targets(matches: ProjectionMatches, n_dst: int):
    """Keep only the lowest-distance source per destination feature
    (scatter-min), ties broken by the lower source index."""
    big = MAX_DIST + 1
    dev = matches.dist.device
    d = torch.where(matches.valid, matches.dist, big).to(torch.int64)
    best_per_dst = torch.full((n_dst,), big, dtype=torch.int64, device=dev)
    best_per_dst.scatter_reduce_(0, matches.dst_idx, d, "amin", include_self=True)
    keep = matches.valid & (d <= best_per_dst[matches.dst_idx])
    S = d.shape[0]
    order = torch.arange(S, device=dev)
    first_at = torch.full((n_dst,), S, dtype=torch.int64, device=dev)
    first_at.scatter_reduce_(0, matches.dst_idx, torch.where(keep, order, S),
                             "amin", include_self=True)
    keep = keep & (first_at[matches.dst_idx] == order)
    return matches._replace(valid=keep)


def motion_ladder_match(p_w, usable, desc_s, oct_s, ang_s, depth_s,
                        cur_features, T_pred, *, fx, fy, cx, cy, bf,
                        width, height, scale_factor, z_motion, baseline,
                        th_far, radius_mult: int = 1, min_matches: int = 20):
    """Motion-model matching ladder (x1 -> x2 -> brute) over one shared
    Hamming matrix; the first sufficient rung wins by masked select
    (reference: src/tracking.cpp:744-748 retry, :587-629 fallback).  A rung
    is sufficient with enough matches AND enough close-point coverage.
    Returns ``(ProjectionMatches, n_matches)``."""
    dist = hamming_matrix(desc_s, cur_features.desc)
    big = MAX_DIST + 1

    def match_at(mult):
        m = search_by_projection(
            p_w, usable, desc_s, oct_s, ang_s, cur_features, T_pred,
            fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, width=width, height=height,
            radius_th=7.0 * mult * radius_mult, scale_factor=scale_factor,
            z_motion=z_motion, baseline=baseline, dist=dist, nn_ratio=0.0,
        )
        m = resolve_duplicate_targets(m, cur_features.capacity)
        return m, torch.sum(m.valid)

    def brute_match():
        # gate-free appearance rung: ratio test + mutual cross-check +
        # rotation consistency
        gate = usable[:, None] & cur_features.valid[None, :]
        d = torch.where(gate, dist, big)
        best, best_d, second = _best_and_second(d, big)
        ok = (best_d <= TH_HIGH) & (
            best_d.to(torch.float32) <= 0.8 * second.to(torch.float32)
        )
        back = torch.argmin(d, dim=0)
        ok = ok & (back[best] == torch.arange(d.shape[0], device=d.device))
        ok = rotation_consistency_mask(ang_s, cur_features.angle, best, ok)
        mb = ProjectionMatches(dst_idx=best, dist=best_d, valid=ok)
        mb = resolve_duplicate_targets(mb, cur_features.capacity)
        return mb, torch.sum(mb.valid)

    m1, n1 = match_at(1)
    m2, n2 = match_at(2)
    m8, n8 = brute_match()

    # Smallest radius with enough matches AND, for stereo, at least half the
    # widest gate's close-point matches (close points carry translation).
    close_src = (depth_s > 0) & (depth_s < th_far)
    c1 = torch.sum(m1.valid & close_src)
    c2 = torch.sum(m2.valid & close_src)
    c8 = torch.sum(m8.valid & close_src)
    has_close = torch.sum(close_src) > 0
    th_close = torch.clamp((c8 + 1) // 2, min=10)
    good1 = (n1 >= min_matches) & torch.where(has_close, c1 >= th_close, 2 * n1 >= n8)
    good2 = (n2 >= min_matches) & torch.where(has_close, c2 >= th_close, 2 * n2 >= n8)

    def pick(a, b, c):
        return torch.where(good1, a, torch.where(good2, b, c))

    m = ProjectionMatches(
        dst_idx=pick(m1.dst_idx, m2.dst_idx, m8.dst_idx),
        dist=pick(m1.dist, m2.dist, m8.dist),
        valid=pick(m1.valid, m2.valid, m8.valid),
    )
    return m, torch.sum(m.valid)
