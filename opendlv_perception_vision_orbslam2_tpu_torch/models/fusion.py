"""Map-point fusion across covisible keyframes (SearchInNeighbors).

Counterpart of the reference package's ``models/fusion.py``
(Mapping::SearchInNeighbors + ORBmatcher::Fuse, reference:
src/mapping.cpp:564-644, src/orbmatcher.cpp:833-983): the new keyframe's
points are projected into each covisible neighbour, then the neighbours'
points into the new keyframe; a match on an unbound feature adds a binding,
a match on a feature bound to another point merges the two (loser -> winner
through one ``replace [P]`` table applied to the whole binding table).
"""

from __future__ import annotations

import torch

from ..ops import lie
from ..ops.hamming import MAX_DIST, TH_LOW, hamming_matrix
from ..ops.indexing import (
    fill_at, row, scatter_add, scatter_max, scatter_min, scatter_set, set_row, topk_stable,
)
from ..utils.config import SystemConfig
from .map_state import MapState, point_observation_counts, recompute_covisibility

N_FUSE_NEIGHBORS = 10   # reference: 10 covisible (stereo), src/mapping.cpp:569


def _log_scale(config: SystemConfig, device):
    return torch.log(torch.full((), config.orb.scale_factor, dtype=torch.float32,
                                device=device))


def _project_gate(m: MapState, pt_slots, T_cw, config: SystemConfig):
    """Frustum / scale-band / viewing-angle gate of map points against one
    pose; returns ``(visible, uv, predicted octave, z)``."""
    cam = config.camera
    P = m.pt_capacity
    ok = pt_slots >= 0
    slots = pt_slots.clamp(0, P - 1).to(torch.int64)
    p_w = m.pt_pos[slots]
    p_c = lie.transform_points(T_cw, p_w)
    z = p_c[:, 2]
    uv = lie.project(p_c, cam.fx, cam.fy, cam.cx, cam.cy)
    view = p_w - lie.inv_T(T_cw)[:3, 3]
    dist_w = torch.linalg.vector_norm(view, dim=-1) + 1e-9
    view_cos = torch.sum(view * m.pt_normal[slots], dim=-1) / dist_w
    visible = ok & m.pt_valid[slots] & (
        (z > 0.1)
        & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
        & (dist_w >= 0.8 * m.pt_min_dist[slots])
        & (dist_w <= 1.2 * m.pt_max_dist[slots])
        & (view_cos > 0.5)
    )
    ratio = torch.clamp(m.pt_max_dist[slots] / dist_w.clamp(min=1e-6), min=1.0)
    pred_oct = torch.ceil(torch.log(ratio) / _log_scale(config, ratio.device))
    pred_oct = pred_oct.to(torch.int32).clamp(0, config.orb.n_levels - 1)
    return visible, uv, pred_oct, z


def _fuse_core(kf_obs_point, pt_valid, counts, m: MapState, target_slot,
               cand_pt_slots, config: SystemConfig):
    """Fuse ``cand_pt_slots`` into keyframe ``target_slot`` over the
    mutable triple (bindings, point validity, observation counts); returns
    the new triple.  Positions, descriptors and geometry come from ``m``."""
    P, F = m.pt_capacity, m.feat_capacity
    dev = kf_obs_point.device
    sf = torch.full((), config.orb.scale_factor, dtype=torch.float32, device=dev)
    m = m._replace(kf_obs_point=kf_obs_point, pt_valid=pt_valid)
    T_t = row(m.kf_T_cw, target_slot)
    visible, uv, pred_oct, z = _project_gate(m, cand_pt_slots, T_t, config)
    slots = cand_pt_slots.clamp(0, P - 1).to(torch.int64)

    # spatial + octave gate, radius 3*scale(pred octave) (reference:
    # src/orbmatcher.cpp:864-875)
    radius = 3.0 * torch.pow(sf, pred_oct.to(torch.float32))
    f_xy = row(m.kf_xy, target_slot)
    f_oct = row(m.kf_octave, target_slot)
    f_valid = row(m.kf_feat_valid, target_slot) & row(m.kf_valid, target_slot)
    d_uv = f_xy[None, :, :] - uv[:, None, :]
    within = torch.maximum(torch.abs(d_uv[..., 0]), torch.abs(d_uv[..., 1])) <= radius[:, None]
    oct_ok = (f_oct[None, :] >= pred_oct[:, None] - 1) & (f_oct[None, :] <= pred_oct[:, None] + 1)
    # reprojection chi2 gate per feature octave; stereo features also check
    # the right-image coordinate (reference: src/orbmatcher.cpp:903-933)
    sigma2 = torch.pow(sf, 2.0 * f_oct.to(torch.float32))
    err2 = torch.sum(d_uv * d_uv, dim=-1)
    f_ur = row(m.kf_uright, target_slot)
    ur_hat = uv[:, 0] - config.camera.bf / z.clamp(min=1e-6)
    d_ur = f_ur[None, :] - ur_hat[:, None]
    chi_ok = torch.where(f_ur[None, :] >= 0, err2 + d_ur * d_ur <= 7.8 * sigma2[None, :],
                         err2 <= 5.99 * sigma2[None, :])

    gate = within & oct_ok & chi_ok & visible[:, None] & f_valid[None, :]
    dmat = hamming_matrix(m.pt_desc[slots], row(m.kf_desc, target_slot))
    big = MAX_DIST + 1
    d = torch.where(gate, dmat, big)
    best_f = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best_f[:, None])[:, 0]
    good = best_d <= TH_LOW

    # one candidate per feature (lowest distance, then lowest index)
    C = cand_pt_slots.shape[0]
    dd = torch.where(good, best_d, big)
    best_per_f = scatter_min(torch.full((F,), big, dtype=dd.dtype, device=dev), best_f, dd)
    keep = good & (dd <= best_per_f[best_f])
    order = torch.arange(C, device=dev)
    first_at = scatter_min(torch.full((F,), C, dtype=torch.int64, device=dev), best_f,
                           torch.where(keep, order, C))
    keep = keep & (first_at[best_f] == order)

    # split: bind vs merge
    target_row = row(kf_obs_point, target_slot)
    existing = target_row[best_f]
    is_new_bind = keep & (existing < 0)
    is_merge = keep & (existing >= 0) & (existing != slots)

    # --- new bindings -----------------------------------------------------
    new_row = scatter_max(target_row, torch.where(is_new_bind, best_f, F - 1),
                          torch.where(is_new_bind, slots, -1))
    kf_obs_point = set_row(kf_obs_point, target_slot, new_row)
    counts = scatter_add(counts, torch.where(is_new_bind, slots, P - 1),
                         is_new_bind.to(torch.int32))
    fill_at(counts, P - 1, 0)     # in place on the fresh tensor of each step below

    # --- merges: loser -> winner indirection ------------------------------
    exist_c = existing.clamp(0, P - 1).to(torch.int64)
    cand_wins = counts[slots] >= counts[exist_c]
    loser = torch.where(is_merge, torch.where(cand_wins, exist_c, slots), -1)
    winner = torch.where(is_merge, torch.where(cand_wins, slots, exist_c), -1)
    replace = scatter_set(torch.arange(P, device=dev),
                          torch.where(is_merge, loser.clamp(0, P - 1), P - 1),
                          torch.where(is_merge, winner, P - 1))
    fill_at(replace, P - 1, P - 1)
    # short chains (a loser that also wins elsewhere) resolve by a second
    # application
    replace = replace[replace]
    new_obs = torch.where(kf_obs_point >= 0,
                          replace[kf_obs_point.clamp(0, P - 1).long()].to(torch.int32),
                          kf_obs_point)
    dead = scatter_set(torch.zeros((P,), dtype=torch.bool, device=dev),
                       torch.where(loser >= 0, loser.clamp(0, P - 1), P - 1), loser >= 0)
    fill_at(dead, P - 1, False)
    # the winner absorbs the loser's observations (Replace merges counts;
    # the stage-end recount re-derives exact counts)
    loser_n = torch.where(loser >= 0, counts[loser.clamp(0, P - 1)], 0)
    counts = scatter_add(counts, torch.where(winner >= 0, winner.clamp(0, P - 1), P - 1), loser_n)
    fill_at(counts, P - 1, 0)
    counts = torch.where(dead, 0, counts)
    return new_obs, pt_valid & ~dead, counts


def run_fusion(m: MapState, new_kf_slot, config: SystemConfig,
               n_neighbors: int = N_FUSE_NEIGHBORS, update_covis: bool = True,
               counts=None):
    """SearchInNeighbors: fuse the new keyframe's points into each covisible
    neighbour, then the neighbours' points into the new keyframe.
    ``update_covis=False`` skips the tail covisibility rebuild; with
    ``counts`` returns ``(m, counts)``."""
    F, P = m.feat_capacity, m.pt_capacity
    dev = m.kf_obs_point.device
    nb_w, nb_slots = topk_stable(row(m.covis, new_kf_slot), n_neighbors)
    nb_ok = nb_w > 0

    new_pts = torch.where(row(m.kf_feat_valid, new_kf_slot),
                          row(m.kf_obs_point, new_kf_slot), -1)            # [F]
    # compress the forward list to the bound features (cap F: no drops)
    okm = new_pts >= 0
    rank = torch.cumsum(okm.to(torch.int64), 0) - 1
    dst = torch.where(okm & (rank < F), rank, F)
    new_pts = scatter_max(torch.full((F + 1,), -1, dtype=torch.int32, device=dev), dst,
                          torch.where(okm, new_pts, -1))[:F]

    with_counts = counts is not None
    if not with_counts:
        counts = point_observation_counts(m)

    obs, pt_valid = m.kf_obs_point, m.pt_valid
    for i in range(n_neighbors):
        obs_n, ptv_n, cnt_n = _fuse_core(obs, pt_valid, counts, m, nb_slots[i], new_pts, config)
        keep = nb_ok[i]
        obs = torch.where(keep, obs_n, obs)
        pt_valid = torch.where(keep, ptv_n, pt_valid)
        counts = torch.where(keep, cnt_n, counts)

    # reverse direction: neighbours' points into the new keyframe
    nb_binds = obs[nb_slots]                                               # [N, F]
    nb_bok = m.kf_feat_valid[nb_slots] & (nb_binds >= 0) & nb_ok[:, None]
    cand = torch.where(nb_bok, nb_binds, -1).reshape(-1)                   # [N*F]
    n = cand.shape[0]
    # dedupe: keep the first occurrence of each point slot
    safe = cand.clamp(0, P - 1)
    order = torch.arange(n, device=dev)
    first = scatter_min(torch.full((P,), n, dtype=torch.int64, device=dev), safe,
                        torch.where(cand >= 0, order, n))
    cand = torch.where((cand >= 0) & (first[safe.long()] == order), cand, -1)
    # compress to 2F slots (the distinct-point union of the window)
    rev_cap = 2 * F
    rank = torch.cumsum((cand >= 0).to(torch.int64), 0) - 1
    comp = scatter_max(torch.full((rev_cap,), -1, dtype=torch.int32, device=dev),
                       torch.where((cand >= 0) & (rank < rev_cap), rank, rev_cap - 1),
                       torch.where(cand >= 0, cand, -1))
    obs, pt_valid, counts = _fuse_core(obs, pt_valid, counts, m, new_kf_slot, comp, config)
    m = m._replace(kf_obs_point=obs, pt_valid=pt_valid)
    if update_covis:
        m = m._replace(covis=recompute_covisibility(m))
    return (m, counts) if with_counts else m

