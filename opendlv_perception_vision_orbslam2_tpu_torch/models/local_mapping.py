"""Local mapping: covisibility-window bundle adjustment over the map.

Counterpart of the grid path of the reference package's
``models/local_mapping.py`` (LocalBundleAdjustment, reference:
src/orboptimizer.cpp:463-798): ``KO`` optimizable keyframes (the new one and
its best covisible, the oldest first so it anchors the gauge), ``KFIX``
fixed observers and ``PL`` local points, all picked by masked top-k; the
window's ``[KW, F]`` binding tables are the edge set (optim/ba_grid.py).
The dense-W edge-list BA of the reference is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.indexing import (
    fill_at, row, scatter_add, scatter_min, scatter_set, set_row, topk_stable,
)
from ..optim.ba_grid import GridBAProblem, bundle_adjust_grid
from ..utils.config import SystemConfig
from .map_state import MapState, recompute_covisibility, refresh_windowed

KO_DEFAULT = 8       # optimizable window size
KFIX_DEFAULT = 8     # fixed observers
PL_DEFAULT = 4096    # local point capacity
_I32_MAX = 2**31 - 1


class GridExtract(NamedTuple):
    prob: GridBAProblem
    local_kf_slots: torch.Tensor    # [KO] map keyframe slots (-1 pad)
    local_pt_slots: torch.Tensor    # [PL] map point slots (-1 pad)
    window_kf_slots: torch.Tensor   # [KO+KFIX] all window slots (-1 pad)


def extract_local_ba_grid(m: MapState, center_slot, ko: int = KO_DEFAULT,
                          kfix: int = KFIX_DEFAULT, pl: int = PL_DEFAULT,
                          scale_factor: float = 1.2) -> GridExtract:
    """The fixed-shape local BA problem around ``center_slot``."""
    K, F, P = m.kf_capacity, m.feat_capacity, m.pt_capacity
    dev = m.kf_obs_point.device

    # --- optimizable window: center + best covisible, oldest first -------
    w = set_row(row(m.covis, center_slot), center_slot, -1)
    nb_w, nb_idx = topk_stable(w, ko - 1)
    local_slots = torch.cat([center_slot.reshape(1).to(torch.int64), nb_idx])
    local_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), nb_w > 0])
    local_ok = local_ok & m.kf_valid[local_slots]
    ids = torch.where(local_ok, m.kf_id[local_slots], _I32_MAX)
    oldest_pos = torch.argmin(ids)
    perm = torch.arange(ko, device=dev)
    perm = set_row(set_row(perm, torch.zeros((), dtype=torch.int64, device=dev), oldest_pos),
                   oldest_pos, 0)
    local_slots = local_slots[perm]
    local_ok = local_ok[perm]
    is_local = scatter_set(torch.zeros((K,), dtype=torch.bool, device=dev),
                           torch.where(local_ok, local_slots, K - 1), local_ok)

    # --- local point set (rank-compressed to PL) --------------------------
    binds = m.kf_obs_point[local_slots]
    b_ok = m.kf_feat_valid[local_slots] & (binds >= 0) & local_ok[:, None]
    pt_in = scatter_set(torch.zeros((P,), dtype=torch.bool, device=dev),
                        torch.where(b_ok, binds, P - 1).reshape(-1), b_ok.reshape(-1))
    fill_at(pt_in, P - 1, False)
    pt_in = pt_in & m.pt_valid
    rank = torch.cumsum(pt_in.to(torch.int64), 0) - 1
    pt_g2l = torch.where(pt_in & (rank < pl), rank, -1)
    local_pt_slots = scatter_set(
        torch.full((pl,), -1, dtype=torch.int32, device=dev),
        torch.where(pt_g2l >= 0, pt_g2l, pl - 1),
        torch.where(pt_g2l >= 0, torch.arange(P, device=dev), -1))
    pt_local_valid = local_pt_slots >= 0
    pts_local = torch.where(pt_local_valid[:, None],
                            m.pt_pos[local_pt_slots.clamp(0, P - 1).long()], 0.0)

    # --- fixed observers: non-local keyframes seeing local points ---------
    obs_c = m.kf_obs_point.clamp(0, P - 1).long()
    all_binds_local = m.kf_feat_valid & (m.kf_obs_point >= 0) & pt_in[obs_c]
    see_count = torch.where(m.kf_valid & ~is_local, all_binds_local.sum(dim=1), 0)
    fix_w, fix_slots = topk_stable(see_count, kfix)
    fix_ok = fix_w > 0

    # --- the grid ---------------------------------------------------------
    all_slots = torch.cat([local_slots, fix_slots])                   # [KW]
    all_ok = torch.cat([local_ok, fix_ok])
    KW = all_slots.shape[0]
    g_binds = m.kf_obs_point[all_slots]                               # [KW, F]
    g_bok = m.kf_feat_valid[all_slots] & (g_binds >= 0) & all_ok[:, None]
    g_pt = torch.where(g_bok, pt_g2l[g_binds.clamp(0, P - 1).long()], -1)
    g_valid = g_bok & (g_pt >= 0)
    sigma2 = torch.pow(torch.full((), scale_factor, dtype=torch.float32, device=dev),
                       2.0 * m.kf_octave[all_slots].to(torch.float32))

    # observation table: feature index of local point p in window KF w (the
    # lowest feature index when fusion bound a point twice in one keyframe)
    w_iota = torch.arange(KW, device=dev)[:, None].expand(KW, F)
    f_iota = torch.arange(F, device=dev)[None, :].expand(KW, F)
    tgt_p = torch.where(g_valid, g_pt.clamp(0, pl - 1), pl)
    obs_table = scatter_min(torch.full(((pl + 1) * KW,), F, dtype=torch.int64, device=dev),
                            (tgt_p * KW + w_iota).reshape(-1),
                            torch.where(g_valid, f_iota, F).reshape(-1))
    obs_table = obs_table.reshape(pl + 1, KW)[:pl]
    obs_table = torch.where(obs_table >= F, -1, obs_table)
    # dedup the grid against the table: one observation per KF per point
    sel = obs_table[g_pt.clamp(0, pl - 1), w_iota]
    g_valid = g_valid & (sel == f_iota)

    g_uv = m.kf_xy[all_slots]
    g_ur = m.kf_uright[all_slots]
    obs_f = obs_table.clamp(0, F - 1)
    o_valid = obs_table >= 0
    w_rows = torch.arange(KW, device=dev)[None, :]
    o_uv = g_uv[w_rows, obs_f]
    o_ur = torch.where(o_valid, g_ur[w_rows, obs_f], -1.0)
    o_sigma2 = torch.where(o_valid, sigma2[w_rows, obs_f], 1.0)

    pose_free = fill_at(local_ok.clone(), 0, False)     # the oldest anchors the gauge
    prob = GridBAProblem(
        T_all=m.kf_T_cw[all_slots], kf_valid=all_ok, pose_free=pose_free,
        pts=pts_local, pt_valid=pt_local_valid, g_pt=g_pt.clamp(-1, pl - 1).to(torch.int32),
        g_uv=g_uv, g_ur=g_ur, g_sigma2=sigma2, g_valid=g_valid,
        obs_table=obs_table.to(torch.int32), o_uv=o_uv, o_ur=o_ur, o_sigma2=o_sigma2,
        o_valid=o_valid,
    )
    return GridExtract(
        prob=prob,
        local_kf_slots=torch.where(local_ok, local_slots, -1).to(torch.int32),
        local_pt_slots=local_pt_slots,
        window_kf_slots=torch.where(all_ok, all_slots, -1).to(torch.int32),
    )


def write_back_local_ba_grid(m: MapState, ext: GridExtract, T_opt, pts,
                             grid_inlier) -> MapState:
    """Scatter optimized poses and points into the map and erase outlier
    observations (reference: src/orboptimizer.cpp:735-798)."""
    K, P, F = m.kf_capacity, m.pt_capacity, m.feat_capacity
    kf_ok = ext.local_kf_slots >= 0
    kf_tgt = torch.where(kf_ok, ext.local_kf_slots, K - 1).long()
    kf_T = torch.where(kf_ok[:, None, None], T_opt, m.kf_T_cw[kf_tgt])
    m = m._replace(kf_T_cw=scatter_set(m.kf_T_cw, kf_tgt, kf_T))

    pt_ok = ext.local_pt_slots >= 0
    pt_tgt = torch.where(pt_ok, ext.local_pt_slots, P - 1).long()
    pt_new = torch.where(pt_ok[:, None], pts, m.pt_pos[pt_tgt])
    m = m._replace(pt_pos=scatter_set(m.pt_pos, pt_tgt, pt_new))

    # outlier erasure: active grid slots that failed the final gate write
    # -1 under a min-scatter (others write INT_MAX, the identity)
    win_ok = ext.window_kf_slots >= 0
    bad = ext.prob.g_valid & ~grid_inlier & win_ok[:, None]
    KW = bad.shape[0]
    rows = torch.where(win_ok[:, None], ext.window_kf_slots[:, None].long(), K - 1).expand(KW, F)
    cols = torch.arange(F, device=bad.device)[None, :].expand(KW, F)
    obs = scatter_min(m.kf_obs_point.reshape(-1), (rows * F + cols).reshape(-1),
                      torch.where(bad, -1, _I32_MAX).reshape(-1))
    return m._replace(kf_obs_point=obs.reshape(K, F))


def local_mapping_step(m: MapState, center_slot, config: SystemConfig,
                       ko: int = KO_DEFAULT, kfix: int = KFIX_DEFAULT,
                       pl: int = PL_DEFAULT, update_covis: bool = True, counts=None):
    """Local BA around a new keyframe, write-back, and the windowed refresh
    of descriptors and normals.  With ``counts``, the erased outlier
    observations decrement their points' counts and ``(m, counts)`` is
    returned."""
    cam = config.camera
    ext = extract_local_ba_grid(m, center_slot, ko, kfix, pl, config.orb.scale_factor)
    res = bundle_adjust_grid(ext.prob, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf)
    m = write_back_local_ba_grid(m, ext, res.T_opt, res.pts, res.grid_inlier)
    # refresh point statistics after the window settles (reference:
    # src/mapping.cpp:627-640)
    m = refresh_windowed(m, ext.local_pt_slots, ext.window_kf_slots)
    if update_covis:
        m = m._replace(covis=recompute_covisibility(m))
    if counts is None:
        return m
    P = m.pt_capacity
    bad = ext.prob.g_valid & ~res.grid_inlier
    gpt = ext.local_pt_slots[ext.prob.g_pt.clamp(0, pl - 1).long()]     # [KW, F]
    counts = scatter_add(counts, torch.where(bad & (gpt >= 0), gpt.clamp(0, P - 1), P - 1).reshape(-1),
                         -bad.to(torch.int32).reshape(-1))
    fill_at(counts, P - 1, 0)
    return m, counts.clamp(min=0)
