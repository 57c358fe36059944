"""Global map as fixed-capacity tensors with validity masks.

Counterpart of the reference package's ``models/map_state.py`` (OrbMap /
OrbKeyFrame / OrbMapPoint, reference: src/orbmap.cpp,
src/orbkeyframe.cpp:324-420, 493-600, src/orbmappoint.cpp:155-431): the map
is ONE NamedTuple of tensors, feature->point bindings are a dense ``[K, F]``
slot table, the covisibility graph is a ``[K, K]`` count matrix, and every
map update is a function that returns new tensors for what it changes (the
driver keeps snapshots of the map while a mapping stage is in flight).

Dump slots are kept exactly: masked point writes land on slot ``P-1``, which
is never allocated, and masked keyframe writes on ``K-1``.  Descriptors are
``int32`` with the reference's ``uint32`` bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie
from ..ops.hamming import popcount32
from ..ops.indexing import (
    as_like, fill_at, row, scatter_add, scatter_max, scatter_min, scatter_set, set_row,
)
from ..optim.pose_graph import block_order, block_sum
from .frame import FrameState

LOOP_EDGE_CAP = 32     # persistent loop-edge capacity
OBS_DESC_CAP = 16      # observation descriptors considered per point
_I32_MAX = 2**31 - 1


class MapState(NamedTuple):
    # --- keyframes (capacity K, feature capacity F) ---
    kf_valid: torch.Tensor       # [K] bool
    kf_id: torch.Tensor          # [K] int32 global keyframe id (-1 free)
    kf_T_cw: torch.Tensor        # [K, 4, 4]
    kf_xy: torch.Tensor          # [K, F, 2]
    kf_octave: torch.Tensor      # [K, F] int32
    kf_angle: torch.Tensor       # [K, F]
    kf_desc: torch.Tensor        # [K, F, 8] int32 (uint32 bits)
    kf_uright: torch.Tensor      # [K, F]
    kf_depth: torch.Tensor       # [K, F]
    kf_feat_valid: torch.Tensor  # [K, F] bool
    kf_obs_point: torch.Tensor   # [K, F] int32 point slot or -1
    # --- points (capacity P) ---
    pt_valid: torch.Tensor       # [P] bool
    pt_pos: torch.Tensor         # [P, 3]
    pt_desc: torch.Tensor        # [P, 8] int32 distinctive descriptor
    pt_normal: torch.Tensor      # [P, 3] mean viewing direction
    pt_min_dist: torch.Tensor    # [P] scale-invariance band lo
    pt_max_dist: torch.Tensor    # [P] scale-invariance band hi
    pt_ref_kf: torch.Tensor      # [P] int32 creating keyframe slot
    pt_first_kf_id: torch.Tensor  # [P] int32 keyframe id at creation
    pt_visible: torch.Tensor     # [P] int32 times predicted visible
    pt_found: torch.Tensor       # [P] int32 times actually matched
    # --- graph ---
    covis: torch.Tensor          # [K, K] int32 shared-point counts
    # --- counters ---
    next_kf_id: torch.Tensor     # [] int32
    next_pt_id: torch.Tensor     # [] int32
    # --- persistent loop edges (capacity L; filled by the loop slice) ---
    loop_i: torch.Tensor = None
    loop_j: torch.Tensor = None
    loop_T: torch.Tensor = None
    loop_s: torch.Tensor = None
    loop_valid: torch.Tensor = None

    @property
    def kf_capacity(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def pt_capacity(self) -> int:
        return self.pt_valid.shape[0]

    @property
    def feat_capacity(self) -> int:
        return self.kf_xy.shape[1]


def empty_map(kf_capacity: int, pt_capacity: int, feat_capacity: int,
              device="cpu") -> MapState:
    K, P, F = kf_capacity, pt_capacity, feat_capacity
    kw = dict(device=device)
    i32, f32 = torch.int32, torch.float32
    eye = torch.eye(4, dtype=f32, **kw)
    return MapState(
        kf_valid=torch.zeros((K,), dtype=torch.bool, **kw),
        kf_id=torch.full((K,), -1, dtype=i32, **kw),
        kf_T_cw=eye.repeat(K, 1, 1),
        kf_xy=torch.zeros((K, F, 2), dtype=f32, **kw),
        kf_octave=torch.zeros((K, F), dtype=i32, **kw),
        kf_angle=torch.zeros((K, F), dtype=f32, **kw),
        kf_desc=torch.zeros((K, F, 8), dtype=i32, **kw),
        kf_uright=torch.full((K, F), -1.0, dtype=f32, **kw),
        kf_depth=torch.full((K, F), -1.0, dtype=f32, **kw),
        kf_feat_valid=torch.zeros((K, F), dtype=torch.bool, **kw),
        kf_obs_point=torch.full((K, F), -1, dtype=i32, **kw),
        pt_valid=torch.zeros((P,), dtype=torch.bool, **kw),
        pt_pos=torch.zeros((P, 3), dtype=f32, **kw),
        pt_desc=torch.zeros((P, 8), dtype=i32, **kw),
        pt_normal=torch.zeros((P, 3), dtype=f32, **kw),
        pt_min_dist=torch.zeros((P,), dtype=f32, **kw),
        pt_max_dist=torch.full((P,), 1e9, dtype=f32, **kw),
        pt_ref_kf=torch.full((P,), -1, dtype=i32, **kw),
        pt_first_kf_id=torch.full((P,), -1, dtype=i32, **kw),
        pt_visible=torch.ones((P,), dtype=i32, **kw),
        pt_found=torch.ones((P,), dtype=i32, **kw),
        covis=torch.zeros((K, K), dtype=i32, **kw),
        next_kf_id=torch.zeros((), dtype=i32, **kw),
        next_pt_id=torch.zeros((), dtype=i32, **kw),
        loop_i=torch.zeros((LOOP_EDGE_CAP,), dtype=i32, **kw),
        loop_j=torch.zeros((LOOP_EDGE_CAP,), dtype=i32, **kw),
        loop_T=eye.repeat(LOOP_EDGE_CAP, 1, 1),
        loop_s=torch.ones((LOOP_EDGE_CAP,), dtype=f32, **kw),
        loop_valid=torch.zeros((LOOP_EDGE_CAP,), dtype=torch.bool, **kw),
    )


def pad_rows(x, n: int, fill=0):
    extra = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                       device=x.device)
    return torch.cat([x, extra])


def grow_map(m: MapState, new_kf_capacity: int, new_pt_capacity: int) -> MapState:
    """Grow the map to larger capacities by padding; slot indices are kept,
    so every binding and covisibility entry stays valid.  The old dump slots
    become ordinary free slots (invalid, rewritten at allocation)."""
    K, P = new_kf_capacity, new_pt_capacity
    dK = K - m.kf_capacity
    assert dK >= 0 and P >= m.pt_capacity
    eye_k = torch.eye(4, dtype=torch.float32, device=m.kf_T_cw.device).repeat(dK, 1, 1)
    covis = torch.zeros((K, K), dtype=m.covis.dtype, device=m.covis.device)
    covis[: m.kf_capacity, : m.kf_capacity] = m.covis
    return m._replace(
        kf_valid=pad_rows(m.kf_valid, K, False),
        kf_id=pad_rows(m.kf_id, K, -1),
        kf_T_cw=torch.cat([m.kf_T_cw, eye_k]),
        kf_xy=pad_rows(m.kf_xy, K),
        kf_octave=pad_rows(m.kf_octave, K),
        kf_angle=pad_rows(m.kf_angle, K),
        kf_desc=pad_rows(m.kf_desc, K),
        kf_uright=pad_rows(m.kf_uright, K, -1),
        kf_depth=pad_rows(m.kf_depth, K, -1),
        kf_feat_valid=pad_rows(m.kf_feat_valid, K, False),
        kf_obs_point=pad_rows(m.kf_obs_point, K, -1),
        pt_valid=pad_rows(m.pt_valid, P, False),
        pt_pos=pad_rows(m.pt_pos, P),
        pt_desc=pad_rows(m.pt_desc, P),
        pt_normal=pad_rows(m.pt_normal, P),
        pt_min_dist=pad_rows(m.pt_min_dist, P),
        pt_max_dist=pad_rows(m.pt_max_dist, P, 1e9),
        pt_ref_kf=pad_rows(m.pt_ref_kf, P, -1),
        pt_first_kf_id=pad_rows(m.pt_first_kf_id, P, -1),
        pt_visible=pad_rows(m.pt_visible, P, 1),
        pt_found=pad_rows(m.pt_found, P, 1),
        covis=covis,
    )


def add_loop_edge(m: MapState, cur_slot, cand_slot, T_rel, s_rel) -> MapState:
    """Record an accepted loop edge (AddLoopEdge, reference:
    src/orbkeyframe.cpp:458-470) in the first free slot; dropped when the
    edge list is full (the oldest edges matter most and stay).  The slots
    are 0-d tensors or host integers."""
    slot = torch.argmin(m.loop_valid.to(torch.int32))
    free = ~row(m.loop_valid, slot)

    def put(x, v):
        return set_row(x, slot, torch.where(free, as_like(v, x), row(x, slot)))

    return m._replace(loop_i=put(m.loop_i, cur_slot), loop_j=put(m.loop_j, cand_slot),
                      loop_T=put(m.loop_T, T_rel), loop_s=put(m.loop_s, s_rel),
                      loop_valid=set_row(m.loop_valid, slot, True))


# ---------------------------------------------------------------------------
# Covisibility
# ---------------------------------------------------------------------------


def _bound(m: MapState):
    return m.kf_feat_valid & (m.kf_obs_point >= 0) & m.kf_valid[:, None]


def incidence_matrix(m: MapState):
    """[K, P] 0/1 keyframe-observes-point incidence in float32: its Gram is
    exact up to 2^24 shared points (a bf16 product would round counts above
    256)."""
    K, F, P = m.kf_capacity, m.feat_capacity, m.pt_capacity
    binds = torch.where(_bound(m), m.kf_obs_point, P).to(torch.int64)   # dump column P
    rows = torch.arange(K, device=binds.device)[:, None].expand(K, F)
    inc = torch.zeros((K, P + 1), dtype=torch.float32, device=binds.device)
    inc = inc.index_put((rows, binds), torch.ones((), dtype=torch.float32, device=binds.device))
    return inc[:, :P]


def recompute_covisibility(m: MapState):
    """[K, K] shared-point counts as the incidence Gram matrix (replaces
    UpdateConnections' counting loops, reference: src/orbkeyframe.cpp:324-420)."""
    inc = incidence_matrix(m)
    w = (inc @ inc.T).to(torch.int32)
    K = w.shape[0]
    w = torch.where(torch.eye(K, dtype=torch.bool, device=w.device), 0, w)
    kmask = m.kf_valid
    return torch.where(kmask[:, None] & kmask[None, :], w, 0)


def covis_update_row(m: MapState, kf_slot) -> MapState:
    """Refresh ONE keyframe's covisibility row/column, counting shared
    points distinctly (a keyframe may bind one point at several features
    after fusion; the Gram dedups those too)."""
    P, F, K = m.pt_capacity, m.feat_capacity, m.kf_capacity
    dev = m.kf_obs_point.device
    bound = _bound(m)
    row_binds = row(m.kf_obs_point, kf_slot)
    row_bound = row(bound, kf_slot)
    # one local index per DISTINCT point of the new row (min feature wins)
    g2l = torch.full((P,), F, dtype=torch.int64, device=dev)
    g2l = scatter_min(g2l, torch.where(row_bound, row_binds, P - 1),
                      torch.where(row_bound, torch.arange(F, device=dev), F))
    fill_at(g2l, P - 1, F)        # in place on the fresh tensor
    loc = torch.where(bound, g2l[m.kf_obs_point.clamp(0, P - 1).long()], F)   # [K, F]
    rows = torch.arange(K, device=dev)[:, None].expand(K, F)
    seen = torch.zeros((K, F + 1), dtype=torch.bool, device=dev)
    seen = seen.index_put((rows, loc), torch.ones((), dtype=torch.bool, device=dev))
    w = seen[:, :F].sum(dim=1).to(m.covis.dtype)                            # [K]
    w = set_row(w, kf_slot, 0)
    w = torch.where(m.kf_valid & row(m.kf_valid, kf_slot), w, 0)
    covis = set_row(m.covis, kf_slot, w)
    covis = set_row(covis.T, kf_slot, w).T.contiguous()
    return m._replace(covis=covis)


# ---------------------------------------------------------------------------
# Keyframe insertion + stereo point creation
# ---------------------------------------------------------------------------


def _alloc_slot(valid_mask):
    """First free slot (argmin of validity); callers check capacity."""
    return torch.argmin(valid_mask.to(torch.int32))


def _alloc_point_slots(pt_valid, want_mask):
    """Allocate up to ``len(want_mask)`` free point slots: the rank-i wanted
    entry takes the rank-i free slot; -1 if out of capacity or not wanted.
    Slot ``P-1`` is the reserved scatter dump, never allocated."""
    P = pt_valid.shape[0]
    allocatable = fill_at(~pt_valid, P - 1, False)     # ``~`` made a new tensor
    free_order = torch.argsort((~allocatable).to(torch.int32), stable=True)
    n_free = allocatable.sum()
    want_rank = torch.cumsum(want_mask.to(torch.int64), 0) - 1
    ok = want_mask & (want_rank < n_free)
    slots = free_order[want_rank.clamp(0, P - 1)]
    return torch.where(ok, slots, -1).to(torch.int32)


def _write_points(m: MapState, created, new_slots, *, pos, desc, normal, min_dist,
                  max_dist, ref_kf, first_kf_id) -> MapState:
    """Write created points' attributes at ``new_slots`` (masked entries hit
    the dump slot ``P-1`` with its own value)."""
    P = m.pt_capacity
    safe = torch.where(created, new_slots, P - 1).to(torch.int64)

    def upd(arr, vals):
        vals = as_like(vals, arr).expand((safe.shape[0],) + tuple(arr.shape[1:]))
        mask = created.reshape((-1,) + (1,) * (arr.dim() - 1))
        return arr.index_put((safe,), torch.where(mask, vals, arr[safe]))

    return m._replace(
        pt_valid=m.pt_valid.index_put((safe,), created | m.pt_valid[safe]),
        pt_pos=upd(m.pt_pos, pos),
        pt_desc=upd(m.pt_desc, desc),
        pt_normal=upd(m.pt_normal, normal),
        pt_min_dist=upd(m.pt_min_dist, min_dist),
        pt_max_dist=upd(m.pt_max_dist, max_dist),
        pt_ref_kf=upd(m.pt_ref_kf, ref_kf),
        pt_first_kf_id=upd(m.pt_first_kf_id, first_kf_id),
        pt_visible=upd(m.pt_visible, 1),
        pt_found=upd(m.pt_found, 1),
    )


def insert_keyframe(m: MapState, frame: FrameState, tracked_point_slot,
                    close_depth_limit, min_total_points: int = 100,
                    covis_mode: str = "full"):
    """Insert a frame as a keyframe; create map points from stereo depth
    (Tracking::CreateNewKeyFrame, reference: src/tracking.cpp:898-976):
    tracked features keep their binding; unbound features with depth create
    points, all close ones plus the nearest beyond until
    ``min_total_points`` exist.  Returns ``(new_map, kf_slot)``."""
    F = m.feat_capacity
    feats = frame.features
    dev = feats.depth.device
    kf_slot = _alloc_slot(m.kf_valid)

    has_depth = (feats.depth > 0) & feats.valid
    unbound = has_depth & (tracked_point_slot < 0)
    depth_key = torch.where(unbound, feats.depth, float("inf"))
    order = torch.argsort(depth_key, stable=True)
    order_rank = torch.empty_like(order).scatter_(0, order, torch.arange(F, device=dev))
    want_new = unbound & ((feats.depth < close_depth_limit)
                          | (order_rank < min_total_points))
    new_slots = _alloc_point_slots(m.pt_valid, want_new)
    created = new_slots >= 0

    T_wc = lie.inv_T(frame.T_cw)
    p_w = lie.transform_points(T_wc, frame.point_cam)
    view = p_w - T_wc[:3, 3]
    dist = torch.linalg.vector_norm(view, dim=-1) + 1e-9
    normal = view / dist[:, None]
    # scale band (reference: src/orbmappoint.cpp:394-431)
    s12 = torch.full((), 1.2, dtype=torch.float32, device=dev)
    max_dist = dist * torch.pow(s12, feats.octave.to(torch.float32))
    min_dist = max_dist / torch.pow(s12, 7.0)
    m = _write_points(m, created, new_slots, pos=p_w, desc=feats.desc, normal=normal,
                      min_dist=min_dist, max_dist=max_dist, ref_kf=kf_slot,
                      first_kf_id=m.next_kf_id)
    bindings = torch.where(created, new_slots, tracked_point_slot).to(torch.int32)

    m = m._replace(
        kf_valid=set_row(m.kf_valid, kf_slot, True),
        kf_id=set_row(m.kf_id, kf_slot, m.next_kf_id),
        kf_T_cw=set_row(m.kf_T_cw, kf_slot, frame.T_cw),
        kf_xy=set_row(m.kf_xy, kf_slot, feats.xy),
        kf_octave=set_row(m.kf_octave, kf_slot, feats.octave),
        kf_angle=set_row(m.kf_angle, kf_slot, feats.angle),
        kf_desc=set_row(m.kf_desc, kf_slot, feats.desc),
        kf_uright=set_row(m.kf_uright, kf_slot, feats.u_right),
        kf_depth=set_row(m.kf_depth, kf_slot, feats.depth),
        kf_feat_valid=set_row(m.kf_feat_valid, kf_slot, feats.valid),
        kf_obs_point=set_row(m.kf_obs_point, kf_slot, bindings),
        next_kf_id=m.next_kf_id + 1,
    )
    if covis_mode == "row":
        # only the new keyframe's row changed (its new points have no other
        # observers yet)
        m = covis_update_row(m, kf_slot)
    else:
        m = m._replace(covis=recompute_covisibility(m))
    return m, kf_slot


# ---------------------------------------------------------------------------
# Point statistics
# ---------------------------------------------------------------------------


def point_observation_counts(m: MapState):
    """Observations per point slot (int32); the dump slot ``P-1`` reads 0."""
    P = m.pt_capacity
    bound = _bound(m)
    tgt = torch.where(bound, m.kf_obs_point, P - 1).reshape(-1)
    counts = torch.zeros((P,), dtype=torch.int32, device=tgt.device)
    counts = scatter_add(counts, tgt, bound.reshape(-1).to(torch.int32))
    return fill_at(counts, P - 1, 0)     # a fresh tensor: nothing else holds it


def refresh_windowed(m: MapState, pt_slots, kf_slots) -> MapState:
    """Distinctive descriptors (min median Hamming, OrbMapPoint::
    ComputeDistinctiveDescriptors, reference: src/orbmappoint.cpp:314-384)
    and mean normals of the points ``pt_slots [PL]`` (-1 pad), recomputed
    from their observations in the window keyframes ``kf_slots [KW]``."""
    P, F, K = m.pt_capacity, m.feat_capacity, m.kf_capacity
    PL = pt_slots.shape[0]
    C = OBS_DESC_CAP
    dev = pt_slots.device
    ar_pl = torch.arange(PL, device=dev)

    p_ok = pt_slots >= 0
    safe_pt = pt_slots.clamp(0, P - 1).to(torch.int64)
    g2l = scatter_set(torch.full((P,), PL, dtype=torch.int64, device=dev),
                      torch.where(p_ok, safe_pt, P - 1), torch.where(p_ok, ar_pl, PL))

    k_ok = kf_slots >= 0
    safe_kf = kf_slots.clamp(0, K - 1).to(torch.int64)
    binds = m.kf_obs_point[safe_kf]                                     # [KW, F]
    bound = (m.kf_feat_valid[safe_kf] & (binds >= 0)
             & k_ok[:, None] & m.kf_valid[safe_kf][:, None])
    safe_b = binds.clamp(0, P - 1).to(torch.int64)
    loc = torch.where(bound, g2l[safe_b], PL)                           # [KW, F]

    # --- distinctive descriptors over the window observations -----------
    flat_pt = loc.reshape(-1)
    flat_desc = m.kf_desc[safe_kf].reshape(-1, 8)
    order = torch.argsort(flat_pt, stable=True)
    sorted_pt = flat_pt[order].contiguous()
    sorted_desc = flat_desc[order]
    seg_start = torch.searchsorted(sorted_pt, sorted_pt, side="left")
    rank = torch.arange(sorted_pt.shape[0], device=dev) - seg_start
    ok = (sorted_pt < PL) & (rank < C)
    tgt = torch.where(ok, sorted_pt * C + rank, PL * C + C - 1)     # (PL, C-1) dump
    table = torch.zeros(((PL + 1) * C, 8), dtype=torch.int32, device=dev)
    table = table.index_put((tgt,), torch.where(ok[:, None], sorted_desc, 0))
    table = table.reshape(PL + 1, C, 8)[:PL]
    slot_valid = torch.zeros(((PL + 1) * C,), dtype=torch.bool, device=dev)
    slot_valid = slot_valid.index_put((tgt,), ok).reshape(PL + 1, C)[:PL]

    dist = popcount32(table[:, :, None, :] ^ table[:, None, :, :]).sum(-1, dtype=torch.int32)
    big = 257
    dist = torch.where(slot_valid[:, :, None] & slot_valid[:, None, :], dist, big)
    n_valid = slot_valid.sum(dim=1)
    dist_sorted = torch.sort(dist, dim=2).values
    med_pos = torch.div(n_valid - 1, 2, rounding_mode="floor").clamp(0, C - 1)
    median = torch.gather(dist_sorted, 2, med_pos[:, None, None].expand(PL, C, 1))[:, :, 0]
    median = torch.where(slot_valid, median, big)
    best = torch.argmin(median, dim=1)
    new_desc = table[ar_pl, best]                                      # [PL, 8]

    # --- normals from the window observations ----------------------------
    T = m.kf_T_cw[safe_kf]
    cam_centers = -torch.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])   # [KW, 3]
    view = m.pt_pos[safe_b] - cam_centers[:, None, :]
    nrm = view / (torch.linalg.vector_norm(view, dim=-1, keepdim=True) + 1e-9)
    flat_loc = loc.reshape(-1)
    # summed in the observations' order, on every device (a float index_add
    # is atomic on the card, so its bits would hang on arrival order)
    order, counts = block_order(flat_loc, PL + 1)
    normal_sum = block_sum(torch.where(bound[..., None], nrm, 0.0).reshape(-1, 3), order,
                           counts)[:PL]
    obs_count = counts[:PL]               # unbound observations go to block PL
    normals = normal_sum / obs_count.clamp(min=1)[:, None]

    # --- scatter back -----------------------------------------------------
    write = p_ok & (obs_count > 0)
    w_tgt = torch.where(write, safe_pt, P - 1)
    pt_desc = m.pt_desc.index_put(
        (w_tgt,), torch.where(write[:, None], new_desc, m.pt_desc[w_tgt]))
    pt_normal = m.pt_normal.index_put(
        (w_tgt,), torch.where(write[:, None], normals, m.pt_normal[w_tgt]))
    return m._replace(pt_desc=pt_desc, pt_normal=pt_normal)


# ---------------------------------------------------------------------------
# Culling
# ---------------------------------------------------------------------------


def reassign_point_refs(m: MapState, kill_orphans: bool = True) -> MapState:
    """Re-anchor points whose reference keyframe died to their oldest
    surviving observer (OrbKeyFrame::SetBadFlag / OrbMapPoint::
    EraseObservation, reference: src/orbkeyframe.cpp:493-600).  With
    ``kill_orphans`` (redundancy culling) points left with no observer die;
    without (capacity eviction) they re-anchor to the temporally nearest
    surviving keyframe."""
    K, F, P = m.kf_capacity, m.feat_capacity, m.pt_capacity
    dev = m.kf_obs_point.device
    bound = _bound(m)
    tgt = torch.where(bound, m.kf_obs_point, P - 1).reshape(-1)
    big = _I32_MAX
    kslots = torch.arange(K, dtype=torch.int32, device=dev)
    enc = torch.where(bound, m.kf_id[:, None] * K + kslots[:, None], big)
    best = scatter_min(torch.full((P,), big, dtype=torch.int32, device=dev), tgt,
                       enc.reshape(-1))
    has_obs = best < big
    rep = torch.where(has_obs, best % K, -1).to(torch.int32)

    safe_ref = m.pt_ref_kf.clamp(0, K - 1).to(torch.int64)
    ref_dead = (m.pt_ref_kf < 0) | ~m.kf_valid[safe_ref]
    if kill_orphans:
        new_ref = torch.where(ref_dead, rep, m.pt_ref_kf)
        orphan = m.pt_valid & ~has_obs & ref_dead
        return m._replace(pt_ref_kf=new_ref, pt_valid=m.pt_valid & ~orphan)
    ids = torch.where(m.kf_valid, m.kf_id, big)
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order].contiguous()
    n_valid = m.kf_valid.sum()
    pos = torch.searchsorted(sorted_ids, m.pt_first_kf_id.contiguous())
    lo = (pos - 1).clamp(0, K - 1)
    hi = torch.minimum(pos, n_valid - 1).clamp(0, K - 1)
    d_lo = torch.abs(m.pt_first_kf_id - sorted_ids[lo])
    d_hi = torch.abs(sorted_ids[hi] - m.pt_first_kf_id)
    near = torch.where(d_lo <= d_hi, order[lo], order[hi]).to(torch.int32)
    fallback = torch.where(has_obs, rep, near)
    return m._replace(pt_ref_kf=torch.where(ref_dead, fallback, m.pt_ref_kf))


def evict_oldest_if_full(m: MapState, min_free: int = 1) -> MapState:
    """Slot-recycling backstop for the fixed keyframe capacity: with fewer
    than ``min_free`` free slots, retire the second-oldest keyframe (the
    oldest anchors the gauge; loop anchors are protected)."""
    K = m.kf_capacity
    dev = m.kf_valid.device
    big = _I32_MAX
    full = m.kf_valid.sum() > K - min_free
    ids = torch.where(m.kf_valid, m.kf_id, big)
    protected = torch.zeros((K,), dtype=torch.int32, device=dev)
    protected = scatter_max(protected, m.loop_i, m.loop_valid.to(torch.int32))
    protected = scatter_max(protected, m.loop_j, m.loop_valid.to(torch.int32))
    ids = torch.where(protected > 0, big, ids)
    oldest = torch.argmin(ids)
    victim = torch.argmin(set_row(ids, oldest, big))
    kf_valid = set_row(m.kf_valid, victim, torch.where(full, False, row(m.kf_valid, victim)))
    none = torch.full((m.feat_capacity,), -1, dtype=torch.int32, device=dev)
    cleared = torch.where(full, none, row(m.kf_obs_point, victim))
    m = m._replace(kf_valid=kf_valid, kf_obs_point=set_row(m.kf_obs_point, victim, cleared))
    # eviction keeps the victim's points (the region's memory)
    m = reassign_point_refs(m, kill_orphans=False)
    return m._replace(covis=recompute_covisibility(m))


def cull_points(m: MapState, current_kf_id, th_obs: int = 3, counts=None):
    """MapPointCulling (reference: src/mapping.cpp:527-562): recent points
    need found/visible >= 0.25 and more than ``th_obs`` observations once
    two keyframes old.  With ``counts`` returns ``(m, counts)`` with the
    killed points zeroed."""
    P = m.pt_capacity
    obs = point_observation_counts(m) if counts is None else counts
    age = current_kf_id - m.pt_first_kf_id
    ratio = m.pt_found.to(torch.float32) / m.pt_visible.clamp(min=1)
    bad = (ratio < 0.25) | ((age >= 2) & (obs <= th_obs))
    kill = m.pt_valid & (age <= 3) & bad
    killed_of = (m.kf_obs_point >= 0) & kill[m.kf_obs_point.clamp(0, P - 1).long()]
    m = m._replace(
        pt_valid=m.pt_valid & ~kill,
        kf_obs_point=torch.where(killed_of, -1, m.kf_obs_point),
    )
    if counts is None:
        return m
    return m, torch.where(kill, 0, counts)


def cull_keyframes(m: MapState, protect_slot, update_covis: bool = True,
                   counts=None) -> MapState:
    """KeyFrameCulling (reference: src/mapping.cpp:646-710): a keyframe of
    the new keyframe's covisible window whose tracked points are >= 90 %
    seen by >= 3 OTHER keyframes at the same or finer scale (a per-point
    octave histogram) is redundant; at most one is culled per call, never
    the new keyframe or slot 0.  ``counts`` is accepted for API parity."""
    P, F = m.pt_capacity, m.feat_capacity
    L = 8
    dev = m.kf_obs_point.device
    bound = _bound(m)
    oct_c = m.kf_octave.clamp(0, L - 1).to(torch.int64)
    tgt_p = torch.where(bound, m.kf_obs_point, P - 1).clamp(0, P - 1).to(torch.int64)
    hist = torch.zeros((P * L,), dtype=torch.int32, device=dev)
    hist = scatter_add(hist, (tgt_p * L + oct_c).reshape(-1),
                       bound.reshape(-1).to(torch.int32)).reshape(P, L)
    cum = torch.cumsum(hist, dim=1)
    lvl = (oct_c + 1).clamp(0, L - 1)
    n_scale_obs = cum[tgt_p, lvl] - 1
    n_tracked = bound.sum(dim=1)
    n_redundant = (bound & (n_scale_obs >= 3)).sum(dim=1)
    redundant = (
        m.kf_valid
        & (n_redundant > (0.9 * n_tracked).to(torch.int32))
        & (n_tracked > 0)
        & (row(m.covis, protect_slot) > 0)
    )
    redundant = set_row(redundant, protect_slot, False)
    fill_at(redundant, 0, False)
    victim = torch.argmax(redundant.to(torch.int32))
    do_cull = torch.any(redundant)
    none = torch.full((F,), -1, dtype=torch.int32, device=dev)
    m = m._replace(
        kf_valid=set_row(m.kf_valid, victim, torch.where(do_cull, False,
                                                         row(m.kf_valid, victim))),
        kf_obs_point=set_row(m.kf_obs_point, victim,
                             torch.where(do_cull, none, row(m.kf_obs_point, victim))),
    )
    m = reassign_point_refs(m)
    if update_covis:
        m = m._replace(covis=recompute_covisibility(m))
    return m
