"""Full-map global bundle adjustment: extraction, solve and write-back.

Counterpart of the reference package's ``models/global_ba.py``
(RunGlobalBundleAdjustment, reference: src/loopclosing.cpp:645-750): after a
loop correction every keyframe pose and map point is refined.  The whole map
becomes one flat edge list (every ``[K, F]`` binding an edge), the
matrix-free Schur-CG solver runs on one device, and write-back is an array
swap that folds the snapshot's result into the map as it is now; dropping
the solver object aborts it.  Single-device only: the edge-sharded solve is
ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

import torch

from ..ops import lie
from ..optim.ba import BAProblem
from ..optim.gba import (
    edge_sums, gba_core, gba_init_carry, global_bundle_adjust_chunk,
)
from ..utils.config import SystemConfig
from .map_state import MapState, recompute_covisibility


def extract_global_ba(m: MapState, scale_factor: float = 1.2) -> BAProblem:
    """Every keyframe optimizable; slot 0 (the oldest, insertion order) is
    pinned by the solver's ``fix_first_pose`` as the reference fixes
    keyframe 0 (src/orboptimizer.cpp:84-86)."""
    K, F, P = m.kf_capacity, m.feat_capacity, m.pt_capacity
    dev = m.kf_valid.device
    bound = m.kf_feat_valid & (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    base = torch.full((), scale_factor, dtype=torch.float32, device=dev)
    return BAProblem(
        T_opt=m.kf_T_cw,
        opt_valid=m.kf_valid,
        T_fix=torch.eye(4, dtype=torch.float32, device=dev)[None],
        fix_valid=torch.zeros((1,), dtype=torch.bool, device=dev),
        pts=m.pt_pos,
        pt_valid=m.pt_valid,
        e_kf=torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand(K, F).reshape(-1),
        e_pt=m.kf_obs_point.clamp(0, P - 1).reshape(-1),
        e_uv=m.kf_xy.reshape(-1, 2),
        e_ur=m.kf_uright.reshape(-1),
        e_sigma2=torch.pow(base, 2.0 * m.kf_octave.to(torch.float32)).reshape(-1),
        e_valid=bound.reshape(-1),
    )


def run_global_ba(m: MapState, config: SystemConfig, n_outer: int = 10,
                  cg_iters: int = 40, hold_cheirality: bool = False) -> MapState:
    """The blocking solve: refine the whole map and write it back
    (``hold_cheirality``: see ``optim/gba.py::_outer``)."""
    cam = config.camera
    prob = extract_global_ba(m, config.orb.scale_factor)
    T_opt, pts, _ = gba_core(prob, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
                             n_outer=n_outer, cg_iters=cg_iters, hold_cheirality=hold_cheirality)
    m = m._replace(kf_T_cw=torch.where(m.kf_valid[:, None, None], T_opt, m.kf_T_cw),
                   pt_pos=torch.where(m.pt_valid[:, None], pts, m.pt_pos))
    return m._replace(covis=recompute_covisibility(m))


def _merge_gba(m: MapState, T_new, pts_new, snap_T, snap_kf_id, snap_kf_valid, snap_pt_valid,
               snap_pt_first_kf_id) -> MapState:
    """Fold a finished GBA snapshot into the CURRENT map: keyframes and
    points that existed at snapshot time take their optimized values;
    everything created since rides its anchor's correction, the array form
    of the reference's spanning-tree propagation after GBA
    (src/loopclosing.cpp:694-741)."""
    K = m.kf_capacity
    same_kf = m.kf_valid & snap_kf_valid & (m.kf_id == snap_kf_id)
    # anchor = newest snapshot keyframe still alive (the temporal parent of
    # every keyframe added during the solve)
    anchor = torch.argmax(torch.where(same_kf, m.kf_id, -1))
    T_new_a = T_new.index_select(0, anchor[None])[0]
    snap_T_a = snap_T.index_select(0, anchor[None])[0]
    T_ride = (m.kf_T_cw @ lie.inv_T(snap_T_a)) @ T_new_a
    kf_T = torch.where(same_kf[:, None, None], T_new,
                       torch.where(m.kf_valid[:, None, None], T_ride, m.kf_T_cw))

    same_pt = m.pt_valid & snap_pt_valid & (m.pt_first_kf_id == snap_pt_first_kf_id)
    # new points ride their reference keyframe's correction when that
    # keyframe is part of the snapshot, else the anchor's
    ref = m.pt_ref_kf.clamp(0, K - 1).long()
    world_corr = lie.inv_T(T_new) @ snap_T    # moves world points old -> new
    wc = torch.where(same_kf[ref][:, None, None], world_corr[ref],
                     world_corr.index_select(0, anchor[None]))
    p_ride = (wc[:, :3, :3] @ m.pt_pos[:, :, None])[:, :, 0] + wc[:, :3, 3]
    pt_pos = torch.where(same_pt[:, None], pts_new,
                         torch.where(m.pt_valid[:, None], p_ride, m.pt_pos))
    m = m._replace(kf_T_cw=kf_T, pt_pos=pt_pos)
    return m._replace(covis=recompute_covisibility(m))


class IncrementalGBA:
    """Chunked full-map BA: one LM iteration per frame between tracking
    steps, the functional-state form of the reference's detached, abortable
    GBA thread (src/loopclosing.cpp:576-580, 645-750).  A new loop closure
    simply drops the instance (abort = discard)."""

    def __init__(self, m: MapState, config: SystemConfig, n_outer_total: int = 10,
                 cg_iters: int = 40):
        self.config = config
        self.prob = extract_global_ba(m, config.orb.scale_factor)
        self.sums = edge_sums(self.prob)      # the chunks' summation order, read once
        self.carry = gba_init_carry(self.prob)
        self.iters_left = n_outer_total
        self.cg_iters = cg_iters
        self.snap_T = m.kf_T_cw
        self.snap_kf_id = m.kf_id
        self.snap_kf_valid = m.kf_valid
        self.snap_pt_valid = m.pt_valid
        self.snap_pt_first_kf_id = m.pt_first_kf_id

    def step(self) -> bool:
        """One bounded chunk; True when the solve is finished."""
        cam = self.config.camera
        self.carry = global_bundle_adjust_chunk(
            self.prob, self.carry, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
            n_outer=1, cg_iters=self.cg_iters, sums=self.sums)
        self.iters_left -= 1
        return self.iters_left <= 0

    def merge(self, m: MapState) -> MapState:
        T_new, pts_new, _, _ = self.carry
        return _merge_gba(m, T_new, pts_new, self.snap_T, self.snap_kf_id, self.snap_kf_valid,
                          self.snap_pt_valid, self.snap_pt_first_kf_id)
