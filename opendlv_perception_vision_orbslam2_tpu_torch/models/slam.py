"""Stereo SLAM: tracking against the map + the keyframe mapping stage.

Counterpart of the reference package's ``models/slam.py`` (Tracking::Track
-> TrackLocalMap -> NeedNewKeyFrame -> CreateNewKeyFrame, and the Mapping
thread's loop body, reference: src/tracking.cpp:262-339, 696-976,
src/mapping.cpp:48-116), without loop closing and relocalization.

Device programs are plain functions on tensors: ``track_frame_with_map``
per frame, ``insert_stage`` + ``mapping_stage`` per keyframe.  The host
driver ``StereoSlam`` keeps the reference's staged pipeline: the mapping
stage is dispatched without waiting for it, its small result vector is
copied into pinned host memory behind a CUDA event, and the stage is adopted
once the event has completed; the per-frame decision statistics come back
the same way, one frame late.  One CUDA stream orders everything, so the
tracker's next kernels run after the stage's on the device.

Frame<->map binding: ``bindings [F] int32`` maps current-frame features to
map point slots (-1 = none), the analogue of ``OrbFrame::m_mapPoints``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie, matching
from ..ops.hamming import MAX_DIST, TH_HIGH, hamming_matrix
from ..ops.indexing import row, scatter_add, scatter_max, scatter_set, topk_stable
from ..optim.pose_opt import PoseObs, pose_optimize, robust_pose_estimate
from ..utils.config import SystemConfig
from .frame import FrameState, features_scale_sigma2
from .frontend import process_stereo
from .fusion import run_fusion
from .local_mapping import local_mapping_step
from .map_state import (
    MapState, cull_keyframes, cull_points, empty_map, evict_oldest_if_full, grow_map,
    insert_keyframe, point_observation_counts, recompute_covisibility,
)
from .tracking import MIN_MATCHES_MOTION
from .triangulation import create_new_map_points

N_LOCAL_KFS = 10       # local-map keyframe window (reference caps at 80,
                       # src/tracking.cpp:1121; 10 covers the covisible core)
PL_TRACK = 8192        # local point capacity for frame tracking
MIN_INLIERS_MAP = 30   # TrackLocalMap acceptance (reference: src/tracking.cpp:800)


class TrackOutputs(NamedTuple):
    T_cw: torch.Tensor
    bindings: torch.Tensor          # [F] point slot per current feature (-1 none)
    n_inliers: torch.Tensor         # after local-map pose optimization
    n_matches_mm: torch.Tensor      # motion-model matches
    n_tracked_close: torch.Tensor
    n_untracked_close: torch.Tensor
    pt_visible_delta: torch.Tensor  # [P] int32
    pt_found_delta: torch.Tensor    # [P] int32


def _mark(P, slots, ok):
    """``[P]`` bool: True at ``slots`` where ``ok`` (dump slot P-1 cleared)."""
    out = scatter_set(torch.zeros((P,), dtype=torch.bool, device=slots.device),
                      torch.where(ok, slots, P - 1).reshape(-1), ok.reshape(-1))
    out[P - 1] = False
    return out


def _motion_model_match(m: MapState, last_frame: FrameState, last_bindings, T_pred,
                        velocity, cur_frame: FrameState, config: SystemConfig):
    """Projection match vs the last frame with the multi-radius ladder:
    bound features take their map point's position, the others their
    stereo unprojection (UpdateLastFrame, reference: src/tracking.cpp:631-694)."""
    cam = config.camera
    feats_last = last_frame.features
    P = m.pt_capacity
    bound = last_bindings >= 0
    safe_b = last_bindings.clamp(0, P - 1).long()
    p_w_vo = lie.transform_points(lie.inv_T(last_frame.T_cw), last_frame.point_cam)
    p_w = torch.where(bound[:, None], m.pt_pos[safe_b], p_w_vo)
    th_far = config.tracking.th_depth * cam.baseline_m
    has_depth = (feats_last.depth > 0) & feats_last.valid
    usable = (bound & m.pt_valid[safe_b] & feats_last.valid) | (
        has_depth & (feats_last.depth < th_far))
    mm, n = matching.motion_ladder_match(
        p_w, usable, feats_last.desc, feats_last.octave, feats_last.angle,
        feats_last.depth, cur_frame.features, T_pred,
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
        width=cam.width, height=cam.height, scale_factor=config.orb.scale_factor,
        z_motion=velocity[2, 3], baseline=cam.baseline_m, th_far=th_far,
        min_matches=MIN_MATCHES_MOTION,
    )
    return mm, p_w, n


def _local_point_window(m: MapState, bindings):
    """Local map = points of the keyframes sharing most points with the
    current frame, recency breaking ties (UpdateLocalKeyFrames /
    UpdateLocalPoints, reference: src/tracking.cpp:1031-1175).  Returns
    ``local_pts [PL_TRACK]`` map slots (-1 pad)."""
    P = m.pt_capacity
    dev = bindings.device
    cur_bound = _mark(P, bindings.long(), bindings >= 0)
    obs_c = m.kf_obs_point.clamp(0, P - 1).long()
    sees = m.kf_feat_valid & (m.kf_obs_point >= 0) & cur_bound[obs_c] & m.kf_valid[:, None]
    share = sees.sum(dim=1)
    # packed (share, recency) rank: share <= 2^11-1, id <= 2^20-1
    rank_score = torch.where(
        m.kf_valid,
        share.clamp(max=(1 << 11) - 1) * (1 << 20) + m.kf_id.clamp(0, (1 << 20) - 1),
        -1)
    top_w, top_kfs = topk_stable(rank_score, N_LOCAL_KFS)
    # zero-share keyframes join only when nothing shares at all (recovery)
    kf_ok = torch.where(torch.any(share > 0), top_w >= (1 << 20), top_w >= 0)
    binds = m.kf_obs_point[top_kfs]                                   # [NK, F]
    b_ok = m.kf_feat_valid[top_kfs] & (binds >= 0) & kf_ok[:, None]
    pt_in = _mark(P, binds.long(), b_ok) & m.pt_valid
    rank = torch.cumsum(pt_in.to(torch.int64), 0) - 1
    g2l = torch.where(pt_in & (rank < PL_TRACK), rank, -1)
    return scatter_set(torch.full((PL_TRACK,), -1, dtype=torch.int32, device=dev),
                       torch.where(g2l >= 0, g2l, PL_TRACK - 1),
                       torch.where(g2l >= 0, torch.arange(P, device=dev), -1))


def _search_local_points(m: MapState, local_pts, bindings, T_cw, cur_frame: FrameState,
                         config: SystemConfig, radius_scale: float = 1.0):
    """Project unbound local points into the frame and match by descriptor
    (SearchLocalPoints, reference: src/tracking.cpp:978-1029,
    src/orbmatcher.cpp:42-128).  Returns ``(new bindings, [P] visible delta)``."""
    cam = config.camera
    P = m.pt_capacity
    dev = bindings.device
    sf = torch.full((), config.orb.scale_factor, dtype=torch.float32, device=dev)
    slots = local_pts.clamp(0, P - 1).long()
    already = _mark(P, bindings.long(), bindings >= 0)
    ok = (local_pts >= 0) & ~already[slots]

    p_w = m.pt_pos[slots]
    p_c = lie.transform_points(T_cw, p_w)
    z = p_c[:, 2]
    uv = lie.project(p_c, cam.fx, cam.fy, cam.cx, cam.cy)
    view = p_w - lie.inv_T(T_cw)[:3, 3]
    dist_w = torch.linalg.vector_norm(view, dim=-1) + 1e-9
    # frustum + scale band + viewing angle (IsInFrustum, reference:
    # src/orbframe.cpp:239-305)
    view_cos = torch.sum(view * m.pt_normal[slots], dim=-1) / dist_w
    in_frustum = (
        (z > 0.1)
        & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
        & (dist_w >= 0.8 * m.pt_min_dist[slots])
        & (dist_w <= 1.2 * m.pt_max_dist[slots])
        & (view_cos > 0.5)
    )
    visible = ok & in_frustum
    # predicted octave (PredictScale, reference: src/orbmappoint.cpp:445-476)
    ratio = torch.clamp(m.pt_max_dist[slots] / dist_w.clamp(min=1e-6), min=1.0)
    pred_oct = torch.ceil(torch.log(ratio) / torch.log(sf)).to(torch.int32)
    pred_oct = pred_oct.clamp(0, config.orb.n_levels - 1)
    radius = radius_scale * torch.where(view_cos > 0.998, 2.5, 4.0) * torch.pow(
        sf, pred_oct.to(torch.float32))

    feats = cur_frame.features
    d_uv = feats.xy[None, :, :] - uv[:, None, :]
    within = torch.maximum(torch.abs(d_uv[..., 0]), torch.abs(d_uv[..., 1])) <= radius[:, None]
    oct_ok = ((feats.octave[None, :] >= pred_oct[:, None] - 1)
              & (feats.octave[None, :] <= pred_oct[:, None] + 1))
    gate = within & oct_ok & visible[:, None] & feats.valid[None, :] & (bindings < 0)[None, :]
    big = MAX_DIST + 1
    d = torch.where(gate, hamming_matrix(m.pt_desc[slots], feats.desc), big)
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    d2 = d.scatter(1, best[:, None], big)
    second_idx = torch.argmin(d2, dim=1)
    second = torch.gather(d2, 1, second_idx[:, None])[:, 0]
    # ratio test only when best and second share a level (reference:
    # src/orbmatcher.cpp:105-123)
    same_level = feats.octave[best] == feats.octave[second_idx]
    ratio_ok = ~same_level | (best_d.to(torch.float32) <= 0.8 * second.to(torch.float32))
    pm = matching.resolve_duplicate_targets(
        matching.ProjectionMatches(dst_idx=best, dist=best_d,
                                   valid=(best_d <= TH_HIGH) & ratio_ok),
        feats.capacity)
    new_bindings = scatter_max(bindings, torch.where(pm.valid, pm.dst_idx, feats.capacity - 1),
                               torch.where(pm.valid, slots, -1))
    vis_delta = scatter_add(torch.zeros((P,), dtype=torch.int32, device=dev),
                            torch.where(visible, slots, P - 1), visible.to(torch.int32))
    vis_delta[P - 1] = 0
    return new_bindings, vis_delta


def track_frame_with_map(m: MapState, last_frame: FrameState, last_bindings, T_cw,
                         velocity, cur_frame: FrameState, config: SystemConfig,
                         generator=None) -> TrackOutputs:
    """The per-frame device program: motion-model matching and the
    RANSAC-rescued pose solve, then the local-map search and the second
    pose solve.  ``generator`` draws the EPnP-RANSAC sets."""
    cam = config.camera
    P = m.pt_capacity
    F = cur_frame.features.capacity
    dev = T_cw.device
    T_pred = velocity @ T_cw

    # --- stage 1: motion-model matching + first pose optimization --------
    mm, p_w_src, n_mm = _motion_model_match(m, last_frame, last_bindings, T_pred,
                                            velocity, cur_frame, config)
    feats = cur_frame.features
    sigma2 = features_scale_sigma2(feats, config.orb.scale_factor)
    dst = mm.dst_idx
    obs1 = PoseObs(p_w=p_w_src, uv=feats.xy[dst], u_right=feats.u_right[dst],
                   sigma2=sigma2[dst], valid=mm.valid)
    T1, _, _ = robust_pose_estimate(T_pred, obs1, generator,
                                    fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf)

    # inherit map bindings through the match (cur feature <- last feature)
    inherited = scatter_max(torch.full((F,), -1, dtype=torch.int32, device=dev),
                            torch.where(mm.valid, mm.dst_idx, F - 1),
                            torch.where(mm.valid, last_bindings, -1))

    # --- stage 2: local-map search + second pose optimization ------------
    local_pts = _local_point_window(m, inherited)
    bindings, vis_delta = _search_local_points(m, local_pts, inherited, T1, cur_frame, config)
    safe_b = bindings.clamp(0, P - 1).long()
    obs2 = PoseObs(p_w=m.pt_pos[safe_b], uv=feats.xy, u_right=feats.u_right, sigma2=sigma2,
                   valid=(bindings >= 0) & m.pt_valid[safe_b] & feats.valid)
    T2, inliers, n_inl = pose_optimize(T1, obs2, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                                       cy=cam.cy, bf=cam.bf)
    # drop outlier bindings (reference: src/tracking.cpp:783-798)
    bindings = torch.where(obs2.valid & inliers, bindings, -1)
    found_delta = scatter_add(torch.zeros((P,), dtype=torch.int32, device=dev),
                              torch.where(bindings >= 0, bindings, P - 1),
                              (bindings >= 0).to(torch.int32))
    found_delta[P - 1] = 0

    # keyframe-decision stats (NeedNewKeyFrame, reference:
    # src/tracking.cpp:832-866)
    th_far = config.tracking.th_depth * cam.baseline_m
    close = (feats.depth > 0) & (feats.depth < th_far) & feats.valid
    return TrackOutputs(
        T_cw=T2, bindings=bindings, n_inliers=n_inl, n_matches_mm=n_mm,
        n_tracked_close=torch.sum(close & (bindings >= 0)),
        n_untracked_close=torch.sum(close & (bindings < 0)),
        pt_visible_delta=vis_delta, pt_found_delta=found_delta,
    )


def apply_point_counters(m: MapState, vis_delta, found_delta) -> MapState:
    return m._replace(pt_visible=m.pt_visible + vis_delta, pt_found=m.pt_found + found_delta)


def adoption_fixup(m: MapState, pt_id_pre, vis_delta, found_delta, bindings):
    """Reconcile the tracker with an async mapping stage's output: deltas
    and bindings formed against the interim map are dropped on slots whose
    point identity (``pt_first_kf_id``) changed across the stage (a cull and
    reallocation within one stage always changes it)."""
    same = pt_id_pre == m.pt_first_kf_id
    m = apply_point_counters(m, torch.where(same, vis_delta, 0),
                             torch.where(same, found_delta, 0))
    keep = (bindings >= 0) & (same & m.pt_valid)[bindings.clamp(0, m.pt_capacity - 1).long()]
    return m, torch.where(keep, bindings, -1)


def insert_stage(m: MapState, frame, bindings, config: SystemConfig):
    """The tracking-thread half of keyframe creation: insert the keyframe,
    spawn close stereo points and refresh its covisibility row
    (reference: src/tracking.cpp:898-976).  Returns ``(m, slot,
    new_bindings, occ)`` with ``occ = [n_kf_valid, n_pt_valid]``."""
    th_far = (-1.0 if config.camera_type == "mono"
              else config.tracking.th_depth * config.camera.baseline_m)
    m, slot = insert_keyframe(m, frame, bindings, th_far, covis_mode="row")
    occ = torch.stack([m.kf_valid.sum(), m.pt_valid.sum()]).to(torch.int32)
    return m, slot, row(m.kf_obs_point, slot), occ


def mapping_stage(m: MapState, slot, config: SystemConfig, do_triangulate: bool,
                  do_fuse: bool, do_lba: bool, do_cull: bool):
    """The mapping-thread work for one keyframe (Mapping::Run's loop body,
    reference: src/mapping.cpp:48-116): point cull -> triangulate -> fuse
    -> local BA -> keyframe cull -> covisibility rebuild, one observation
    count threaded through every pass.  Returns ``(m, aux)`` with
    ``aux = [n_ref_matches, n_kf_valid, n_pt_valid]``."""
    mono = config.camera_type == "mono"
    counts = point_observation_counts(m)
    m, counts = cull_points(m, m.next_kf_id - 1, th_obs=2 if mono else 3, counts=counts)
    if do_triangulate:
        m, counts = create_new_map_points(m, slot, config, n_neighbors=20 if mono else 10,
                                          update_covis=False, counts=counts)
    if do_fuse:
        m, counts = run_fusion(m, slot, config, update_covis=False, counts=counts)
    if do_lba:
        # divergence guard: revert the whole local BA when the center
        # keyframe moved implausibly far (a legitimate correction is cm)
        T_pre = row(m.kf_T_cw, slot)
        m2, counts2 = local_mapping_step(m, slot, config, update_covis=False, counts=counts)
        moved = torch.linalg.vector_norm((lie.inv_T(T_pre) @ row(m2.kf_T_cw, slot))[:3, 3])
        ok = moved < 1.0
        m = MapState(*(torch.where(ok, a, b) for a, b in zip(m2, m)))
        counts = torch.where(ok, counts2, counts)
    if do_cull:
        m = cull_keyframes(m, slot, update_covis=False, counts=counts)
    m = m._replace(covis=recompute_covisibility(m))

    # nRefMatches for the keyframe decision (TrackedMapPoints(minObs),
    # reference: src/tracking.cpp:825-829, src/orbkeyframe.cpp:281-305)
    counts_now = point_observation_counts(m)
    binds = row(m.kf_obs_point, slot)
    safe = binds.clamp(0, m.pt_capacity - 1).long()
    bound = row(m.kf_feat_valid, slot) & (binds >= 0)
    min_obs = torch.where(m.next_kf_id > 2, 3, 2)
    n_ref = torch.sum(bound & m.pt_valid[safe] & (counts_now[safe] >= min_obs))
    aux = torch.stack([n_ref, m.kf_valid.sum(), m.pt_valid.sum()]).to(torch.int32)
    return m, aux


def _wide_recovery_program(m: MapState, cur: FrameState, T_guess, generator,
                           config: SystemConfig):
    """Projection recovery rung: the recency-ranked local window matched
    from the last good pose at 8x radius, then the RANSAC-rescued pose
    solve.  Returns ``(T, bindings, n_inliers)``."""
    cam = config.camera
    P = m.pt_capacity
    F = cur.features.capacity
    none = torch.full((F,), -1, dtype=torch.int32, device=T_guess.device)
    local_pts = _local_point_window(m, none)
    bindings, _ = _search_local_points(m, local_pts, none, T_guess, cur, config,
                                       radius_scale=8.0)
    safe_b = bindings.clamp(0, P - 1).long()
    feats = cur.features
    obs = PoseObs(p_w=m.pt_pos[safe_b], uv=feats.xy, u_right=feats.u_right,
                  sigma2=features_scale_sigma2(feats, config.orb.scale_factor),
                  valid=(bindings >= 0) & m.pt_valid[safe_b] & feats.valid)
    T, inliers, n_inl = robust_pose_estimate(T_guess, obs, generator, fx=cam.fx, fy=cam.fy,
                                             cx=cam.cx, cy=cam.cy, bf=cam.bf)
    return T, torch.where(obs.valid & inliers, bindings, -1), n_inl


def rebase_pose(T_cur, T_kf_pre, T_kf_post):
    """Keep the tracked relative pose cur<-KF across a keyframe the mapping
    stage moved (reference: src/tracking.cpp:546-585); degenerate results
    leave the pose untouched."""
    T = (T_cur @ lie.inv_T(T_kf_pre)) @ T_kf_post
    ok = torch.all(torch.isfinite(T)) & (torch.abs(lie.det3(T[:3, :3]) - 1.0) < 0.1)
    return torch.where(ok, T, T_cur)


class _HostFetch:
    """A device->host copy of a few small tensors that completes in stream
    order: pinned buffers filled ``non_blocking``, a CUDA event recorded
    behind them.  ``done()`` polls the event, ``result()`` waits on it (the
    counterpart of the reference's worker-thread ``bg_fetch``).  On the CPU
    the copy is immediate."""

    def __init__(self, *tensors):
        self._event = None
        if tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.detach().clone() for t in tensors]

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def result(self):
        if self._event is not None:
            self._event.synchronize()
        out = [h.numpy() for h in self._host]
        return out[0] if len(out) == 1 else out


class StereoSlam:
    """Host scheduler for stereo SLAM without loop closing or
    relocalization: the per-frame tracking program, the keyframe insert and
    the asynchronous mapping stage (reference: src/selflocalization.cpp:330-377
    wiring, here without the loop-closing thread).

    ``enable_loop_closing``, ``enable_relocalization``, ``vocab`` and
    ``tracking_only`` keep the reference's signature; the features they turn
    on raise ``NotImplementedError`` until their slice of the port lands
    (ROADMAP.md queue 1).  Per-frame RANSAC draws come from a generator
    re-seeded with the constant ``seed`` before each frame, as the reference
    draws with a fresh ``PRNGKey(0)``; the wide-recovery rung draws from a
    generator seeded once with 11 that advances, as the reference splits
    ``PRNGKey(11)``."""

    # max keyframes inserted-but-not-yet-mapped while a stage is in flight
    # (reference: insert while fewer than 3 wait, src/tracking.cpp:884-893)
    KF_QUEUE_CAP = 2

    def __init__(self, config: SystemConfig, vocab=None, enable_loop_closing: bool = True,
                 enable_relocalization: bool = True, tracking_only: bool = False,
                 device="cuda"):
        if enable_loop_closing:
            raise NotImplementedError(
                "loop closing is not ported yet (ROADMAP.md queue 1 item 6); "
                "pass enable_loop_closing=False")
        if enable_relocalization or vocab is not None:
            raise NotImplementedError(
                "relocalization and the vocabulary are not ported yet (ROADMAP.md "
                "queue 1 item 5); pass enable_relocalization=False and no vocab")
        if tracking_only:
            raise NotImplementedError(
                "tracking-only mode is not ported yet (ROADMAP.md queue 1 item 7)")
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StereoSlam(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        #: the constant the per-frame RANSAC generator is re-seeded with
        self.seed = 0
        self.generator = torch.Generator(device=self.device)
        self._reloc_gen = torch.Generator(device=self.device).manual_seed(11)
        #: True: every decision and mapping stage synchronous (tests)
        self.force_sync_decisions = False
        self.trajectory: list = []
        self.traj_ref: list = []
        self.frame_idx = 0
        self.last_kf_slot = -1
        self.last_stats = None
        self._pipeline_healthy = False
        self._lost_streak = 0
        self._motion_prior = None
        self.reset()

    # ---- state --------------------------------------------------------------

    def _eye(self):
        return torch.eye(4, dtype=torch.float32, device=self.device)

    def _no_bindings(self, n: int):
        return torch.full((n,), -1, dtype=torch.int32, device=self.device)

    def reset(self):
        """Full system reset (Tracking::Reset, reference:
        src/tracking.cpp:1340-1385): clear the map and the tracker; the
        trajectory log survives with its frames demoted to raw poses."""
        cfg = self.config
        self.map = empty_map(min(cfg.initial_keyframes, cfg.max_keyframes),
                             min(cfg.initial_map_points, cfg.max_map_points),
                             cfg.orb.max_keypoints, device=self.device)
        self.T_cw = self._eye()
        self.velocity = self._eye()
        self.last_frame: FrameState | None = None
        self.last_bindings = None
        self.frames_since_kf = 0
        self.ref_kf_tracked = 0
        self.lost = False
        self.n_keyframes = 0
        self.last_kf_id = -1
        self.traj_ref = [(-1, -1, t[2]) for t in self.traj_ref]
        self.last_reloc_frame = -(10 ** 9)
        self._occ = (0, 0)
        self._inserts_since_occ = 0
        self._kf_pending = None
        self._kf_queue: list = []
        self._decision_pending = None
        self._pending_vis = self._pending_found = None

    @property
    def mapping_busy(self) -> bool:
        """True while an async mapping stage is in flight
        (Mapping::AcceptKeyFrames()==false)."""
        return self._kf_pending is not None

    # ---- trajectory -----------------------------------------------------------

    def _log_pose(self, T):
        """Log a pose and its transform relative to the reference keyframe
        (SaveTrajectoryKITTI re-chains through it, reference:
        src/tracking.cpp:1449-1536)."""
        self.trajectory.append(T)
        slot, kf_id = self.last_kf_slot, self.last_kf_id
        T_rel = T @ lie.inv_T(self.map.kf_T_cw[slot]) if slot >= 0 else T
        self.traj_ref.append((slot, kf_id, T_rel))

    def _relog_pose(self, T):
        self.trajectory.pop()
        self.traj_ref.pop()
        self._log_pose(T)

    def corrected_trajectory(self):
        """Each frame pose re-expressed through its reference keyframe's
        current pose; frames whose keyframe was culled (slot recycled) keep
        the raw online pose."""
        raws = [T.cpu().numpy() for T in self.trajectory]
        if not self.traj_ref:
            return raws
        rels = torch.stack([t[2] for t in self.traj_ref]).cpu().numpy()
        kf_valid = self.map.kf_valid.cpu().numpy()
        kf_ids = self.map.kf_id.cpu().numpy()
        T_kf = self.map.kf_T_cw.cpu().numpy()
        out = []
        for i, (slot, kf_id, _) in enumerate(self.traj_ref):
            if slot >= 0 and kf_valid[slot] and kf_ids[slot] == kf_id:
                out.append(rels[i] @ T_kf[slot])
            else:
                out.append(raws[i])
        return out

    # ---- features of later slices: the reference's early returns ----------

    def _register_keyframe(self, slot: int, kf_id: int):
        """BoW row + loop detection: returns at once without a vocabulary."""
        return

    def _try_harvest_loop(self, force: bool = False):
        """The staged loop-closing pipeline: returns at once without a loop
        closer."""
        return

    def _service_gba(self):
        """One incremental global-BA chunk: returns at once with none in
        flight."""
        return

    def _track_reference_keyframe(self, cur: FrameState):
        """BoW tracking rung: needs the vocabulary, so it declines."""
        return False

    def _try_relocalize(self, cur: FrameState):
        return False

    def _try_global_reloc(self, cur: FrameState):
        return False

    def _try_wide_recovery(self, cur: FrameState):
        """Wide projection recovery from the last good pose; accepts at the
        TrackLocalMap threshold."""
        T, bindings, n_inl = _wide_recovery_program(self.map, cur, self.T_cw,
                                                     self._reloc_gen, self.config)
        if int(n_inl) < MIN_INLIERS_MAP:
            return False
        self.T_cw = T
        self.last_bindings = bindings
        self.lost = False
        return True

    # ---- keyframes and the mapping stage -------------------------------------

    def _insert_only(self, frame: FrameState, bindings):
        """Insert the keyframe + its close points (no host read).  Returns
        ``(slot, kf_id, post-insert bindings)``."""
        self.map, slot, new_bindings, _ = insert_stage(self.map, frame, bindings, self.config)
        kf_id = self.n_keyframes
        self.n_keyframes += 1
        self.frames_since_kf = 0
        self._inserts_since_occ += 1
        return slot, kf_id, new_bindings

    def _dispatch_mapping(self, slot, kf_id, do_lba: bool = True):
        """Launch the mapping stage without waiting for it; ``do_lba=False``
        skips local BA while keyframes queue (InterruptBA, reference:
        src/mapping.cpp:118-123)."""
        m_new, aux = mapping_stage(
            self.map, slot, self.config, do_triangulate=kf_id >= 1, do_fuse=kf_id >= 1,
            do_lba=kf_id >= 2 and do_lba, do_cull=kf_id >= 4)
        self._kf_pending = {
            "map": m_new, "slot": slot, "kf_id": kf_id,
            "T_kf_pre": row(self.map.kf_T_cw, slot),
            # interim point identities for adoption_fixup
            "pt_id_pre": self.map.pt_first_kf_id,
            "fetch": _HostFetch(aux, slot.reshape(())),
        }
        P = self.map.pt_capacity
        self._pending_vis = torch.zeros((P,), dtype=torch.int32, device=self.device)
        self._pending_found = torch.zeros((P,), dtype=torch.int32, device=self.device)

    def _dispatch_keyframe(self, frame: FrameState, bindings):
        """Insert a keyframe and run its mapping stage now if the pipeline is
        idle, else queue its source data for replay at adoption."""
        slot, kf_id, new_bindings = self._insert_only(frame, bindings)
        if self._kf_pending is None:
            self._dispatch_mapping(slot, kf_id)
            if not self._pipeline_healthy:
                # marginal tracking: settle the map now
                self._try_adopt_mapping(force=True)
                return self.map.kf_obs_point[self.last_kf_slot]
        else:
            self._kf_queue.append({"frame": frame, "bindings": bindings, "kf_id": kf_id})
        return new_bindings

    def _try_adopt_mapping(self, force: bool = False):
        """Adopt the mapping stage's output once its event completed
        (``force`` waits)."""
        if self._kf_pending is None:
            return
        pend = self._kf_pending
        if not force and not pend["fetch"].done():
            return
        self._kf_pending = None
        m = pend["map"]
        bindings = (self.last_bindings if self.last_bindings is not None
                    else self._no_bindings(m.feat_capacity))
        m, bindings = adoption_fixup(m, pend["pt_id_pre"], self._pending_vis,
                                     self._pending_found, bindings)
        if self.last_bindings is not None:
            self.last_bindings = bindings
        self._pending_vis = self._pending_found = None
        self.T_cw = rebase_pose(self.T_cw, pend["T_kf_pre"], row(m.kf_T_cw, pend["slot"]))
        if self.last_frame is not None:
            self.last_frame = self.last_frame._replace(T_cw=self.T_cw)
        self.map = m
        stats, slot_np = pend["fetch"].result()
        self.ref_kf_tracked = max(int(stats[0]), 1)
        self._occ = (int(stats[1]), int(stats[2]))
        self._inserts_since_occ = len(self._kf_queue)
        self.last_kf_slot = int(slot_np)
        self.last_kf_id = pend["kf_id"]
        self._maybe_resize(extra_kf=len(self._kf_queue))
        self._register_keyframe(self.last_kf_slot, pend["kf_id"])
        # replay queued keyframes onto the settled map, then start the next
        # stage; local BA only when the backlog is clear
        if self._kf_queue:
            for q in self._kf_queue:
                if q.get("slot") is None:
                    self.map, q["slot"], _, _ = insert_stage(self.map, q["frame"],
                                                             q["bindings"], self.config)
            first = self._kf_queue.pop(0)
            self._dispatch_mapping(first["slot"], first["kf_id"], do_lba=not self._kf_queue)
            if force:
                self._try_adopt_mapping(force=True)

    def _maybe_resize(self, extra_kf: int = 0):
        """Capacity-bucket growth (x4 up to the configured maximum) or, at the
        top bucket, eviction headroom, from the occupancy snapshot."""
        cfg = self.config
        n_kf, n_pt = self._occ
        n_kf += extra_kf
        K, P = self.map.kf_capacity, self.map.pt_capacity
        grow_k = K if n_kf < K - 4 else min(K * 4, cfg.max_keyframes)
        grow_p = (P if n_pt < P - 2 * cfg.orb.max_keypoints
                  else min(P * 4, cfg.max_map_points))
        if (grow_k, grow_p) != (K, P):
            self.map = grow_map(self.map, grow_k, grow_p)
        elif n_kf >= K - 5 and K >= cfg.max_keyframes:
            for _ in range(3):
                self.map = evict_oldest_if_full(self.map, min_free=5)

    def _insert_keyframe(self, frame: FrameState, bindings):
        """Synchronous insert + mapping (the bootstrap path)."""
        self._dispatch_keyframe(frame, bindings)
        self._try_adopt_mapping(force=True)
        return self.map.kf_obs_point[self.last_kf_slot]

    def finish(self):
        """Settle in-flight work: the deferred decision and the pending
        mapping stage.  Call before reading the final map."""
        if self._decision_pending is not None:
            fetch, T_before, binds, frame = self._decision_pending
            self._decision_pending = None
            self._handle_decision(fetch.result(), T_before, binds, frame)
        self._try_adopt_mapping(force=True)

    # ---- per frame ------------------------------------------------------------

    def _to_device(self, img):
        if isinstance(img, np.ndarray):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(device=self.device, dtype=torch.float32)

    def process(self, img_left, img_right, timestamp: float = 0.0):
        """Track one stereo pair (numpy or tensor ``[H, W]``); returns the
        world->camera pose, or None while stereo initialization waits."""
        cur = process_stereo(self._to_device(img_left), self._to_device(img_right),
                             self.config, timestamp)
        return self._step(cur)

    def process_rgbd(self, img, depth_map, timestamp: float = 0.0):
        raise NotImplementedError(
            "RGB-D input is not ported yet (ROADMAP.md queue 1 item 7)")

    def _need_new_keyframe(self, tracked, n_tracked_close, n_untracked_close) -> bool:
        """NeedNewKeyFrame (reference: src/tracking.cpp:812-896), with the
        queue discipline of the staged pipeline and a capacity guard."""
        cfg = self.config
        if self.lost:
            return False
        if (self.frame_idx < self.last_reloc_frame + cfg.tracking.max_frames
                and self.n_keyframes > cfg.tracking.max_frames):
            return False
        busy = self.mapping_busy
        n_ref = max(self.ref_kf_tracked, 1)
        if cfg.camera_type == "mono":
            th_ref_ratio = 0.9
        else:
            th_ref_ratio = 0.75 if self.n_keyframes > 2 else 0.4
        need_close = (n_tracked_close < 100) and (n_untracked_close > 70)
        c1a = self.frames_since_kf >= cfg.tracking.max_frames
        c1b = self.frames_since_kf >= cfg.tracking.min_frames and not busy
        c1c = need_close or tracked < 0.25 * n_ref
        c2 = (tracked < th_ref_ratio * n_ref or need_close) and tracked > 15
        can_insert = (not busy) or (cfg.camera_type != "mono"
                                    and len(self._kf_queue) < self.KF_QUEUE_CAP)
        est_kf = self._occ[0] + self._inserts_since_occ
        can_insert = can_insert and est_kf < self.map.kf_capacity - 1
        return (c1a or c1b or c1c) and c2 and can_insert

    def _step(self, cur: FrameState):
        cfg = self.config
        self.frame_idx += 1
        self._try_adopt_mapping()
        self._try_harvest_loop()
        # auto-reset if lost right after bootstrap (reference:
        # src/tracking.cpp:305-313)
        if self.lost and self.last_frame is not None and self.n_keyframes <= 5:
            self._try_adopt_mapping(force=True)
            self.reset()

        if self.last_frame is None:
            # stereo initialization (reference: src/tracking.cpp:342-395)
            if int(torch.sum(cur.features.depth > 0)) < 100:
                return None
            bindings = self._insert_keyframe(cur, self._no_bindings(cur.features.capacity))
            self.last_frame = cur
            self.last_bindings = bindings
            self._log_pose(self._eye())
            return self.T_cw

        self.generator.manual_seed(self.seed)
        out = track_frame_with_map(self.map, self.last_frame, self.last_bindings, self.T_cw,
                                   self.velocity, cur, cfg, self.generator)
        if self.mapping_busy:
            # the in-flight stage's output would overwrite these counters
            self._pending_vis = self._pending_vis + out.pt_visible_delta
            self._pending_found = self._pending_found + out.pt_found_delta
        self.map = apply_point_counters(self.map, out.pt_visible_delta, out.pt_found_delta)
        # optimistic pose integration, with pose hygiene on the device: a
        # non-finite or collapsed rotation is never integrated, valid poses
        # are re-projected onto SE(3)
        T_new = out.T_cw
        pose_ok = torch.all(torch.isfinite(T_new)) & (
            torch.abs(lie.det3(T_new[:3, :3]) - 1.0) < 0.1)
        T_new = torch.where(pose_ok, lie.orthonormalize_T(T_new), self.T_cw)
        stats_dev = torch.stack([
            out.n_inliers.to(torch.int32) * pose_ok.to(torch.int32),
            torch.sum(out.bindings >= 0).to(torch.int32),
            out.n_tracked_close.to(torch.int32),
            out.n_untracked_close.to(torch.int32),
        ])
        T_before, bindings_before, frame_before = self.T_cw, self.last_bindings, self.last_frame
        self.velocity = T_new @ lie.inv_T(self.T_cw)
        self.T_cw = T_new
        self.last_frame = cur._replace(T_cw=T_new)
        self.last_bindings = out.bindings
        self.frames_since_kf += 1
        self._log_pose(T_new)

        # ---- decision handling: one frame late when healthy, else now -----
        pend = self._decision_pending
        healthy = (
            not self.force_sync_decisions
            and self.n_keyframes > 5
            and self.last_stats is not None
            and int(self.last_stats[0]) >= 5 * MIN_INLIERS_MAP
            and not self.lost
        )
        self._pipeline_healthy = healthy
        if healthy:
            self._decision_pending = (_HostFetch(stats_dev), T_before, bindings_before,
                                      frame_before)
            if pend is not None:
                self._handle_decision(pend[0].result(), pend[1], pend[2], pend[3])
        else:
            self._decision_pending = None
            self._handle_decision(_HostFetch(stats_dev).result(), T_before, bindings_before,
                                  None)
        self._service_gba()
        return self.T_cw

    def _handle_decision(self, stats, T_last_good=None, bindings_good=None, frame_good=None):
        """Lost check + keyframe decision from fetched stats
        ``[n_inliers, tracked, close tracked, close untracked]``.  In deferred
        mode the stats and ``frame_good`` are the previous frame's, and that
        frame is the one inserted."""
        cfg = self.config
        n_inl, tracked = int(stats[0]), int(stats[1])
        n_tracked_close, n_untracked_close = int(stats[2]), int(stats[3])
        self.last_stats = stats
        # strict acceptance within the post-reloc window (reference:
        # src/tracking.cpp:800-806)
        min_inliers = (50 if self.frame_idx < self.last_reloc_frame + cfg.tracking.max_frames
                       else MIN_INLIERS_MAP)
        self.lost = n_inl < min_inliers
        if not self.lost:
            self._motion_prior = lie.orthonormalize_T(self.velocity)
            if self._need_new_keyframe(tracked, n_tracked_close, n_untracked_close):
                if frame_good is not None:
                    self._dispatch_keyframe(frame_good, bindings_good)
                else:
                    self.last_bindings = self._dispatch_keyframe(self.last_frame,
                                                                 self.last_bindings)
                self.ref_kf_tracked = max(tracked, 1)
            return
        # lost: settle the map, roll the optimistic pose back and dead-reckon
        # one step on the last trustworthy motion
        self._try_adopt_mapping(force=True)
        prior = self._motion_prior if self._motion_prior is not None else self._eye()
        if T_last_good is not None:
            self.T_cw = lie.orthonormalize_T(prior @ T_last_good)
        self.velocity = prior
        cur = self.last_frame
        cur_bindings = self.last_bindings
        if bindings_good is not None:
            self.last_bindings = bindings_good
        # fallback ladder (reference: src/tracking.cpp:1538-1640)
        if self._track_reference_keyframe(cur):
            pass
        elif self._try_relocalize(cur):
            self.last_reloc_frame = self.frame_idx
        elif self._try_wide_recovery(cur):
            self.last_reloc_frame = self.frame_idx
        elif self._try_global_reloc(cur):
            self.last_reloc_frame = self.frame_idx
        else:
            self.last_bindings = cur_bindings
        self._lost_streak = self._lost_streak + 1 if self.lost else 0
        # map continuation after a sustained outage: re-bootstrap a new map
        # region from stereo depth at the dead-reckoned pose
        if (self._lost_streak >= 8 and cfg.camera_type != "mono"
                and not self.mapping_busy):
            n_depth = int(torch.sum((cur.features.depth > 0) & cur.features.valid))
            est_kf = self._occ[0] + self._inserts_since_occ
            if n_depth >= 100 and est_kf >= self.map.kf_capacity - 1:
                for _ in range(3):
                    self.map = evict_oldest_if_full(self.map, min_free=3)
                est_kf = int(self.map.kf_valid.sum())
                self._occ = (est_kf, self._occ[1])
                self._inserts_since_occ = 0
            if n_depth >= 100 and est_kf < self.map.kf_capacity - 1:
                self.last_frame = cur._replace(T_cw=self.T_cw)
                self.last_bindings = self._dispatch_keyframe(
                    self.last_frame, self._no_bindings(cur.features.capacity))
                self.lost = False
                self._lost_streak = 0
        if self.last_frame is not None:
            self.last_frame = self.last_frame._replace(T_cw=self.T_cw)
        self._relog_pose(self.T_cw)
