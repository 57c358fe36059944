"""Stereo and RGB-D SLAM: tracking against the map + the keyframe mapping stage.

Counterpart of the reference package's ``models/slam.py`` (Tracking::Track
-> TrackLocalMap -> NeedNewKeyFrame -> CreateNewKeyFrame, and the Mapping
thread's loop body, reference: src/tracking.cpp:262-339, 696-976,
src/mapping.cpp:48-116), with place recognition (the online vocabulary, the
keyframe database), the lost-frame recovery ladder, localization-only mode,
and loop closing with the incremental post-loop global BA (the LoopClosing
thread, src/loopclosing.cpp:49-83, 645-750).

Device programs are plain functions on tensors: ``track_frame_with_map``
per frame, ``insert_stage`` + ``mapping_stage`` per keyframe.  The host
driver ``StereoSlam`` keeps the reference's staged pipeline: the mapping
stage is dispatched without waiting for it, its small result vector is
copied into pinned host memory behind a CUDA event, and the stage is adopted
once the event has completed; the per-frame decision statistics come back
the same way, one frame late.  One CUDA stream orders everything, so the
tracker's next kernels run after the stage's on the device.  On rank 0 of a
process group of several ranks, the local-map pose solve and the post-loop
GBA run sharded over the group while the other ranks serve them
(``parallel/``).

Frame<->map binding: ``bindings [F] int32`` maps current-frame features to
map point slots (-1 = none), the analogue of ``OrbFrame::m_mapPoints``.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie, matching
from ..ops.hamming import MAX_DIST, TH_HIGH, hamming_matrix
from ..ops.indexing import (
    fill_at, row, scatter_add, scatter_max, scatter_set, set_row, topk_stable,
)
from ..optim.pose_opt import PoseObs, pose_optimize, robust_pose_estimate
from ..parallel.collectives import rank_and_size
from ..parallel.serve import EnginePoseSolver
from ..utils.config import SystemConfig
from ..utils.host import HostFetch
from .frame import FrameState, features_scale_sigma2
from .frontend import process_rgbd, process_stereo
from . import vocabulary as voc
from .fusion import run_fusion
from .global_ba import IncrementalGBA
from .kfdb import add_keyframe, empty_kfdb
from .local_mapping import local_mapping_step
from .loop_closing import LoopCloser, verify_and_apply
from .map_state import (
    MapState, cull_keyframes, cull_points, empty_map, evict_oldest_if_full, grow_map,
    insert_keyframe, pad_rows, point_observation_counts, recompute_covisibility,
)
from .relocalization import relocalize, relocalize_brute
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
    return fill_at(out, P - 1, False)


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
    fill_at(vis_delta, P - 1, 0)
    return new_bindings, vis_delta


def track_frame_with_map(m: MapState, last_frame: FrameState, last_bindings, T_cw,
                         velocity, cur_frame: FrameState, config: SystemConfig,
                         generator=None, pose_solver=None) -> TrackOutputs:
    """The per-frame device program: motion-model matching and the
    RANSAC-rescued pose solve, then the local-map search and the second
    pose solve.  ``generator`` draws the EPnP-RANSAC sets.  ``pose_solver``
    (``fn(T, obs) -> (T, inliers, n_inliers)``) takes the second solve, as
    the observation-sharded solver of ``parallel/serve.py`` does on a
    process group of several ranks; None: ``pose_optimize``."""
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
    if pose_solver is None:
        T2, inliers, n_inl = pose_optimize(T1, obs2, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                                           cy=cam.cy, bf=cam.bf)
    else:
        T2, inliers, n_inl = pose_solver(T1, obs2)
    # drop outlier bindings (reference: src/tracking.cpp:783-798)
    bindings = torch.where(obs2.valid & inliers, bindings, -1)
    found_delta = scatter_add(torch.zeros((P,), dtype=torch.int32, device=dev),
                              torch.where(bindings >= 0, bindings, P - 1),
                              (bindings >= 0).to(torch.int32))
    fill_at(found_delta, P - 1, 0)

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


def _track_ref_kf_program(m: MapState, kf_nodes, last_bindings, cur: FrameState, cur_nodes,
                          T_cw, config: SystemConfig):
    """TrackReferenceKeyFrame as one program (reference:
    src/tracking.cpp:587-629): pick the keyframe sharing most points with
    the last frame (the lowest slot among ties), BoW-match the current frame
    against it, pose-optimize from the last pose.  Returns ``(T_est,
    bindings, n_pair, n_inl)``."""
    cam = config.camera
    P = m.pt_capacity
    cur_bound = _mark(P, last_bindings.long(), last_bindings >= 0)
    sees = (m.kf_feat_valid & (m.kf_obs_point >= 0)
            & cur_bound[m.kf_obs_point.clamp(0, P - 1).long()] & m.kf_valid[:, None])
    ref_slot = topk_stable(sees.sum(dim=1), 1)[1][0]

    feats = cur.features
    idx_kf, ok = matching.search_by_bow(
        feats.desc, cur_nodes, feats.valid, feats.angle,
        row(m.kf_desc, ref_slot), row(kf_nodes, ref_slot),
        row(m.kf_feat_valid, ref_slot), row(m.kf_angle, ref_slot),
        max_dist=50, nn_ratio=0.7)
    bind = row(m.kf_obs_point, ref_slot)[idx_kf]
    safe = bind.clamp(0, P - 1).long()
    pair_ok = ok & (bind >= 0) & m.pt_valid[safe]
    obs = PoseObs(p_w=m.pt_pos[safe], uv=feats.xy, u_right=feats.u_right,
                  sigma2=features_scale_sigma2(feats, config.orb.scale_factor), valid=pair_ok)
    T_est, inliers, n_inl = pose_optimize(T_cw, obs, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                                          cy=cam.cy, bf=cam.bf)
    return T_est, torch.where(pair_ok & inliers, bind, -1), pair_ok.sum(), n_inl


def train_vocab_from_pool(descs: np.ndarray, feat_ok: np.ndarray, rng, seed: int):
    """The vocabulary retrain's host work, numpy in and out: the valid
    descriptors of the pooled keyframes (``descs [n, F, 8]``, ``feat_ok [n,
    F]``), capped at 24,000 drawn by ``rng`` (past that extra samples barely
    move the centroids while the Hamming assignment is linear in the pool),
    through ``train_vocabulary_np``.  Returns its tuple of arrays, or None
    below 1,000 descriptors."""
    pool = descs[feat_ok]
    if len(pool) < 1000:
        return None
    if len(pool) > 24000:
        pool = pool[rng.choice(len(pool), 24000, replace=False)]
    return voc.train_vocabulary_np(pool, branching=10, levels=4, seed=seed)


def rebase_pose(T_cur, T_kf_pre, T_kf_post):
    """Keep the tracked relative pose cur<-KF across a keyframe the mapping
    stage moved (reference: src/tracking.cpp:546-585); degenerate results
    leave the pose untouched."""
    T = (T_cur @ lie.inv_T(T_kf_pre)) @ T_kf_post
    ok = torch.all(torch.isfinite(T)) & (torch.abs(lie.det3(T[:3, :3]) - 1.0) < 0.1)
    return torch.where(ok, T, T_cur)


class StereoSlam:
    """Host scheduler for stereo SLAM: the per-frame tracking program, the
    keyframe insert, the asynchronous mapping stage, place recognition, the
    lost-frame recovery ladder and loop closing (reference:
    src/selflocalization.cpp:330-377 wiring).

    With ``enable_relocalization`` every adopted keyframe gets a BoW row in
    the keyframe database and a node table; the vocabulary is ``vocab``, kept
    for the whole run as the reference keeps the ORBvoc it loads
    (src/selflocalization.cpp:335), or, without one, is trained from the
    first frame's descriptors and retrained as the map grows (the reference
    package retrains a given vocabulary away too, at 12 keyframes).  A lost
    frame climbs four rungs: reference-keyframe BoW tracking,
    BoW relocalization, wide projection recovery, vocabulary-free global
    relocalization.  ``tracking_only`` (a plain attribute, it may be switched
    on once a map is built) is localization-only mode, the reference's
    mbOnlyTracking (src/tracking.cpp:1538-1640): the map is frozen, no
    keyframes and no mapping stages, and with fewer than 10 map inliers the
    motion-model estimate carries the pose (``_vo_mode``) while
    relocalization is tried every frame; a success snaps back onto the map.

    With ``enable_loop_closing`` every registered keyframe dispatches loop
    detection; a nominated candidate is verified and its correction adopted
    without waiting for the verdict (``verify_and_apply``), and a verified
    closure schedules the incremental global BA, one LM iteration a frame.
    No GBA steps or merges while a verification is in flight: a valid
    verdict replaces an older GBA with one from the corrected map, a
    declined one lets it resume (ORB-SLAM2 aborts GBA when a correction
    starts; the reference package lets an older GBA merge over it).  A
    finished GBA also waits for an in-flight mapping stage, whose adoption
    would overwrite the merge.

    Per-frame RANSAC draws come from a generator re-seeded with the constant
    ``seed`` before each frame, as the reference package draws with a fresh
    ``PRNGKey(0)``; the recovery rungs share a generator seeded once with 11
    that advances, as the reference package splits ``PRNGKey(11)``; the
    loop closer's Sim3 sets likewise from a generator seeded 7."""

    # max keyframes inserted-but-not-yet-mapped while a stage is in flight
    # (reference: insert while fewer than 3 wait, src/tracking.cpp:884-893)
    KF_QUEUE_CAP = 2
    # Without a given vocabulary, the online one retrains as the map grows:
    # first at 8 keyframes (the bootstrap vocabulary from one frame barely
    # discriminates), then at every 4x keyframe count (32, 128, ...).  The
    # reference loads an offline ORBvoc (src/orbvocabulary.cpp:39-118); none
    # ships.
    VOCAB_REFRESH_AT = 8
    # keyframes sampled for the retrain pool (bounds the copy and the k-means)
    VOCAB_POOL_KFS = 32
    # keyframes between starting a retrain and swapping it in: the swap comes
    # at a fixed keyframe count, not whenever the thread happens to finish,
    # so the BoW rows do not depend on the host's load
    VOCAB_SWAP_DELAY = 4

    def __init__(self, config: SystemConfig, vocab=None, enable_loop_closing: bool = True,
                 enable_relocalization: bool = True, tracking_only: bool = False,
                 device="cuda"):
        self.tracking_only = tracking_only
        self._vo_mode = False
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StereoSlam(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        #: the constant the per-frame RANSAC generator is re-seeded with
        self.seed = 0
        self.generator = torch.Generator(device=self.device)
        self._reloc_gen = torch.Generator(device=self.device).manual_seed(11)
        self.enable_loop_closing = enable_loop_closing
        self.enable_relocalization = enable_relocalization
        # place recognition state; the vocabulary and its retrain schedule
        # survive a reset, the database and the node tables do not
        self.vocab = None if vocab is None else voc.vocabulary_to(vocab, self.device)
        #: True: the caller's vocabulary, never retrained or replaced
        self.vocab_given = vocab is not None
        self._next_vocab_refresh = self.VOCAB_REFRESH_AT
        self._vocab_swap_at = 0
        self._vocab_thread = None
        self._vocab_result = None
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
        self.loops_closed = 0
        self._staging: dict = {}    # eye -> pinned image buffers in use (``_to_device``)
        self._pose_solver = self._sharded_pose_solver()
        self.reset()

    def _sharded_pose_solver(self):
        """On rank 0 of a default process group of D > 1 ranks, the local-map
        pose solve sharded over the group when ``max_keypoints`` splits into
        D blocks (the reference package's rule for its device mesh), else
        None; the post-loop GBA shards by itself (``IncrementalGBA``)."""
        rank, world = rank_and_size()
        if world < 2:
            return None
        if rank != 0:
            raise RuntimeError(f"rank {rank} of a group of {world}: the engine runs on rank 0; "
                               "the other ranks call parallel.serve.serve")
        n = self.config.orb.max_keypoints
        if n % world:
            print(f"StereoSlam: max_keypoints {n} does not split over {world} ranks; the "
                  "local-map pose solve runs on rank 0 alone")
            return None
        cam = self.config.camera
        return EnginePoseSolver(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf)

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
        self.db = None
        self.kf_nodes = None
        self._kf_valid_host = None
        self.loop_closer = None
        self.pending_gba = None        # in-flight incremental post-loop GBA
        self._loop_pending: list = []  # FIFO of in-flight loop-detection fetches
        self._verify_pending = None    # in-flight Sim3 verification verdict
        self._verify_todo = None       # accepted candidate awaiting dispatch

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

    # ---- the vocabulary and the keyframe database ---------------------------

    def _ensure_vocab(self, frame: FrameState):
        """Without a given vocabulary, train one from the first frame's
        descriptors (at least 64)."""
        if self.vocab is not None or not (self.enable_loop_closing
                                          or self.enable_relocalization):
            return
        feats = frame.features
        descs = feats.desc.cpu().numpy()[feats.valid.cpu().numpy()]
        if len(descs) < 64:
            return
        self.vocab = voc.train_vocabulary(descs, branching=10, levels=4, seed=0,
                                          device=self.device)

    def _maybe_refresh_vocab(self):
        """Periodic vocabulary retrain, off the tracking path.

        At the trigger this thread draws the keyframe pool, enqueues its
        gather and the copy into pinned host memory, and starts a worker
        thread that waits for that copy and runs the numpy k-means
        (``train_vocab_from_pool``): the worker launches nothing and
        allocates nothing on the device.  The finished vocabulary is swapped
        in at exactly ``trigger + VOCAB_SWAP_DELAY`` keyframes, joining the
        thread if it still runs: determinism is worth a rare bounded wait.
        A given vocabulary is never retrained."""
        if self.db is None or self.vocab_given:
            return
        if self._vocab_thread is not None:
            if self.n_keyframes < self._vocab_swap_at:
                return
            self._vocab_thread.join()
            self._vocab_thread = None
            arrays, self._vocab_result = self._vocab_result, None
            if arrays is not None:
                self._adopt_vocab(voc.vocabulary_from_numpy(arrays, self.device))
            return
        due = self._next_vocab_refresh
        if self.n_keyframes < due:
            return
        self._next_vocab_refresh = max(due * 4, self.n_keyframes + 1)
        self._vocab_swap_at = self.n_keyframes + self.VOCAB_SWAP_DELAY
        # the live slots came with the adopted stage's fetch; only after an
        # eviction is the mask read from the device
        kf_valid = self._kf_valid_host
        if kf_valid is None:
            kf_valid = self.map.kf_valid.cpu().numpy()
        live = np.nonzero(kf_valid)[0]
        if live.size == 0:
            return
        rng = np.random.default_rng(due)
        sel = (live if live.size <= self.VOCAB_POOL_KFS
               else rng.choice(live, self.VOCAB_POOL_KFS, replace=False))
        sel = torch.from_numpy(np.sort(sel).astype(np.int64))
        if self.device.type == "cuda":
            sel = sel.pin_memory().to(self.device, non_blocking=True)
        fetch = HostFetch(self.map.kf_desc.index_select(0, sel),
                          self.map.kf_feat_valid.index_select(0, sel))

        def work():
            descs, feat_ok = fetch.result()     # host arrays, once the copy landed
            self._vocab_result = train_vocab_from_pool(descs, feat_ok, rng, int(due))

        self._vocab_result = None
        self._vocab_thread = threading.Thread(target=work, daemon=True)
        self._vocab_thread.start()

    def _adopt_vocab(self, vocab):
        """Swap in a freshly trained vocabulary: rebuild the database rows
        and node tables of every live keyframe in one batched descent."""
        m = self.map
        self.vocab = vocab
        words, nodes = voc.transform_all(vocab, m.kf_desc, m.kf_feat_valid)
        live = m.kf_valid
        self.db = empty_kfdb(m.kf_capacity, vocab.n_words, self.device)._replace(
            bow=torch.where(live[:, None], voc.bow_vectors(vocab, words), 0.0),
            has_row=live)
        self.kf_nodes = torch.where(live[:, None], nodes, -1)

    def _register_keyframe(self, slot: int, kf_id: int):
        """BoW row + node table + loop detection for a new keyframe, at
        adoption time, after the mapping stage landed: the reference's
        LoopClosing thread adds a keyframe to the database only after Mapping
        processed it (reference: src/mapping.cpp:90, src/loopclosing.cpp:216).
        Detection is dispatched without waiting; :meth:`_try_harvest_loop`
        consumes it once its fetch has landed."""
        if self.vocab is None:
            return
        if self.db is None:
            self.db = empty_kfdb(self.map.kf_capacity, self.vocab.n_words, self.device)
            self.kf_nodes = torch.full((self.map.kf_capacity, self.config.orb.max_keypoints),
                                       -1, dtype=torch.int32, device=self.device)
            self.loop_closer = LoopCloser(self.config, self.device)
            self.loop_closer.defer_gba = True
        self._maybe_refresh_vocab()
        words, nodes = voc.transform(self.vocab, self.map.kf_desc[slot],
                                     self.map.kf_feat_valid[slot])
        self.db = add_keyframe(self.db, slot, voc.bow_vector(self.vocab, words))
        self.kf_nodes = set_row(self.kf_nodes, slot, nodes)
        # drop rows of culled keyframes
        self.db = self.db._replace(has_row=self.db.has_row & self.map.kf_valid)
        if self.enable_loop_closing:
            pend = self.loop_closer.dispatch(self.map, self.db, self.kf_nodes, slot, kf_id)
            if pend is not None:
                self._loop_pending.append(pend)

    # ---- loop closing -----------------------------------------------------------

    def _try_harvest_loop(self, force: bool = False):
        """Drive the staged loop-closing pipeline without blocking (unless
        ``force``), the LoopClosing thread's three phases
        (src/loopclosing.cpp:49-83):

        1. consume a landed verification verdict: count the closure, reset
           detection and replace any older GBA with one from the corrected
           map (mbStopGBA, src/loopclosing.cpp:409-420);
        2. consume landed detection fetches (host consistency logic);
        3. dispatch a nominated candidate's verification when no mapping
           stage is in flight (its adoption would overwrite the correction)
           and no other verification is."""
        if self.loop_closer is None:
            return
        vp = self._verify_pending
        if vp is not None and (force or vp["fetch"].done()):
            self._verify_pending = None
            if bool(vp["fetch"].result()):
                self.loops_closed += 1
                lc = self.loop_closer
                lc.last_loop_kf_id = vp["kf_id"]
                lc.prev_groups, lc.prev_counts = [], []
                self._verify_todo = None
                # queued detections predate the correction, and the
                # 10-keyframe cooldown skips them anyway
                self._loop_pending.clear()
                self.pending_gba = IncrementalGBA(self.map, self.config)
        while self._loop_pending:
            pend = self._loop_pending[0]
            if not force and not pend["ready"]():
                break
            self._loop_pending.pop(0)
            det = self.loop_closer.harvest_detect(pend)
            if det is not None and det[1] - self.loop_closer.last_loop_kf_id >= 10:
                self._verify_todo = det        # the latest nomination wins
            if not force:
                break
        if (self._verify_todo is not None and self._kf_pending is None
                and self._verify_pending is None):
            det, self._verify_todo = self._verify_todo, None
            self._dispatch_verify(det)
            if force:
                self._try_harvest_loop(force=True)

    def _dispatch_verify(self, det):
        """Launch ``verify_and_apply`` for a nominated candidate and adopt its
        masked output at once: map, rebased pose and velocity are device
        values selected by the verdict, which is read later."""
        kf_slot, kf_id, cand_slot, cand_id = det
        lc = self.loop_closer
        m2, valid, T_pre, T_post = verify_and_apply(self.map, self.kf_nodes, kf_slot, cand_slot,
                                                    kf_id, cand_id, lc.generator, self.config,
                                                    lc.fix_scale)
        self.map = m2
        # ride the correction: keep the tracked cur<-KF relative pose
        T_reb = lie.orthonormalize_T(rebase_pose(self.T_cw, T_pre, T_post))
        self.T_cw = torch.where(valid, T_reb, self.T_cw)
        self.velocity = torch.where(valid, self._eye(), self.velocity)
        if self.last_frame is not None:
            self.last_frame = self.last_frame._replace(T_cw=self.T_cw)
        self._verify_pending = {"kf_id": kf_id, "fetch": HostFetch(valid)}

    def _service_gba(self):
        """One bounded GBA chunk per frame and the merge once it finishes
        (the between-frames slice of the reference's detached GBA thread).
        Paused while a verification is in flight; a finished solve waits for
        an in-flight mapping stage before it merges."""
        gba = self.pending_gba
        if gba is None or self._verify_pending is not None:
            return
        if gba.iters_left > 0:
            gba.step()
        if gba.iters_left <= 0 and self._kf_pending is None:
            self.map = gba.merge(self.map)
            self.pending_gba = None

    # ---- the recovery rungs ----------------------------------------------------

    def _track_reference_keyframe(self, cur: FrameState):
        """BoW-match the frame against its reference keyframe and
        pose-optimize from the last pose (TrackReferenceKeyFrame, reference:
        src/tracking.cpp:587-629), the rung between motion-model tracking and
        relocalization: one program, one fetch."""
        if self.vocab is None or self.kf_nodes is None:
            return False
        feats = cur.features
        _, nodes = voc.transform(self.vocab, feats.desc, feats.valid)
        T_est, bindings, n_pair, n_inl = _track_ref_kf_program(
            self.map, self.kf_nodes, self.last_bindings, cur, nodes, self.T_cw, self.config)
        n_pair, n_inl = torch.stack([n_pair, n_inl]).tolist()
        # reference gates: >= 15 BoW matches (:607), >= 10 map inliers (:625)
        if n_pair < 15 or n_inl < 10:
            return False
        self.T_cw = T_est
        self.last_bindings = bindings
        self.lost = False
        return True

    def _adopt_reloc(self, res) -> bool:
        if not res.success:
            return False
        self.T_cw = res.T_cw
        self.velocity = self._eye()
        self.last_bindings = res.bindings
        self.lost = False
        return True

    def _try_relocalize(self, cur: FrameState):
        if not self.enable_relocalization or self.db is None:
            return False
        return self._adopt_reloc(relocalize(self.map, self.db, self.kf_nodes, self.vocab, cur,
                                            self.config, self._reloc_gen))

    def _try_global_reloc(self, cur: FrameState):
        """Vocabulary-free exact-NN relocalization over the whole map, the
        rung for when the online-trained BoW is too weak to rank candidates."""
        if not self.enable_relocalization:
            return False
        return self._adopt_reloc(relocalize_brute(self.map, cur, self.config, self._reloc_gen))

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
            "fetch": HostFetch(aux, slot.reshape(()), m_new.kf_valid),
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
        stats, slot_np, self._kf_valid_host = pend["fetch"].result()
        self.ref_kf_tracked = max(int(stats[0]), 1)
        self._occ = (int(stats[1]), int(stats[2]))
        self._inserts_since_occ = len(self._kf_queue)
        self.last_kf_slot = int(slot_np)
        self.last_kf_id = pend["kf_id"]
        self._maybe_resize(extra_kf=len(self._kf_queue))
        self._register_keyframe(self.last_kf_slot, pend["kf_id"])
        self._kf_valid_host = None
        # the Sim3 verification's slot: the pipeline is idle here (stage
        # adopted, next not dispatched), the one idle point guaranteed at a
        # high keyframe cadence
        if (self._verify_todo is not None and self._verify_pending is None
                and self.loop_closer is not None):
            det, self._verify_todo = self._verify_todo, None
            self._dispatch_verify(det)
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
            if self.db is not None:
                self.db = self.db._replace(bow=pad_rows(self.db.bow, grow_k),
                                           has_row=pad_rows(self.db.has_row, grow_k))
                self.kf_nodes = pad_rows(self.kf_nodes, grow_k, -1)
            # an in-flight GBA snapshot has the old shapes: drop it (the
            # reference aborts GBA on map topology changes too)
            self.pending_gba = None
        elif n_kf >= K - 5 and K >= cfg.max_keyframes:
            for _ in range(3):
                self.map = evict_oldest_if_full(self.map, min_free=5)
            self._kf_valid_host = None      # the fetched mask predates the eviction

    def _insert_keyframe(self, frame: FrameState, bindings):
        """Synchronous insert + mapping (the bootstrap path)."""
        self._dispatch_keyframe(frame, bindings)
        self._try_adopt_mapping(force=True)
        return self.map.kf_obs_point[self.last_kf_slot]

    def finish(self):
        """Settle in-flight work: the deferred decision, the pending mapping
        stage, the loop pipeline and any incremental GBA (Shutdown joining
        the threads, reference: src/selflocalization.cpp:560-570).  Call
        before reading the final map."""
        if self._decision_pending is not None:
            fetch, T_before, binds, frame = self._decision_pending
            self._decision_pending = None
            self._handle_decision(fetch.result(), T_before, binds, frame)
        self._try_adopt_mapping(force=True)
        self._try_harvest_loop(force=True)
        while self.pending_gba is not None:
            self._service_gba()

    # ---- per frame ------------------------------------------------------------

    def _to_device(self, img, eye: int = 0):
        """An image as a float32 tensor on the device.  A numpy image bound
        for the card goes through a pinned staging buffer and an
        asynchronous copy (a copy from pageable memory waits for the
        stream); each eye has two buffers used in turn, and a buffer is
        refilled only once the event behind its last copy has completed."""
        if not isinstance(img, np.ndarray):
            return img.to(device=self.device, dtype=torch.float32)
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(img)).to(torch.float32)
        ring = self._staging.setdefault(eye, [])
        if len(ring) < 2 or ring[0][0].shape != img.shape:
            buf = torch.empty(img.shape, dtype=torch.float32, pin_memory=True)
        else:
            buf, done = ring.pop(0)
            done.synchronize()
        buf.numpy()[...] = img
        out = buf.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        ring.append((buf, done))
        del ring[:-2]
        return out

    def process(self, img_left, img_right, timestamp: float = 0.0):
        """Track one stereo pair (numpy or tensor ``[H, W]``); returns the
        world->camera pose, or None while stereo initialization waits."""
        cur = process_stereo(self._to_device(img_left, 0), self._to_device(img_right, 1),
                             self.config, timestamp)
        return self._step(cur)

    def process_rgbd(self, img, depth_map, timestamp: float = 0.0):
        """Track one grayscale image + registered depth map (numpy or tensor
        ``[H, W]``; GrabImageRGBD, reference: src/tracking.cpp:202-230).
        Past the front end an RGB-D frame carries the same ``u_right`` and
        depth as a stereo frame, so the rest is the stereo ``_step``."""
        cur = process_rgbd(self._to_device(img, 0), self._to_device(depth_map, 1),
                           self.config, timestamp)
        return self._step(cur)

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
            if self.tracking_only:
                # localization-only: no map bootstrap, relocalize against the
                # map that is there (the reference activates OnlyTracking on
                # an existing map)
                self.last_frame = cur
                self.last_bindings = self._no_bindings(cur.features.capacity)
                self._try_relocalize(cur)
                self._log_pose(self.T_cw)
                return self.T_cw
            # stereo initialization (reference: src/tracking.cpp:342-395)
            if int(torch.sum(cur.features.depth > 0)) < 100:
                return None
            self._ensure_vocab(cur)
            bindings = self._insert_keyframe(cur, self._no_bindings(cur.features.capacity))
            self.last_frame = cur
            self.last_bindings = bindings
            self._log_pose(self._eye())
            return self.T_cw

        self.generator.manual_seed(self.seed)
        out = track_frame_with_map(self.map, self.last_frame, self.last_bindings, self.T_cw,
                                   self.velocity, cur, cfg, self.generator, self._pose_solver)
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
            self._decision_pending = (HostFetch(stats_dev), T_before, bindings_before,
                                      frame_before)
            if pend is not None:
                self._handle_decision(pend[0].result(), pend[1], pend[2], pend[3])
        else:
            self._decision_pending = None
            self._handle_decision(HostFetch(stats_dev).result(), T_before, bindings_before,
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
        if self.tracking_only:
            # mbVO dual hypothesis (reference: src/tracking.cpp:1570-1640):
            # below 10 map inliers the motion-model estimate carries the pose
            # and relocalization runs every frame; a success snaps the
            # tracker back onto the frozen map
            self._vo_mode = n_inl < 10
            self.lost = False
            if self._vo_mode and self._try_relocalize(self.last_frame):
                self._vo_mode = False
                self.last_reloc_frame = self.frame_idx
                self._relog_pose(self.T_cw)
            return
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
