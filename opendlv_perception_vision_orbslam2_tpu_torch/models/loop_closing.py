"""Loop closing: detection, relative-pose solve, map correction.

Counterpart of the reference package's ``models/loop_closing.py`` (the
LoopClosing thread, reference: src/loopclosing.cpp):

- DetectLoop (:98-224): BoW candidates below the covisible min-score and the
  3-consecutive-detection consistency check, plus an exact-NN keyframe vote;
  the queries run on the device, their results come back through one
  ``HostFetch``, and the consistency groups stay on the host, keyed by
  keyframe id;
- ComputeSim3 (:226-398): 3D-3D pairs from one keyframe each, a
  hypothesis-batched Horn RANSAC, SearchBySim3-style match growth, a
  Gauss-Newton Sim3 refine and the loop-region projection gate;
- CorrectLoop (:400-585): the essential-graph pose-graph solve with the loop
  keyframe fixed, then point correction through each point's reference
  keyframe.

``verify_and_apply`` computes the correction unconditionally and selects it
with ``torch.where``: the caller never waits for the verdict.  Slots passed
to these functions are host integers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie
from ..ops.hamming import MAX_DIST, TH_HIGH, TH_LOW, hamming_matrix
from ..ops.horn import horn_align
from ..ops.indexing import row
from ..optim.pose_graph import PoseGraphProblem, forward_jacobian, optimize_pose_graph
from ..utils.config import SystemConfig
from ..utils.host import HostFetch
from .kfdb import KeyFrameDatabase, detect_candidates, query_scores
from .map_state import MapState, add_loop_edge, recompute_covisibility
from .relocalization import _brute_match_points

COVIS_CONSISTENCY_TH = 3    # reference: src/loopclosing.cpp:35
MIN_LOOP_INLIERS = 20       # reference: src/loopclosing.cpp:344
MIN_LOOP_TOTAL = 40         # region-projection gate (reference: :391-397)
ESSENTIAL_COVIS_MIN = 100   # strong-edge weight (reference: src/orboptimizer.cpp:962)
N_SIM3_HYPOTHESES = 128
GEO_VOTE_MIN = 40           # exact-NN votes to accept a geometric candidate
_I32_MAX = 2**31 - 1


def loop_min_score(m: MapState, db: KeyFrameDatabase, kf_slot: int):
    """Minimum BoW score of the keyframe against its covisible neighbours
    (reference: src/loopclosing.cpp:112-131)."""
    scores = query_scores(db, db.bow[kf_slot])
    neighbor = (m.covis[kf_slot] > 0) & m.kf_valid
    ms = torch.min(torch.where(neighbor, scores, float("inf")))
    return torch.where(torch.isfinite(ms), ms, 0.0)


def loop_candidates(m: MapState, db: KeyFrameDatabase, kf_slot: int, n_candidates: int = 8):
    """Database query excluding the keyframe and its covisible group."""
    exclude = ((m.covis[kf_slot] > 0)
               | (torch.arange(m.kf_capacity, device=m.covis.device) == kf_slot) | ~m.kf_valid)
    return detect_candidates(db, db.bow[kf_slot], exclude, loop_min_score(m, db, kf_slot),
                             m.covis, n_candidates)


class LoopMatch(NamedTuple):
    ok: torch.Tensor         # [] bool
    T_rel: torch.Tensor      # [4, 4]: corrected T_cur_cw = T_rel @ T_cand_cw
    s_rel: torch.Tensor      # [] scale of the relative Sim3 (1 for stereo)
    n_inliers: torch.Tensor  # [] GN-refined 3D-3D inliers
    n_total: torch.Tensor    # [] loop-region projection matches


def sample_sets(pair_ok, generator, n_hypotheses: int = N_SIM3_HYPOTHESES):
    """``[n_hypotheses, 3]`` pair indices drawn with replacement, biased to
    valid pairs (the reference package draws the same distribution with
    ``jax.random.categorical`` over ``log(pair_ok + 1e-9)``)."""
    weights = pair_ok.to(torch.float32) + 1e-9
    idx = torch.multinomial(weights, n_hypotheses * 3, replacement=True, generator=generator)
    return idx.reshape(n_hypotheses, 3)


def _project(x, cam):
    """Pixels of camera points with z clamped at 1e-3 (the Sim3 stages')."""
    z = torch.clamp(x[..., 2], min=1e-3)
    return torch.stack([cam.fx * x[..., 0] / z + cam.cx, cam.fy * x[..., 1] / z + cam.cy], -1)


def _reproj_err(x_cam, uv_ref, cam):
    d = _project(x_cam, cam) - uv_ref
    return d[..., 0] ** 2 + d[..., 1] ** 2


def _sim3_gn_refine(x_b, x_a, uv_a, uv_b, w, R0, t0, s0, cam, fix_scale: bool,
                    n_iters: int = 8):
    """Gauss-Newton refine of the relative Sim3 on weighted 3D-3D pairs by
    mutual reprojection residuals, the OptimizeSim3 role (reference:
    src/orboptimizer.cpp:1064-1261).  Parameters: (rho, phi, sigma)."""

    def params_to_sim3(dx):
        return lie.exp_so3(dx[..., 3:6]) @ R0, t0 + dx[..., :3], s0 * torch.exp(dx[..., 6])

    def residuals(dx):          # dx [..., 7] -> [..., 4N]
        R, t, s = params_to_sim3(dx)
        x_in_a = lie.sim3_apply(R, t, s, x_b)
        x_in_b = lie.sim3_apply(*lie.sim3_inverse(R, t, s), x_a)
        r = torch.cat([_project(x_in_a, cam) - uv_a, _project(x_in_b, cam) - uv_b], dim=-2)
        return r.reshape(r.shape[:-2] + (-1,))

    ww2 = torch.sqrt(torch.cat([w, w])).repeat_interleave(2)
    eye7 = torch.eye(7, dtype=x_a.dtype, device=x_a.device)
    sigma_col = eye7[6]
    dx = torch.zeros((7,), dtype=x_a.dtype, device=x_a.device)
    for _ in range(n_iters):
        r = residuals(dx) * ww2
        J = forward_jacobian(residuals, dx) * ww2[:, None]
        if fix_scale:
            J = J * (1.0 - sigma_col)           # remove sigma from the system
        H = J.T @ J + 1e-6 * eye7
        g = J.T @ r
        if fix_scale:
            H = H + torch.diag(sigma_col)
            g = g * (1.0 - sigma_col)
        d, info = torch.linalg.solve_ex(H, -g)
        dx = dx + torch.where(torch.isfinite(d).all() & (info == 0), d, 0.0)
    return params_to_sim3(dx)


def compute_loop_transform(m: MapState, kf_nodes, cur_slot: int, cand_slot: int, generator,
                           config: SystemConfig, fix_scale: bool = True) -> LoopMatch:
    """Relative Sim(3) between the current and the candidate keyframe, the
    stages of LoopClosing::ComputeSim3 (reference: src/loopclosing.cpp:
    226-398):

    1. exact-NN mutual-best Hamming pairs between the two keyframes' bound
       features (both 3D sides from one keyframe each, so the relative Sim3
       absorbs the drift between the regions), then Horn RANSAC over
       ``N_SIM3_HYPOTHESES`` 3-pair sets drawn from ``generator``
       (``sample_sets``) and a Horn re-fit on the best inlier set;
    2. SearchBySim3-style growth: each side's points projected into the
       other under the estimate, scale-gated mutual Hamming best
       (src/orbmatcher.cpp:1110-1336);
    3. Gauss-Newton Sim3 refine, >= 20 inliers;
    4. the loop-region gate: the candidate's and its covisible group's
       points projected through the corrected pose, >= 40 matches.

    ``kf_nodes`` is unused, as in the reference package."""
    cam = config.camera
    P, F, K = m.pt_capacity, m.feat_capacity, m.kf_capacity
    dev = m.kf_T_cw.device
    ar_f = torch.arange(F, device=dev)

    # --- stage 1: pairing and RANSAC ---------------------------------------
    bind_a = m.kf_obs_point[cur_slot]
    bind_b = m.kf_obs_point[cand_slot]
    safe_a = bind_a.clamp(0, P - 1).long()
    safe_b = bind_b.clamp(0, P - 1).long()
    has_a = m.kf_feat_valid[cur_slot] & (bind_a >= 0) & m.pt_valid[safe_a]
    has_b = m.kf_feat_valid[cand_slot] & (bind_b >= 0) & m.pt_valid[safe_b]
    d_ab = hamming_matrix(m.kf_desc[cur_slot], m.kf_desc[cand_slot])
    d_ab = torch.where(has_a[:, None] & has_b[None, :], d_ab, 999)
    fb = torch.argmin(d_ab, dim=1)
    bd = torch.gather(d_ab, 1, fb[:, None])[:, 0]
    back = torch.argmin(d_ab, dim=0)
    pair_ok = has_a & (bd <= TH_LOW) & (back[fb] == ar_f)
    T_cur, T_cand = m.kf_T_cw[cur_slot], m.kf_T_cw[cand_slot]
    x_a = lie.transform_points(T_cur, m.pt_pos[safe_a])
    x_b = lie.transform_points(T_cand, m.pt_pos[safe_b[fb]])
    uv_b = m.kf_xy[cand_slot][fb]
    uv_a = m.kf_xy[cur_slot]

    sets = sample_sets(pair_ok, generator).to(device=dev, dtype=torch.int64)
    sets_ok = torch.all(pair_ok[sets], dim=1)
    R_h, t_h, s_h = horn_align(x_b[sets], x_a[sets], fix_scale=fix_scale)
    x_b_in_a = s_h[:, None, None] * torch.einsum("bij,nj->bni", R_h, x_b) + t_h[:, None, :]
    x_a_in_b = torch.einsum("bji,bnj->bni", R_h, x_a[None] - t_h[:, None, :]) / s_h[:, None, None]
    err_a = _reproj_err(x_b_in_a, uv_a[None], cam)
    err_b = _reproj_err(x_a_in_b, uv_b[None], cam)
    inl = (err_a <= 9.21) & (err_b <= 9.21) & pair_ok[None, :] & sets_ok[:, None]
    best_inl = row(inl, torch.argmax(inl.sum(dim=1)))
    R1, t1, s1 = horn_align(x_b, x_a, best_inl.to(torch.float32), fix_scale=fix_scale)

    # --- stage 2: SearchBySim3 match growth --------------------------------
    x_b_all = lie.transform_points(T_cand, m.pt_pos[safe_b])
    xb_in_a = s1 * (x_b_all @ R1.T) + t1
    Ri1, ti1, si1 = lie.sim3_inverse(R1, t1, s1)
    xa_in_b = si1 * (x_a @ Ri1.T) + ti1
    uvb_in_a, zb_ok = _project(xb_in_a, cam), xb_in_a[:, 2] > 0.1
    uva_in_b, za_ok = _project(xa_in_b, cam), xa_in_b[:, 2] > 0.1
    sf = torch.full((), config.orb.scale_factor, dtype=torch.float32, device=dev)
    scale_a = torch.pow(sf, m.kf_octave[cur_slot].to(torch.float32))
    scale_b = torch.pow(sf, m.kf_octave[cand_slot].to(torch.float32))
    # radius 7.5 px times the octave scale of the TARGET feature (th=7.5)
    d2_a = torch.sum((uv_a[:, None, :] - uvb_in_a[None, :, :]) ** 2, -1)         # [Fa, Fb]
    d2_b = torch.sum((m.kf_xy[cand_slot][:, None, :] - uva_in_b[None, :, :]) ** 2, -1)
    win_a = d2_a <= (7.5 * scale_a[:, None]) ** 2
    win_b = d2_b <= (7.5 * scale_b[:, None]) ** 2
    ham = hamming_matrix(m.kf_desc[cur_slot], m.kf_desc[cand_slot])
    gate_ab = (win_a & win_b.T & (ham <= TH_HIGH) & m.kf_feat_valid[cur_slot][:, None]
               & has_b[None, :] & zb_ok[None, :] & za_ok[:, None] & has_a[:, None])
    dg = torch.where(gate_ab, ham, MAX_DIST + 1)
    best_b_for_a = torch.argmin(dg, dim=1)
    best_a_for_b = torch.argmin(dg, dim=0)
    mutual = ((best_a_for_b[best_b_for_a] == ar_f)
              & (torch.gather(dg, 1, best_b_for_a[:, None])[:, 0] <= TH_HIGH))
    xg_b = x_b_all[best_b_for_a]
    uvg_b = m.kf_xy[cand_slot][best_b_for_a]
    pair2 = mutual | best_inl
    x_b2 = torch.where(best_inl[:, None], x_b, xg_b)
    uv_b2 = torch.where(best_inl[:, None], uv_b, uvg_b)

    # --- stage 3: GN Sim3 refine + inlier recount --------------------------
    R2, t2, s2 = _sim3_gn_refine(x_b2, x_a, uv_a, uv_b2, pair2.to(torch.float32), R1, t1, s1,
                                 cam, fix_scale)
    e2a = _reproj_err(s2 * (x_b2 @ R2.T) + t2, uv_a, cam)
    Ri2, ti2, si2 = lie.sim3_inverse(R2, t2, s2)
    e2b = _reproj_err(si2 * (x_a @ Ri2.T) + ti2, uv_b2, cam)
    n_inl = torch.sum(pair2 & (e2a <= 9.21) & (e2b <= 9.21))

    # --- stage 4: loop-region projection gate ------------------------------
    # points observed by the candidate or its covisible group, projected
    # into the current keyframe through the corrected pose (reference
    # :352-397: nTotalMatches >= 40)
    group = (m.covis[cand_slot] > 0) | (torch.arange(K, device=dev) == cand_slot)
    obs = torch.where(group[:, None] & (m.kf_obs_point >= 0), m.kf_obs_point.clamp(0, P - 1),
                      P - 1).reshape(-1).long()
    region = torch.zeros((P,), dtype=torch.bool, device=dev).index_fill(0, obs, True)
    region = region | group[m.pt_ref_kf.clamp(0, K - 1).long()]
    region = region & m.pt_valid & (torch.arange(P, device=dev) < P - 1)   # not the dump slot
    x_cur = s2 * (lie.transform_points(T_cand, m.pt_pos) @ R2.T) + t2
    uv_r = _project(x_cur, cam)
    cand_pts = (region & (x_cur[:, 2] > 0.1)
                & (uv_r[:, 0] >= 0) & (uv_r[:, 0] < cam.width)
                & (uv_r[:, 1] >= 0) & (uv_r[:, 1] < cam.height))
    d2_r = torch.sum((uv_a[:, None, :] - uv_r[None, :, :]) ** 2, -1)              # [F, P]
    gate_r = ((d2_r <= (10.0 * scale_a[:, None]) ** 2)
              & (hamming_matrix(m.kf_desc[cur_slot], m.pt_desc) <= TH_HIGH)
              & m.kf_feat_valid[cur_slot][:, None] & cand_pts[None, :])
    n_total = torch.sum(torch.any(gate_r, dim=1))

    ok = (n_inl >= MIN_LOOP_INLIERS) & (n_total >= MIN_LOOP_TOTAL)
    return LoopMatch(ok=ok, T_rel=lie.make_T(R2, t2), s_rel=s2, n_inliers=n_inl,
                     n_total=n_total)


def _geometric_loop_query(m: MapState, kf_slot: int, config: SystemConfig):
    """Vocabulary-free loop candidate nomination: every feature of the
    keyframe names its exact Hamming nearest neighbour among the features
    of all OLD keyframes (id <= current - 20), and the keyframe owning the
    most nearest neighbours is the candidate.  Verification is left to the
    Sim3 pipeline.  Returns ``(n_votes, owner_slot)``, 0-d tensors."""
    K, F = m.kf_capacity, m.feat_capacity
    dev = m.kf_valid.device
    old_kf = m.kf_valid & (m.kf_id <= m.kf_id[kf_slot] - 20)
    best_flat, ok = _brute_match_points(m.kf_desc[kf_slot], m.kf_feat_valid[kf_slot],
                                        m.kf_desc.reshape(K * F, 8),
                                        (m.kf_feat_valid & old_kf[:, None]).reshape(K * F))
    owner_of = best_flat // F
    votes = torch.zeros((K,), dtype=torch.int32, device=dev).index_add(
        0, torch.where(ok, owner_of, K - 1), ok.to(torch.int32))
    votes = torch.where(old_kf & (torch.arange(K, device=dev) != kf_slot), votes, 0)
    owner = torch.argmax(votes)
    return row(votes, owner), owner


class EssentialEdges(NamedTuple):
    e_i: torch.Tensor
    e_j: torch.Tensor
    e_T: torch.Tensor
    e_s: torch.Tensor
    e_w: torch.Tensor
    e_valid: torch.Tensor


def build_essential_edges(m: MapState, cur_slot: int, cand_slot: int, T_loop, s_loop):
    """Temporal chain + strong covisibility edges + every persistent loop
    edge + the new loop edge (reference: src/orboptimizer.cpp:875-1000;
    stored loop edges join every solve, src/orbkeyframe.cpp:458-470).  The
    covisibility edges are the first 4K entries of the upper-triangle mask
    in row-major order (a stable sort of the flattened mask: static shape,
    no host read); unused entries are (0, 0) and invalid."""
    K = m.kf_capacity
    L = m.loop_valid.shape[0]
    dev = m.kf_valid.device
    ar = torch.arange(K, device=dev)
    ids = torch.where(m.kf_valid, m.kf_id, _I32_MAX)
    order = torch.argsort(ids, stable=True)              # valid keyframes first by id
    nxt = torch.roll(order, -1)
    chain_ok = m.kf_valid[order] & m.kf_valid[nxt] & (ar < m.kf_valid.sum() - 1)

    covis_mask = (m.covis >= ESSENTIAL_COVIS_MIN) & (ar[:, None] < ar[None, :])
    flat = covis_mask.reshape(-1)
    first = torch.sort((~flat).to(torch.uint8), stable=True).indices[:4 * K]
    first = torch.where(torch.arange(4 * K, device=dev) < flat.sum(), first, 0)
    ci, cj = first // K, first % K
    c_ok = flat[first]

    lp_i, lp_j = m.loop_i.long(), m.loop_j.long()
    lp_ok = m.loop_valid & m.kf_valid[lp_i] & m.kf_valid[lp_j]
    one = torch.ones((1,), dtype=torch.int64, device=dev)
    e_i = torch.cat([order, ci, lp_i, one * cur_slot])
    e_j = torch.cat([nxt, cj, lp_j, one * cand_slot])
    e_valid = torch.cat([chain_ok, c_ok, lp_ok, one.to(torch.bool)])
    e_T = m.kf_T_cw[e_i] @ lie.inv_T(m.kf_T_cw[e_j])
    # measured relative similarities of the loop edges: S_ij = S_rel
    e_T = torch.cat([e_T[:5 * K], m.loop_T, T_loop[None]])
    ones = torch.ones((5 * K,), dtype=torch.float32, device=dev)
    e_s = torch.cat([ones, m.loop_s, s_loop.reshape(1).to(torch.float32)])
    e_w = torch.cat([ones, torch.full((L + 1,), 5.0, device=dev)])
    return EssentialEdges(e_i=e_i.to(torch.int32), e_j=e_j.to(torch.int32), e_T=e_T, e_s=e_s,
                          e_w=e_w, e_valid=e_valid)


def correct_loop(m: MapState, cur_slot: int, cand_slot: int, T_loop, s_loop,
                 n_iters: int = 15, fix_scale: bool = True) -> MapState:
    """Essential-graph Sim(3) optimization + point correction through the
    points' reference keyframes (reference: src/loopclosing.cpp:400-585 and
    the spanning-tree propagation of :645-750).  With ``fix_scale=False``
    (mono) per-vertex scales absorb scale drift and points move by the full
    similarity."""
    K = m.kf_capacity
    dev = m.kf_valid.device
    T_old = m.kf_T_cw
    edges = build_essential_edges(m, cur_slot, cand_slot, T_loop, s_loop)
    fixed = torch.arange(K, device=dev) == cand_slot
    prob = PoseGraphProblem(T=T_old, v_valid=m.kf_valid, v_fixed=fixed, e_i=edges.e_i,
                            e_j=edges.e_j, e_T_ij=edges.e_T, e_weight=edges.e_w,
                            e_valid=edges.e_valid, e_s_ij=edges.e_s)
    T_new, s_new = optimize_pose_graph(prob, n_iters=n_iters, fix_scale=fix_scale)
    T_new = torch.where(m.kf_valid[:, None, None], T_new, T_old)
    s_new = torch.where(m.kf_valid, s_new, 1.0)
    # divergence-revert guard: a solve with non-finite poses or vertices
    # thrown far outside the map's extent is discarded wholesale
    extent = torch.max(torch.abs(torch.where(m.kf_valid[:, None], T_old[:, :3, 3], 0.0)))
    sane = (torch.isfinite(T_new).all() & torch.isfinite(s_new).all()
            & (torch.max(torch.abs(T_new[:, :3, 3])) < 100.0 * (extent + 1.0)))
    T_new = torch.where(sane, T_new, T_old)
    s_new = torch.where(sane, s_new, 1.0)

    # p' = S_wc_new[ref] o S_cw_old[ref] (CorrectLoop's point update,
    # reference: src/loopclosing.cpp:467-500)
    ref = m.pt_ref_kf.clamp(0, K - 1).long()
    Rw, tw, sw = lie.sim3_inverse(T_new[:, :3, :3], T_new[:, :3, 3] * s_new[:, None], s_new)
    Rc, tc, sc = lie.sim3_compose(Rw, tw, sw, T_old[:, :3, :3], T_old[:, :3, 3],
                                  torch.ones_like(s_new))
    pc = sc[ref, None] * (Rc[ref] @ m.pt_pos[:, :, None])[:, :, 0] + tc[ref]
    m = m._replace(kf_T_cw=T_new, pt_pos=torch.where(m.pt_valid[:, None], pc, m.pt_pos))
    return m._replace(covis=recompute_covisibility(m))


def verify_and_apply(m: MapState, kf_nodes, cur_slot: int, cand_slot: int, expect_cur_id: int,
                     expect_cand_id: int, generator, config: SystemConfig,
                     fix_scale: bool = True):
    """Sim3 verification + masked loop application, with no host read.

    The correction (``correct_loop`` + ``add_loop_edge``) is always
    computed and is selected only when verification succeeds AND both
    slots still hold the keyframes the detection named (slot recycling).
    Returns ``(map', valid, T_kf_pre, T_kf_post)``; with ``valid`` False
    ``map'`` equals ``m``, so the caller adopts it at once and reads
    ``valid`` later (the LoopClosing thread's ComputeSim3 + CorrectLoop off
    the tracking path, reference: src/loopclosing.cpp:228-266, 400-585)."""
    lm = compute_loop_transform(m, kf_nodes, cur_slot, cand_slot, generator, config, fix_scale)
    valid = (lm.ok & m.kf_valid[cur_slot] & (m.kf_id[cur_slot] == expect_cur_id)
             & m.kf_valid[cand_slot] & (m.kf_id[cand_slot] == expect_cand_id))
    applied = add_loop_edge(correct_loop(m, cur_slot, cand_slot, lm.T_rel, lm.s_rel,
                                         fix_scale=fix_scale),
                            cur_slot, cand_slot, lm.T_rel, lm.s_rel)
    m2 = MapState(*(b if a is b else torch.where(valid, a, b) for a, b in zip(applied, m)))
    return m2, valid, m.kf_T_cw[cur_slot], m2.kf_T_cw[cur_slot]


class LoopCloser:
    """Host-side detection state machine: consistency groups across
    consecutive keyframes (reference: src/loopclosing.cpp:150-211).  Sim3
    RANSAC sets come from a generator seeded 7 that advances, as the
    reference package splits ``PRNGKey(7)`` once per verification."""

    def __init__(self, config: SystemConfig, device="cpu"):
        self.config = config
        # stereo fixes the Sim3 scale; monocular solves it (reference:
        # src/sim3solver.cpp:45-47, src/orboptimizer.cpp:830 _fix_scale)
        self.fix_scale = config.camera_type != "mono"
        self.prev_groups: list[set[int]] = []
        self.prev_counts: list[int] = []
        self.last_loop_kf_id = -10**9
        self.generator = torch.Generator(device=device).manual_seed(7)
        # True: the caller schedules the post-loop GBA incrementally
        # (global_ba.IncrementalGBA) instead of blocking in harvest()
        self.defer_gba = False
        self._geo_tick = 0

    def dispatch(self, m: MapState, db: KeyFrameDatabase, kf_nodes, kf_slot: int, kf_id: int):
        """Launch the detection queries for a new keyframe without reading
        anything back; returns a pending dict for :meth:`harvest_detect`
        (once ``pending["ready"]()``), or None when detection is skipped
        (< 10 keyframes since the last loop, reference:
        src/loopclosing.cpp:104).  The geometric vote runs every third
        dispatch and rides the same fetch."""
        if kf_id - self.last_loop_kf_id < 10:
            return None
        cands, _ = loop_candidates(m, db, kf_slot)
        safe_c = cands.clamp(0, m.kf_capacity - 1)
        self._geo_tick += 1
        run_geo = self._geo_tick % 3 == 0
        if run_geo:
            n_votes, owner = _geometric_loop_query(m, kf_slot, self.config)
        else:
            n_votes = owner = torch.zeros((), dtype=torch.int64, device=cands.device)
        fetch = HostFetch(cands, m.kf_valid.sum(), m.kf_id, m.covis[safe_c] > 0,
                          n_votes.to(torch.int64), owner.to(torch.int64))
        return {"fetch": fetch, "kf_slot": kf_slot, "kf_id": kf_id, "run_geo": run_geo,
                "ready": fetch.done}

    def on_keyframe(self, m: MapState, db: KeyFrameDatabase, kf_nodes, kf_slot: int,
                    kf_id: int | None = None):
        """Synchronous detect + close: ``(map, loop_closed, T_corrected_cur
        or None)``."""
        if kf_id is None:
            kf_id = int(m.kf_id[kf_slot])
        pending = self.dispatch(m, db, kf_nodes, kf_slot, kf_id)
        if pending is None:
            return m, False, None
        return self.harvest(pending, m, kf_nodes)

    def harvest_detect(self, pending):
        """The host consistency logic over a finished detection fetch (no
        device read).  Returns None or ``(kf_slot, kf_id, cand_slot,
        cand_id)`` for :func:`verify_and_apply`."""
        kf_slot, kf_id, run_geo = pending["kf_slot"], pending["kf_id"], pending["run_geo"]
        cands_np, n_valid, kf_ids, covis_rows, geo_n, geo_owner = pending["fetch"].result()
        if int(n_valid) < 10:
            return None
        cand_rows = {int(c): covis_rows[i] for i, c in enumerate(cands_np) if c >= 0}
        accepted = None
        new_groups, new_counts = [], []
        for c, covis_row in cand_rows.items():
            # groups are keyed by keyframe ids, not slots: culling and
            # eviction recycle slots between keyframes
            group = {int(kf_ids[c])} | {int(kf_ids[j]) for j in np.nonzero(covis_row)[0]}
            count = 0
            for g_prev, c_prev in zip(self.prev_groups, self.prev_counts):
                if group & g_prev:
                    count = max(count, c_prev + 1)
            new_groups.append(group)
            new_counts.append(count)
            if count >= COVIS_CONSISTENCY_TH - 1 and accepted is None:
                accepted = c
        self.prev_groups, self.prev_counts = new_groups, new_counts
        # the geometric vote takes precedence when strong: on self-similar
        # scenes the BoW consistency gate can pass for consistently wrong
        # candidates; every candidate still has to pass the Sim3 gates
        if run_geo and int(n_valid) >= 20 and int(geo_n) >= GEO_VOTE_MIN:
            accepted = int(geo_owner)
        if accepted is None:
            return None
        return kf_slot, kf_id, accepted, int(kf_ids[accepted])

    def harvest(self, pending, m: MapState, kf_nodes):
        """Synchronous detect + verify + apply (+ the blocking GBA unless
        ``defer_gba``): ``(map, loop_closed, T_corrected_cur or None)``."""
        det = self.harvest_detect(pending)
        if det is None:
            return m, False, None
        kf_slot, kf_id, cand_slot, cand_id = det
        m2, valid, _, _ = verify_and_apply(m, kf_nodes, kf_slot, cand_slot, kf_id, cand_id,
                                           self.generator, self.config, self.fix_scale)
        if not bool(valid):
            return m, False, None
        m = m2
        # RunGlobalBundleAdjustment after a loop, 10 iterations (reference:
        # src/loopclosing.cpp:645-750)
        if not self.defer_gba:
            from .global_ba import run_global_ba

            m = run_global_ba(m, self.config, n_outer=10)
        self.last_loop_kf_id = kf_id
        self.prev_groups, self.prev_counts = [], []
        return m, True, m.kf_T_cw[kf_slot]
