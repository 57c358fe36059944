"""Relocalization: BoW candidates -> EPnP RANSAC -> pose optimization.

Counterpart of the reference package's ``models/relocalization.py``
(Tracking::Relocalization, reference: src/tracking.cpp:1177-1338): query the
keyframe database, BoW-match each candidate (>= 15 matches), run EPnP RANSAC,
then pose-optimize from its consensus set (``refine_pose``) and accept at >=
50 inliers.  Candidates are few and relocalization is rare, so the
per-candidate loop stays on the host and reads its gate counts back; each
stage is one batched program.  The RANSAC sets come from ``generator``, which
advances from call to call as the reference package splits its key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import lie
from ..ops.hamming import MAX_DIST, TH_LOW, hamming_matrix
from ..ops.matching import search_by_bow
from ..optim.pnp import pnp_ransac
from ..optim.pose_opt import PoseObs, classify_inliers, pose_optimize
from ..utils.config import SystemConfig
from . import vocabulary as voc
from .frame import FrameState, features_scale_sigma2
from .kfdb import KeyFrameDatabase, detect_candidates
from .map_state import MapState

MIN_BOW_MATCHES = 15    # reference: src/tracking.cpp:1232
MIN_FINAL_INLIERS = 50  # reference: src/tracking.cpp:1322
BRUTE_CHUNK = 8192      # map points per distance block of the brute matcher


class RelocResult(NamedTuple):
    success: bool
    T_cw: Optional[torch.Tensor]
    bindings: Optional[torch.Tensor]


def refine_pose(T_pnp, obs: PoseObs, consensus, *, fx: float, fy: float, cx: float,
                cy: float, bf: float):
    """The pose solve behind both relocalization rungs, from the EPnP pose
    ``T_pnp`` and its consensus set ``consensus [K]`` over the
    correspondences ``obs``.  Returns ``(T_cw, inliers [K])``.

    The Gauss-Newton runs over the consensus set alone, the chi2 test then
    picks the inliers among every correspondence at that pose, and a second
    optimization runs over those: Relocalization hands PoseOptimization the
    PnP inliers only and optimizes again once it has more matches
    (reference: src/tracking.cpp:1262-1310), and the RANSAC-seeded chain of
    ``robust_pose_estimate`` starts the same way.  The reference package
    optimizes over all of ``obs.valid`` instead: appearance matches with
    about half outliers pull the Huber rounds off the EPnP pose, the first
    chi2 reclassification can leave two inliers, and the remaining rounds
    solve a rank-deficient system whose answer is decided by rounding."""
    K = dict(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf)
    T, _, _ = pose_optimize(T_pnp, obs._replace(valid=obs.valid & consensus), **K)
    # once more over every correspondence that pose explains: the matches
    # EPnP's consensus missed now move the pose too
    T, _, _ = pose_optimize(T, obs._replace(valid=classify_inliers(T, obs, **K)), **K)
    return T, classify_inliers(T, obs, **K)


def _solve(p_w, ok, bind, frame: FrameState, config: SystemConfig, generator):
    """EPnP RANSAC (>= 10 inliers) then ``refine_pose`` (>= 50) on the
    correspondences ``feature i <-> p_w[i]`` where ``ok``; ``bind`` are the
    point slots the accepted bindings take."""
    cam = config.camera
    feats = frame.features
    sigma2 = features_scale_sigma2(feats, config.orb.scale_factor)
    res = pnp_ransac(p_w, feats.xy, sigma2, ok, generator,
                     fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
    if int(res.n_inliers) < 10:
        return None
    obs = PoseObs(p_w=p_w, uv=feats.xy, u_right=feats.u_right, sigma2=sigma2, valid=ok)
    T_est, inliers = refine_pose(lie.make_T(res.R, res.t), obs, res.inliers, fx=cam.fx,
                                 fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf)
    if int(inliers.sum()) < MIN_FINAL_INLIERS:
        return None
    return RelocResult(True, T_est, torch.where(inliers, bind, -1))


def relocalize(m: MapState, db: KeyFrameDatabase, kf_nodes, vocab: voc.Vocabulary,
               frame: FrameState, config: SystemConfig, generator=None) -> RelocResult:
    P = m.pt_capacity
    feats = frame.features
    words, nodes = voc.transform(vocab, feats.desc, feats.valid)
    qbow = voc.bow_vector(vocab, words)
    cands, _ = detect_candidates(db, qbow, ~m.kf_valid, 0.0, m.covis)
    cands = [c for c in cands.tolist() if c >= 0]

    for cand in cands[:5]:
        idx_kf, ok = search_by_bow(
            feats.desc, nodes, feats.valid, feats.angle,
            m.kf_desc[cand], kf_nodes[cand], m.kf_feat_valid[cand], m.kf_angle[cand],
            max_dist=50, nn_ratio=0.75)
        bind = m.kf_obs_point[cand][idx_kf]
        safe = bind.clamp(0, P - 1).long()
        pair_ok = ok & (bind >= 0) & m.pt_valid[safe]
        if int(pair_ok.sum()) < MIN_BOW_MATCHES:
            continue
        res = _solve(m.pt_pos[safe], pair_ok, bind, frame, config, generator)
        if res is not None:
            return res
    return RelocResult(False, None, None)


def _brute_match_points(feat_desc, feat_valid, pt_desc, pt_valid, chunk: int = BRUTE_CHUNK):
    """Exact nearest-neighbour Hamming match of frame features against ALL
    map point descriptors, ``chunk`` points at a time so the ``[F, P]``
    distance matrix never exists (512 MB at 2048 x 65536).  A later block
    replaces the running best only on a strictly smaller distance and the
    block's own best is its first minimum, so the result is the first
    minimum over all points.  Returns ``(best_pt [F] int64, ok [F])``."""
    F = feat_desc.shape[0]
    P = pt_desc.shape[0]
    dev = feat_desc.device
    big = MAX_DIST + 1
    best_d = torch.full((F,), big, dtype=torch.int64, device=dev)
    best_i = torch.zeros((F,), dtype=torch.int64, device=dev)
    for start in range(0, P, chunk):
        n = min(chunk, P - start)
        d = hamming_matrix(feat_desc, pt_desc[start:start + n])          # [F, n]
        d = torch.where(pt_valid[None, start:start + n], d, big).to(torch.int64)
        # first minimum of the block: the column rides in the key's low digits
        key = torch.min(d * n + torch.arange(n, device=dev), dim=1).values
        c_bd, c_best = key // n, key % n
        take = c_bd < best_d
        best_d = torch.where(take, c_bd, best_d)
        best_i = torch.where(take, c_best + start, best_i)
    # No best/second ratio test: the map legitimately holds near-duplicate
    # points (octave twins, revisit twins after capacity churn) whose
    # descriptors tie for best, and a ratio gate would reject exactly the
    # true matches.  Precision comes from the geometric consensus the caller
    # runs next.
    return best_i, feat_valid & (best_d <= TH_LOW)


def relocalize_brute(m: MapState, frame: FrameState, config: SystemConfig,
                     generator=None) -> RelocResult:
    """Vocabulary-free global relocalization: instead of the approximate BoW
    inverted file (reference: src/orbkeyframedatabase.cpp:200-314), match the
    frame's descriptors against EVERY map point by exact Hamming nearest
    neighbour, then EPnP RANSAC + pose optimization with the reference's
    >= 50-inlier acceptance (src/tracking.cpp:1322).  The rung for when the
    online-trained vocabulary is too weak to rank candidates."""
    feats = frame.features
    best_pt, ok = _brute_match_points(feats.desc, feats.valid, m.pt_desc, m.pt_valid)
    if int(ok.sum()) < MIN_BOW_MATCHES:
        return RelocResult(False, None, None)
    res = _solve(m.pt_pos[best_pt], ok, best_pt.to(torch.int32), frame, config, generator)
    return res if res is not None else RelocResult(False, None, None)
