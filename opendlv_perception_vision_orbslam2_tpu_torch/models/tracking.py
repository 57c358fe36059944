"""Tracking front end: motion-model stereo visual odometry (the per-frame path).

Counterpart of the reference package's ``models/tracking.py``
(Tracking::Track / TrackWithMotionModel / UpdateLastFrame, reference:
src/tracking.cpp:262-339, 696-757, 631-694):

  frame features + last-frame depth points
    -> projection-gated Hamming matching        (ops/matching.py)
    -> pose-only GN with chi2 reclassification  (optim/pose_opt.py)
    -> velocity update

State is a NamedTuple of tensors; the host loop reads one scalar per
frame (the inlier count, for lost detection).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie
from ..ops import matching
from ..optim.pose_opt import PoseObs, robust_pose_estimate
from ..utils.config import SystemConfig
from .frame import FrameState, features_scale_sigma2
from .frontend import process_stereo

MIN_MATCHES_MOTION = 20   # reference: src/tracking.cpp:744
MIN_INLIERS_POSE = 10     # reference: src/tracking.cpp:756
MAX_VO_POINTS = 100       # close/far VO point budget (reference: src/tracking.cpp:668-686)
SRC_BUDGET = 1024         # static source-point cap for the matchers


class TrackState(NamedTuple):
    """Tracker state between frames."""

    T_cw: torch.Tensor        # [4, 4] current camera pose
    velocity: torch.Tensor    # [4, 4] T_cur <- T_prev motion model
    last_frame: FrameState
    n_inliers: torch.Tensor   # [] int (diagnostics / lost detection)


def _compact_sources(state: TrackState, th_far: float):
    """The SRC_BUDGET closest last-frame depth points, world coords + masks
    (UpdateLastFrame's temporal points, reference: src/tracking.cpp:631-694):
    usable = close points plus the nearest remaining up to MAX_VO_POINTS.

    Returns ``(src_idx [S], p_w [S,3], usable [S], desc/octave/angle/depth)``.
    """
    feats = state.last_frame.features
    depth = feats.depth
    has_depth = (depth > 0) & feats.valid
    inf = torch.full_like(depth, float("inf"))
    order = torch.argsort(torch.where(has_depth, depth, inf), stable=True)
    src = order[:SRC_BUDGET]

    d_s = depth[src]
    hd_s = has_depth[src]
    pos = torch.arange(src.shape[0], device=depth.device)
    usable = hd_s & ((d_s < th_far) | (pos < MAX_VO_POINTS))

    T_wc = lie.inv_T(state.last_frame.T_cw)
    p_w = lie.transform_points(T_wc, state.last_frame.point_cam[src])
    return src, p_w, usable, feats.desc[src], feats.octave[src], feats.angle[src], d_s


def motion_model_step(state: TrackState, cur_frame: FrameState,
                      config: SystemConfig, radius_mult: int = 1,
                      generator=None):
    """One tracking step: returns ``(T_cw, inlier_count, match_count)``.

    The retry ladder (x1 -> x2 -> brute; reference: src/tracking.cpp:744-748)
    runs inside the step over one shared Hamming matrix.  ``generator``
    draws the EPnP-RANSAC sets."""
    cam = config.camera
    T_pred = state.velocity @ state.T_cw

    th_far = config.tracking.th_depth * cam.baseline_m
    _, p_w, usable, desc_s, oct_s, ang_s, d_s = _compact_sources(state, th_far)

    m, n_matches = matching.motion_ladder_match(
        p_w, usable, desc_s, oct_s, ang_s, d_s,
        cur_frame.features, T_pred,
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
        width=cam.width, height=cam.height,
        scale_factor=config.orb.scale_factor,
        z_motion=state.velocity[2, 3], baseline=cam.baseline_m,
        th_far=th_far, radius_mult=radius_mult,
        min_matches=MIN_MATCHES_MOTION,
    )

    dst = m.dst_idx
    feats = cur_frame.features
    sigma2 = features_scale_sigma2(feats, config.orb.scale_factor)
    obs = PoseObs(
        p_w=p_w,
        uv=feats.xy[dst],
        u_right=feats.u_right[dst],
        sigma2=sigma2[dst],
        valid=m.valid,
    )
    T_new, _, n_inliers = robust_pose_estimate(
        T_pred, obs, generator,
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
    )
    return T_new, n_inliers, n_matches


def vo_step(state: TrackState, img_left, img_right, config: SystemConfig,
            timestamp=0.0, generator=None):
    """Front end + tracking step, the per-frame program: returns
    ``(new_state, T_cw)``."""
    cur = process_stereo(img_left, img_right, config, timestamp)
    T_new, n_inliers, _ = motion_model_step(state, cur, config, 1, generator)
    cur = cur._replace(T_cw=T_new)
    velocity = T_new @ lie.inv_T(state.T_cw)
    new_state = TrackState(
        T_cw=T_new, velocity=velocity, last_frame=cur, n_inliers=n_inliers
    )
    return new_state, T_new


def init_state(first_frame: FrameState) -> TrackState:
    """Stereo initialization: world = first camera frame, identity pose
    (StereoInitialization, reference: src/tracking.cpp:342-395)."""
    dev = first_frame.T_cw.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return TrackState(
        T_cw=eye, velocity=eye.clone(), last_frame=first_frame,
        n_inliers=torch.zeros((), dtype=torch.int64, device=dev),
    )


class StereoVisualOdometry:
    """Host-side loop around :func:`vo_step`: stereo initialization and
    lost bookkeeping, on ``device`` (the card unless the caller asks for
    the CPU; without a card the default raises).  Each frame's EPnP-RANSAC
    sets are drawn from a generator re-seeded with the constant ``seed``
    just before the draw, as the reference draws each frame with a fresh
    ``PRNGKey(0)``: a frame's draw depends on that frame alone."""

    def __init__(self, config: SystemConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StereoVisualOdometry(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        #: the constant the per-frame RANSAC generator is re-seeded with
        self.seed = 0
        self.generator = torch.Generator(device=self.device)
        self.state: TrackState | None = None
        self.trajectory: list = []
        self.lost = False

    def _to_device(self, img):
        if isinstance(img, np.ndarray):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(device=self.device, dtype=torch.float32)

    def process(self, img_left, img_right, timestamp: float = 0.0):
        """Track one stereo pair (numpy or tensor ``[H, W]``); returns the
        world->camera pose, or None while stereo initialization waits."""
        img_left = self._to_device(img_left)
        img_right = self._to_device(img_right)
        if self.state is None:
            frame = process_stereo(img_left, img_right, self.config, timestamp)
            if int(torch.sum(frame.features.depth > 0)) < 100:
                return None  # stereo init needs enough depth points
            self.state = init_state(frame)
            self.trajectory.append(self.state.T_cw)
            return self.state.T_cw

        self.generator.manual_seed(self.seed)
        self.state, T_new = vo_step(self.state, img_left, img_right, self.config,
                                    timestamp, self.generator)
        self.lost = int(self.state.n_inliers) < MIN_INLIERS_POSE
        self.trajectory.append(T_new)
        return T_new
