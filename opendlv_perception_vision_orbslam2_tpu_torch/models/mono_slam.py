"""Monocular SLAM: the two-view bootstrap feeding the shared tracking and
mapping core.

Counterpart of the reference package's ``models/mono_slam.py``
(MonocularInitialization + CreateInitialMapMonocular, reference:
src/tracking.cpp:397-567): window-gated matching against an init frame, the
batched H/F initializer, median-depth scale normalization, a two-keyframe
map refined by a full BA, then the shared ``StereoSlam._step``, whose stages
key their mono knobs off ``camera_type`` (no stereo point creation, 20
triangulation neighbours, cnThObs 2, thRefRatio 0.9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import lie, matching
from ..ops.indexing import row, scatter_max
from ..utils.config import SystemConfig
from .frame import FrameState
from .frontend import process_mono
from .global_ba import run_global_ba
from .initializer import initialize_two_view
from .map_state import insert_keyframe
from .slam import StereoSlam

MIN_INIT_FEATURES = 100   # reference: src/tracking.cpp:404, 421
# The reference demands 100 matches with its doubled mono feature budget
# (2*nFeatures, reference: src/tracking.cpp:433); scaled configs (tests)
# override the instance attribute.
MIN_INIT_MATCHES = 100


class MonocularSlam(StereoSlam):
    """Monocular variant: the same tracking and mapping core, a two-view
    bootstrap and no stereo point source.  Scale is arbitrary, normalized to
    median scene depth 1 at initialization (reference:
    src/tracking.cpp:537-552).  The initializer's RANSAC sets come from a
    generator seeded 21 once, which advances with every attempt, as the
    reference package splits ``PRNGKey(21)``."""

    def __init__(self, config: SystemConfig, vocab=None, enable_loop_closing: bool = True,
                 enable_relocalization: bool = True, device="cuda"):
        if config.camera_type != "mono":
            # the shared stages key their sensor knobs off camera_type
            config = dataclasses.replace(config, camera_type="mono")
        super().__init__(config, vocab, enable_loop_closing, enable_relocalization,
                         device=device)
        self._init_ref: FrameState | None = None
        self._init_gen = torch.Generator(device=self.device).manual_seed(21)
        self.initialized = False
        self.min_init_matches = MIN_INIT_MATCHES
        # reference minTriangulated (src/orbinitializer.cpp:468-571); scale
        # down with reduced feature budgets
        self.min_triangulated = 50

    def reset(self):
        super().reset()
        self._init_ref = None
        self.initialized = False

    def _try_initialize(self, cur: FrameState):
        if self._init_ref is None:
            if int(cur.features.valid.sum()) > MIN_INIT_FEATURES:
                self._init_ref = cur
            return None

        ref = self._init_ref
        idx_b, ok = matching.search_for_initialization(ref.features, cur.features)
        if int(ok.sum()) < self.min_init_matches:
            self._init_ref = cur      # the reference resets the init frame (:436-441)
            return None

        cam = self.config.camera
        res = initialize_two_view(ref.features.xy, cur.features.xy[idx_b], ok, self._init_gen,
                                  fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                                  min_triangulated=self.min_triangulated)
        if not bool(res.success):
            return None

        # median-depth normalization (reference: :537-552)
        good = res.point_ok.cpu().numpy()
        depths = res.points.cpu().numpy()[good][:, 2]
        med = float(np.median(depths)) if len(depths) else 1.0
        if med <= 0:
            self._init_ref = cur
            return None
        inv_med = 1.0 / med
        pts = res.points * inv_med
        T21 = lie.make_T(res.T_21[:3, :3], res.T_21[:3, 3] * inv_med)

        # the two-keyframe map: the triangulated points become the init
        # frame's "depth" so insert_keyframe creates them; the second
        # keyframe binds the same slots through the match
        F = ref.features.capacity
        self._ensure_vocab(ref)
        good_j = res.point_ok & ok
        ref = ref._replace(
            T_cw=self._eye(),
            features=ref.features._replace(depth=torch.where(good_j, pts[:, 2], -1.0)),
            point_cam=torch.where(good_j[:, None], pts, 0.0))
        cur2 = cur._replace(T_cw=T21)
        self.map, slot0 = insert_keyframe(self.map, ref, self._no_bindings(F), 1e9)
        cur_binds = scatter_max(self._no_bindings(F), torch.where(good_j, idx_b, F - 1),
                                torch.where(good_j, row(self.map.kf_obs_point, slot0), -1))
        self.map, slot1 = insert_keyframe(self.map, cur2, cur_binds, 1e9)
        slot0, slot1 = int(slot0), int(slot1)
        self._register_keyframe(slot0, 0)
        self._register_keyframe(slot1, 1)
        # full BA over the fresh map (CreateInitialMapMonocular runs
        # GlobalBundleAdjustemnt(20), reference: src/tracking.cpp:519).  Its
        # steps keep every point in front of both keyframes: the cost leaves
        # out the edges of points behind a camera, and with the scale free
        # the solve otherwise finds the minimum where every point lies
        # behind the second keyframe (g2o's cost, which the reference
        # minimizes, keeps those edges)
        self.map = run_global_ba(self.map, self.config, n_outer=10, cg_iters=20,
                                 hold_cheirality=True)
        # ORB-SLAM2's check after that BA (src/tracking.cpp:537-552): a
        # median scene depth <= 0 is a wrong initialization, and the system
        # resets.  It is checked here in both keyframes: the BA's cost drops
        # the edges of points behind a camera, and from a poor two-view
        # motion the solve can reach the minimum where every point lies
        # behind the second keyframe (the reference package checks the
        # depth only before the BA)
        if min(self._median_depth(slot0), self._median_depth(slot1)) <= 0:
            self.reset()
            return None
        T21 = self.map.kf_T_cw[slot1]
        self.n_keyframes = 2
        self.initialized = True
        self._occ = (2, int(self.map.pt_valid.sum()))
        self._inserts_since_occ = 0
        self.T_cw = T21
        self.velocity = self._eye()
        self.last_frame = cur2._replace(T_cw=T21)
        self.last_bindings = self.map.kf_obs_point[slot1]
        self.ref_kf_tracked = int((self.last_bindings >= 0).sum())
        for slot, kf_id in ((slot0, 0), (slot1, 1)):
            self.last_kf_slot, self.last_kf_id = slot, kf_id
            self._log_pose(self.map.kf_T_cw[slot])
        return T21

    def _median_depth(self, slot: int) -> float:
        """Median camera-frame depth of the points keyframe ``slot`` observes
        (ComputeSceneMedianDepth, reference: src/orbkeyframe.cpp:666-689)."""
        m = self.map
        binds = m.kf_obs_point[slot]
        z = lie.transform_points(m.kf_T_cw[slot], m.pt_pos[binds.clamp(min=0).long()])[:, 2]
        z = z.cpu().numpy()[(binds >= 0).cpu().numpy()]
        return float(np.median(z)) if len(z) else 0.0

    def process(self, img, timestamp: float = 0.0):
        """Track one grayscale image (numpy or tensor ``[H, W]``;
        GrabImageMonocular, reference: src/tracking.cpp:233-260); returns the
        world->camera pose, or None until the map is bootstrapped.  Until
        then the extraction budget is doubled, capped at ``max_keypoints``
        (mpIniORBextractor, reference: src/tracking.cpp:118-121, 433)."""
        img = self._to_device(img, 0)
        if not self.initialized:
            orb = self.config.orb
            cfg_init = dataclasses.replace(self.config, orb=dataclasses.replace(
                orb, n_features=min(2 * orb.n_features, orb.max_keypoints)))
            return self._try_initialize(process_mono(img, cfg_init, timestamp))
        return self._step(process_mono(img, self.config, timestamp))
