"""The port's loop-closing SLAM slice vs the reference package.

- The slice: the shortest ``render_loop_sequence`` drive at 512x256 on which
  the reference package closes a loop (``LOOP_DRIVE``), through both
  ``StereoSlam``s with their defaults (loop closing and relocalization on)
  in the synchronous schedule (``force_sync_decisions``), fed the same
  reference front-end frames through ``_step``.  RANSAC sets are the
  reference's: ``PRNGKey(0)`` for each frame's EPnP draw, and the loop
  closer's ``PRNGKey(7)`` chain for the Sim3 sets (``_LoopKeys``), injected
  through ``pnp.sample_sets`` and ``loop_closing.sample_sets``.  The
  reference runs its single-device GBA and pose solve (the test session's
  8-device CPU mesh would select the sharded ones).
- ``test_kitti_loop_reference_run`` (``slow``): the reference over
  ``chip_smoke.py``'s phase 15 circuit on the CPU, which set its ATE bound.

Tolerances, and why:

- keyframe decisions, ``n_keyframes`` per frame, the closure's frame and its
  current and candidate keyframe ids: identical;
- poses per frame 2 cm and 2e-3 rad.  The SLAM slice holds 5 mm and 1e-3
  rad over its 10 frames (``test_torch_slam.py``); over these 90 frames
  the gap stays below 2 mm until keyframe 16's mapping stage (frame 34),
  where it steps to 14.5 mm and then holds there, both packages tracking
  consistently (float32 rounding in the local BA's solves moves a gate
  decision), and falls back to 1.6 mm with the loop correction;
- the retro-corrected trajectory before ``finish()`` (loop corrected, the
  GBA still running) 2 cm, its ATE within 1 cm of the reference's;
- after ``finish()`` (the GBA merged) the ATE within 3 cm.  From the same
  map the two packages' GBA runs part at once (measured on this drive's
  map: the first chunk ends at cost 8679.45 in the reference, 8230.54 in
  the port, which sums and inverts the landmark blocks in float64, and
  8230.04 in float64), are up to 0.25 m apart within three iterations and
  0.15 m after ten, and float64 lands 0.09-0.16 m from both: the full-map
  problem is nearly flat along some directions (the cost falls 6 % over
  10 iterations), so the solves wander there by rounding.
"""

import functools
import time

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.models import global_ba as jgba
from opendlv_perception_vision_orbslam2_tpu.models import loop_closing as jloop
from opendlv_perception_vision_orbslam2_tpu.models import slam as jslam
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu.utils import synthetic as jsyn
from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing as tloop
from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as tslam
from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp as tpnp
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils import trajectory as ttraj
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy
from test_torch_loop import _KeyChain, corrected_like_the_port

torch.set_num_threads(2)

CAM_CFG = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256,
               fps=10.0)
ORB = dict(n_features=600, max_keypoints=1024, n_levels=4)
KW = dict(max_keyframes=64, max_map_points=32768)
JCFG = jconfig.SystemConfig(camera=jconfig.CameraConfig(**CAM_CFG), orb=jconfig.OrbConfig(**ORB),
                            tracking=jconfig.TrackingConfig(max_frames=5), **KW)
TCFG = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM_CFG), orb=tconfig.OrbConfig(**ORB),
                            tracking=tconfig.TrackingConfig(max_frames=5), **KW)
LOOP_DRIVE = dict(n_frames=90, n_points=1200, seed=11, radius=8.0, laps=1.12)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _frame_sets(valid, generator=None, n_hypotheses=tpnp.N_HYPOTHESES):
    w = jnp.asarray(valid.numpy()).astype(jnp.float32)
    idx = jax.random.categorical(jax.random.PRNGKey(0), jnp.log(w + 1e-9),
                                 shape=(n_hypotheses, tpnp.SET_SIZE))
    return torch.from_numpy(np.asarray(idx)).to(torch.int64)


@pytest.fixture(scope="module")
def drive():
    lefts, rights, gt, _ = jsyn.render_loop_sequence(JCFG, **LOOP_DRIVE)
    frames = [jfront.process_stereo(jnp.asarray(lefts[i]), jnp.asarray(rights[i]), JCFG, i * 0.1)
              for i in range(LOOP_DRIVE["n_frames"])]
    return frames, np.asarray(gt)


@pytest.fixture(scope="module")
def reference_run(drive):
    frames, _ = drive
    mp = pytest.MonkeyPatch()
    mp.setattr(jgba, "IncrementalGBA", functools.partial(jgba.IncrementalGBA, sharded=False))
    corrected_like_the_port(mp)
    verified = []
    inner = jloop.verify_and_apply

    def noted(m, nodes, cur, cand, cur_id, cand_id, *rest):
        verified.append((len(poses), cur_id, cand_id))
        return inner(m, nodes, cur, cand, cur_id, cand_id, *rest)

    mp.setattr(jloop, "verify_and_apply", noted)
    slam = jslam.StereoSlam(JCFG)
    slam.force_sync_decisions = True
    slam._pose_solver = None
    poses, n_kf, closed_at = [], [], []
    try:
        for cur in frames:
            loops = slam.loops_closed
            poses.append(np.asarray(slam._step(cur)))
            n_kf.append(slam.n_keyframes)
            assert not slam.lost
            if slam.loops_closed != loops:
                closed_at.append(len(poses) - 1)
        corrected_before = slam.corrected_trajectory()
        slam.finish()
    finally:
        mp.undo()
    assert slam.loops_closed >= 1 and closed_at
    return dict(poses=poses, n_kf=n_kf, closed_at=closed_at, verified=verified,
                corrected_before=corrected_before, corrected=slam.corrected_trajectory(),
                loops=slam.loops_closed)


class _LoopKeys(_KeyChain):
    """The reference ``StereoSlam``'s loop keys for the port's: split where
    its ``LoopCloser`` dispatches a geometric query and where it dispatches a
    verification."""

    def attach(self, slam):
        chain = self

        class Closer(tloop.LoopCloser):
            def dispatch(self, *args):
                pend = super().dispatch(*args)
                if pend is not None and pend["run_geo"]:
                    chain.split()
                return pend

        inner = slam._dispatch_verify

        def dispatch_verify(det):
            chain.split()
            verified.append((len(port_poses), det[1], det[3]))
            return inner(det)

        verified, port_poses = [], []
        slam._dispatch_verify = dispatch_verify
        return Closer, verified, port_poses


def test_loop_slam_slice_matches_reference(drive, reference_run, monkeypatch):
    frames, gt = drive
    ref = reference_run
    keys = _LoopKeys()
    monkeypatch.setattr(tpnp, "sample_sets", _frame_sets)
    monkeypatch.setattr(tloop, "sample_sets", keys.sample_sets)
    slam = tslam.StereoSlam(TCFG, device="cpu")
    slam.force_sync_decisions = True
    Closer, verified, poses = keys.attach(slam)
    monkeypatch.setattr(tslam, "LoopCloser", Closer)
    closed_at = []
    for i, cur in enumerate(frames):
        loops = slam.loops_closed
        T_step = slam._step(from_jax_numpy(_np_tree(cur)))
        # the pose published (the logged one) is the one the step returns,
        # also where a forced adoption, the correction or the GBA's merge
        # moved the map after the frame was tracked
        assert torch.equal(slam.trajectory[-1], T_step), f"frame {i}"
        poses.append(T_step.numpy())
        assert slam.n_keyframes == ref["n_kf"][i], f"frame {i}"
        assert not slam.lost
        if slam.loops_closed != loops:
            closed_at.append(i)
        T, T_ref = poses[-1], ref["poses"][i]
        assert np.linalg.norm(T[:3, 3] - T_ref[:3, 3]) < 2e-2, f"frame {i}"
        cos = np.clip((np.trace(T_ref[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)
        assert np.arccos(cos) < 2e-3, f"frame {i}"
    before = slam.corrected_trajectory()
    slam.finish()
    assert verified == ref["verified"]
    assert closed_at == ref["closed_at"] and slam.loops_closed == ref["loops"]
    for i, (T, T_ref) in enumerate(zip(before, ref["corrected_before"])):
        assert np.linalg.norm(T[:3, 3] - np.asarray(T_ref)[:3, 3]) < 2e-2, f"corrected {i}"
    ate = [ttraj.ate_rmse([np.asarray(T) for T in traj], list(gt), align=True)
           for traj in (before, ref["corrected_before"], slam.corrected_trajectory(),
                        ref["corrected"])]
    assert abs(ate[0] - ate[1]) < 0.01 and abs(ate[2] - ate[3]) < 0.03, ate


@pytest.mark.slow
def test_kitti_loop_reference_run(monkeypatch):
    """The reference package over ``chip_smoke.py``'s phase 15 on the CPU
    (tens of minutes; run with ``-m slow -s``): the 260-frame KITTI-size loop
    circuit, ``StereoSlam`` with its defaults in the asynchronous mode, the
    single-device GBA and pose solve.  Its retro-corrected ATE is what
    ``chip_smoke.LOOP_ATE_BOUND_M`` was settled against: 0.1788 m, with no
    loop closed (it verified 29 nominations, none with the 20 inliers a
    closure needs; the best, keyframe 62 against keyframe 0 at the revisit,
    had 19)."""
    monkeypatch.setattr(jgba, "IncrementalGBA",
                        functools.partial(jgba.IncrementalGBA, sharded=False))
    jcfg = jconfig.SystemConfig()
    lefts, rights, gt, _ = chip_smoke.render_loop_circuit(tconfig.SystemConfig())
    slam = jslam.StereoSlam(jcfg)
    slam._pose_solver = None
    n = lefts.shape[0]
    lost, closures, t0, lat = 0, [], time.perf_counter(), []
    for i in range(n):
        loops = slam.loops_closed
        t = time.perf_counter()
        T = slam.process(lefts[i], rights[i], timestamp=i / chip_smoke.LOOP_FPS)
        lat.append(time.perf_counter() - t)
        assert T is not None, f"frame {i}"
        lost += int(slam.lost)
        if slam.loops_closed != loops:
            closures.append((i, slam.n_keyframes))
        if i % 20 == 0:
            print(f"frame {i}: keyframes {slam.n_keyframes}, capacity "
                  f"{slam.map.kf_capacity}/{slam.map.pt_capacity}, lost {lost}, loops "
                  f"{slam.loops_closed}, {time.perf_counter() - t0:.0f} s", flush=True)
    slam.finish()
    est = slam.corrected_trajectory()
    assert all(np.isfinite(T).all() for T in est)
    ate = ttraj.ate_rmse(est, list(gt), align=True)
    ate_raw = ttraj.ate_rmse([np.asarray(T) for T in slam.trajectory], list(gt), align=True)
    print(f"\nreference run: {n} frames, loops {slam.loops_closed} (frame, keyframes at the "
          f"verdict: {closures}), keyframes {slam.n_keyframes}, map points "
          f"{int(np.asarray(slam.map.pt_valid).sum())}, capacity {slam.map.kf_capacity} kf / "
          f"{slam.map.pt_capacity} points, lost {lost}, ATE corrected {ate:.4f} m (raw "
          f"{ate_raw:.4f} m), align=True; host s/frame median "
          f"{np.median(lat[chip_smoke.LOOP_WARM:]):.3f}")
    # no loop assertion: on the CPU the reference closes none here (see
    # chip_smoke.REFERENCE_LOOP_ATE_M)
    assert lost < chip_smoke.LOOP_LOST_SHARE * n
    assert ate < chip_smoke.LOOP_ATE_BOUND_M
