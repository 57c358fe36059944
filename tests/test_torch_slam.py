"""The port's stereo SLAM slice vs the reference package.

Both ``StereoSlam``s (loop closing and relocalization off, 32 keyframe /
4096 point slots) are fed the same reference front-end frames through
``_step`` with ``force_sync_decisions = True``, which makes every decision
and mapping stage synchronous: whether an async stage is adopted at a given
frame depends on timing, so parity is checked in the synchronous schedule.
The EPnP-RANSAC sets are the reference's (``jax.random.categorical`` with a
fresh ``PRNGKey(0)`` each frame, injected through ``pnp.sample_sets``): torch
cannot draw jax.random's bits.

Tolerances, and why:

- ``track_frame_with_map`` from the same state: bindings, counters and the
  decision counts exactly; the pose within 1e-4 (two Gauss-Newton solves
  summed in another order);
- the slice, per frame: the same keyframe decisions and ``n_keyframes``;
  poses within 5 mm and 1e-3 rad (the VO slice's bound); map point counts
  within 2 %: triangulated points sit within 2e-3 of the reference's
  (test_torch_mapping.py), so a point on a gate's edge can pass on one side
  only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.models import slam as jslam
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu.utils import synthetic as jsyn
from opendlv_perception_vision_orbslam2_tpu.utils import trajectory as jtraj
from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as tslam
from opendlv_perception_vision_orbslam2_tpu_torch.models import tracking as ttrack
from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp as tpnp
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic as tsyn
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy

torch.set_num_threads(2)

CAM_CFG = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256,
               fps=10.0)
ORB = dict(n_features=600, max_keypoints=1024, n_levels=4)
N_FRAMES = 10   # keyframes at frames 0, 2, 9: the third runs local BA


def _configs(max_map_points):
    kw = dict(max_keyframes=32, max_map_points=max_map_points)
    jcfg = jconfig.SystemConfig(camera=jconfig.CameraConfig(**CAM_CFG),
                                orb=jconfig.OrbConfig(**ORB),
                                tracking=jconfig.TrackingConfig(max_frames=5), **kw)
    tcfg = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM_CFG),
                                orb=tconfig.OrbConfig(**ORB),
                                tracking=tconfig.TrackingConfig(max_frames=5), **kw)
    return jcfg, tcfg


JCFG, TCFG = _configs(4096)
OFF = dict(enable_loop_closing=False, enable_relocalization=False)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_sets(valid, generator=None, n_hypotheses=tpnp.N_HYPOTHESES):
    """The sets the reference draws for this mask: PRNGKey(0) each frame."""
    w = jnp.asarray(valid.numpy()).astype(jnp.float32)
    idx = jax.random.categorical(jax.random.PRNGKey(0), jnp.log(w + 1e-9),
                                 shape=(n_hypotheses, tpnp.SET_SIZE))
    return torch.from_numpy(np.asarray(idx)).to(torch.int64)


@pytest.fixture(scope="module")
def frames():
    lefts, rights, gt, _ = jsyn.render_stereo_sequence(JCFG, n_frames=N_FRAMES, n_points=500,
                                                       seed=5, step=0.25)
    return [jfront.process_stereo(jnp.asarray(lefts[i]), jnp.asarray(rights[i]), JCFG,
                                  i * 0.1) for i in range(N_FRAMES)], np.asarray(gt)


@pytest.fixture(scope="module")
def reference_run(frames):
    """The reference over the frames: per-frame pose, keyframe count and
    point count, and the tracker inputs of every frame."""
    cur_frames, _ = frames
    slam = jslam.StereoSlam(JCFG, **OFF)
    slam.force_sync_decisions = True
    # the single-device pose solve, which the port implements (conftest's
    # 8-device CPU mesh would select the sharded one)
    slam._pose_solver = None
    poses, n_kf, n_pt, inputs = [], [], [], []
    for cur in cur_frames:
        inputs.append(None if slam.last_frame is None else _np_tree(
            (slam.map, slam.last_frame, slam.last_bindings, slam.T_cw, slam.velocity)))
        poses.append(np.asarray(slam._step(cur)))
        n_kf.append(slam.n_keyframes)
        n_pt.append(int(np.asarray(slam.map.pt_valid).sum()))
    slam.finish()
    return poses, n_kf, n_pt, inputs, slam.corrected_trajectory()


@pytest.mark.parametrize("frame", [3, 9])
def test_track_frame_with_map_matches_reference(frames, reference_run, frame, monkeypatch):
    cur_frames, _ = frames
    inputs = reference_run[3][frame]
    m, last, last_b, T, vel = inputs
    ref = jslam.track_frame_with_map(*(jax.tree.map(jnp.asarray, x) for x in inputs[:5]),
                                     cur_frames[frame], JCFG, None)   # as the driver calls it
    monkeypatch.setattr(tpnp, "sample_sets", _reference_sets)
    out = tslam.track_frame_with_map(from_jax_numpy(m), from_jax_numpy(last),
                                     torch.from_numpy(np.array(last_b)),
                                     torch.from_numpy(np.array(T)),
                                     torch.from_numpy(np.array(vel)),
                                     from_jax_numpy(_np_tree(cur_frames[frame])), TCFG)
    np.testing.assert_allclose(out.T_cw.numpy(), np.asarray(ref.T_cw), rtol=0, atol=1e-4)
    for name in ref._fields[1:]:
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(out.n_inliers) > 50


def test_wide_recovery_matches_reference(frames, reference_run, monkeypatch):
    """The recovery rung from a pose 0.3 m off, with the reference's first
    draw from its PRNGKey(11) chain."""
    cur_frames, _ = frames
    m, _, _, T, _ = reference_run[3][9]
    T_guess = np.array(T)
    T_guess[:3, 3] += [0.3, -0.1, 0.2]
    _, sub = jax.random.split(jax.random.PRNGKey(11))
    ref = jslam._wide_recovery_program(jax.tree.map(jnp.asarray, m), cur_frames[9],
                                       jnp.asarray(T_guess), sub, JCFG)

    def reference_sets(valid, generator=None, n_hypotheses=tpnp.N_HYPOTHESES):
        w = jnp.asarray(valid.numpy()).astype(jnp.float32)
        idx = jax.random.categorical(sub, jnp.log(w + 1e-9),
                                     shape=(n_hypotheses, tpnp.SET_SIZE))
        return torch.from_numpy(np.asarray(idx)).to(torch.int64)

    monkeypatch.setattr(tpnp, "sample_sets", reference_sets)
    out = tslam._wide_recovery_program(from_jax_numpy(m), from_jax_numpy(_np_tree(cur_frames[9])),
                                       torch.from_numpy(T_guess), None, TCFG)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    assert int(out[2]) == int(ref[2]) >= tslam.MIN_INLIERS_MAP


def test_adoption_helpers_match_reference(reference_run):
    m = reference_run[3][9][0]
    rng = np.random.default_rng(3)
    P = m.pt_valid.shape[0]
    pt_id_pre = np.where(rng.uniform(size=P) < 0.9, np.asarray(m.pt_first_kf_id), 7)
    vis = rng.integers(0, 3, P).astype(np.int32)
    found = rng.integers(0, 2, P).astype(np.int32)
    binds = rng.integers(-1, 400, 1024).astype(np.int32)
    ref_m, ref_b = jslam.adoption_fixup(jax.tree.map(jnp.asarray, m), *map(
        jnp.asarray, (pt_id_pre.astype(np.int32), vis, found, binds)))
    out_m, out_b = tslam.adoption_fixup(from_jax_numpy(m), *map(
        torch.from_numpy, (pt_id_pre.astype(np.int32), vis, found, binds)))
    np.testing.assert_array_equal(out_b.numpy(), np.asarray(ref_b))
    np.testing.assert_array_equal(out_m.pt_visible.numpy(), np.asarray(ref_m.pt_visible))
    np.testing.assert_array_equal(out_m.pt_found.numpy(), np.asarray(ref_m.pt_found))
    T = np.asarray(m.kf_T_cw)
    for pre, post in ((T[0], T[1]), (T[0], np.zeros((4, 4), np.float32))):  # + degenerate
        ref_T = jslam.rebase_pose(jnp.asarray(T[2]), jnp.asarray(pre), jnp.asarray(post))
        out_T = tslam.rebase_pose(*(torch.from_numpy(np.ascontiguousarray(x))
                                    for x in (T[2], pre, post)))
        np.testing.assert_allclose(out_T.numpy(), np.asarray(ref_T), rtol=0, atol=1e-6)


def test_slam_slice_matches_reference_per_frame(frames, reference_run, monkeypatch):
    cur_frames, _ = frames
    poses, n_kf, n_pt, _, corrected = reference_run
    monkeypatch.setattr(tpnp, "sample_sets", _reference_sets)
    slam = tslam.StereoSlam(TCFG, device="cpu", **OFF)
    slam.force_sync_decisions = True
    for i, cur in enumerate(cur_frames):
        T = slam._step(from_jax_numpy(_np_tree(cur))).numpy()
        T_ref = poses[i]
        assert slam.n_keyframes == n_kf[i], f"frame {i}"
        assert np.linalg.norm(T[:3, 3] - T_ref[:3, 3]) < 5e-3, f"frame {i}"
        cos = np.clip((np.trace(T_ref[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)
        assert np.arccos(cos) < 1e-3, f"frame {i}"
        n = int(slam.map.pt_valid.sum())
        assert abs(n - n_pt[i]) <= 0.02 * n_pt[i], f"frame {i}: {n} vs {n_pt[i]} points"
        assert not slam.lost
    assert n_kf[-1] >= 3
    slam.finish()
    for i, (T, T_ref) in enumerate(zip(slam.corrected_trajectory(), corrected)):
        assert np.linalg.norm(T[:3, 3] - T_ref[:3, 3]) < 5e-3, f"corrected frame {i}"


@pytest.mark.parametrize("kwargs", [
    dict(enable_loop_closing=True, enable_relocalization=False),
    dict(enable_relocalization=True),             # loop closing is on by default
])
def test_disabled_features_raise(kwargs):
    """Loop closing (the constructor's default) constructs, with no loop
    closer before the first registered keyframe; RGB-D input, ported now,
    runs: one rendered frame with its depth map bootstraps the map at the
    identity pose."""
    slam = tslam.StereoSlam(TCFG, device="cpu", **kwargs)
    assert slam.enable_loop_closing and slam.loop_closer is None and slam.loops_closed == 0
    grays, depths, _, _ = tsyn.render_rgbd_sequence(TCFG, n_frames=1, n_points=500, seed=5)
    T = slam.process_rgbd(grays[0], depths[0])
    assert T is not None and torch.equal(T, torch.eye(4))
    assert slam.n_keyframes == 1 and int(slam.map.pt_valid.sum()) >= 100


@pytest.mark.parametrize("kwargs", [
    dict(enable_loop_closing=False),              # relocalization is on by default
    dict(enable_loop_closing=False, enable_relocalization=True),
    dict(OFF, vocab="given"),
    dict(enable_loop_closing=False, tracking_only=True),
    dict(OFF, tracking_only=True),
])
def test_ported_features_construct(kwargs):
    """Relocalization, a given vocabulary and localization-only mode
    construct; the place-recognition state starts empty."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import vocabulary as tvoc

    if kwargs.get("vocab") == "given":
        descs = np.random.default_rng(0).integers(0, 2**32, (300, 8), dtype=np.uint32)
        kwargs = dict(kwargs, vocab=tvoc.train_vocabulary(descs, branching=4, levels=2))
    slam = tslam.StereoSlam(TCFG, device="cpu", **kwargs)
    assert slam.enable_relocalization == kwargs.get("enable_relocalization", True)
    assert slam.tracking_only == kwargs.get("tracking_only", False) and not slam._vo_mode
    assert slam.db is None and slam.kf_nodes is None
    assert (slam.vocab is None) == ("vocab" not in kwargs)
    # without a card the same calls raise instead of falling back to the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            tslam.StereoSlam(TCFG, **kwargs)


def test_rgbd_raises_and_cuda_needs_a_card():
    """An RGB-D frame without a feature (RGB-D input is ported now) leaves
    the map waiting for its first keyframe; the card is required unless the
    CPU is asked for."""
    slam = tslam.StereoSlam(TCFG, device="cpu", **OFF)
    assert slam.process_rgbd(np.zeros((256, 512), np.float32),
                             np.ones((256, 512), np.float32)) is None
    assert slam.n_keyframes == 0 and slam.last_frame is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tslam.StereoSlam(TCFG, device="cuda", **OFF)


@pytest.mark.parametrize("entry", ["StereoVisualOdometry", "StereoSlam", "MonocularSlam"])
def test_entry_points_default_to_the_card(entry):
    """With no device given, the entry points run on the card, so without
    one they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from opendlv_perception_vision_orbslam2_tpu_torch.models.mono_slam import MonocularSlam

    make = {"StereoVisualOdometry": lambda: ttrack.StereoVisualOdometry(TCFG),
            "StereoSlam": lambda: tslam.StereoSlam(TCFG, **OFF),
            "MonocularSlam": lambda: MonocularSlam(TCFG, **OFF)}[entry]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        make()


@pytest.mark.slow
def test_port_slam_accuracy_bounds():
    """The port end to end on the fixture and bounds of tests/test_slam.py
    (the card gates the same run in chip_smoke.py)."""
    _, tcfg = _configs(16384)
    th_far = tcfg.tracking.th_depth * tcfg.camera.baseline_m
    lefts, rights, gt, world = tsyn.render_stereo_sequence(tcfg, n_frames=14, n_points=500,
                                                           seed=5, step=0.25)
    slam = tslam.StereoSlam(tcfg, device="cpu", **OFF)
    for i in range(14):
        assert slam.process(lefts[i], rights[i], timestamp=i * 0.1) is not None
        assert not slam.lost, f"lost tracking at frame {i}"
    slam.finish()
    assert slam.n_keyframes >= 2
    assert int(slam.map.pt_valid.sum()) > 100
    ate = jtraj.ate_rmse([T.numpy() for T in slam.trajectory], list(gt), align=False)
    assert ate < 0.10, f"ATE {ate:.3f} m"
    pts = slam.map.pt_pos.numpy()[slam.map.pt_valid.numpy()]
    far = pts[:, 2] > th_far + 1.0
    assert far.sum() > 30
    d = np.linalg.norm(pts[far][:, None, :] - world.points[None, :, :], axis=-1)
    assert np.median(d.min(axis=1) / pts[far][:, 2]) < 0.04


def test_a_deferred_decision_inserts_the_frame_its_stats_certify():
    """In the deferred schedule the stats handled while frame k is tracked
    are frame k - 1's, and the keyframe they call for is frame k - 1 itself,
    with the bindings it was tracked with (less any a mapping stage adopted
    since culled), not the frame before it; a synchronous decision inserts
    the frame just tracked.  An RGB-D drive on the CPU (the port alone), a
    keyframe due every frame, so that the engine passes 5 keyframes and
    defers some decisions."""
    cfg = tconfig.SystemConfig(
        camera=tconfig.CameraConfig(**CAM_CFG), orb=tconfig.OrbConfig(**ORB),
        tracking=tconfig.TrackingConfig(max_frames=1, th_depth=35.0, depth_map_factor=1.0),
        camera_type="rgbd", max_keyframes=32, max_map_points=16384)
    grays, depths, _, _ = tsyn.render_rgbd_sequence(cfg, n_frames=20, n_points=900, seed=5,
                                                    step=0.6)
    slam = tslam.StereoSlam(cfg, enable_loop_closing=False, device="cpu")
    inserted, dispatch = [], slam._dispatch_keyframe

    def noted(frame, bindings):
        # frame_idx is k + 1 while frame k is tracked
        inserted.append((slam.frame_idx - 1, slam._pipeline_healthy,
                         int(round(10 * float(frame.timestamp))), bindings))
        return dispatch(frame, bindings)

    slam._dispatch_keyframe = noted
    tracked = {}
    for i in range(len(grays)):
        slam.process_rgbd(grays[i], depths[i], i * 0.1)
        tracked[i] = slam.last_bindings
    deferred = [x for x in inserted if x[1]]
    assert deferred and len(deferred) < len(inserted)
    for k, healthy, made_from, bindings in inserted:
        assert made_from == (k - 1 if healthy else k), (k, healthy, made_from)
        if healthy:
            kept = bindings >= 0
            assert torch.equal(bindings[kept], tracked[made_from][kept])
