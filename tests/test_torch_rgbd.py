"""The port's RGB-D slice vs the reference package on identical numpy inputs.

Fixture: ``tests/test_rgbd.py``'s 512x256 camera, 600 features, 4 levels,
and its world (400 points, seed 3) seen from the origin.  Tolerances, and
why:

- the depth map is index arithmetic and a minimum: exact;
- ``process_rgbd`` given the reference's pyramid: keypoints, octaves,
  validity, depths and the virtual right coordinate exactly (the same
  float32 operations), the back-projected points within 1e-6 relative (XLA
  fuses the multiply and divide), angles within 1e-5 rad (a moment matmul
  summed in another order);
- end to end the port builds its own pyramid, which agrees within 1e-3
  intensity (``tests/test_torch_frontend.py``): >= 98 % of the reference's
  depth keypoints are found by the port at the same pixel with the same
  depth;
- ``tests/test_rgbd.py``'s bars, on the port: > 100 depth keypoints,
  ``u_right = x - bf / d`` within rtol 1e-5 and atol 1e-3, > 90 % of the
  depths exact, the factor-5000 map within rtol 1e-4; slow: the 12-frame
  ATE < 0.10 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.ops import image as jimage
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu.utils import synthetic as jsyn
from opendlv_perception_vision_orbslam2_tpu_torch.models import frontend as tfront
from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as tslam
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic as tsyn
from opendlv_perception_vision_orbslam2_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256, fps=10.0)
ORB = dict(n_features=600, max_keypoints=1024, n_levels=4)


def _configs(depth_map_factor: float = 1.0):
    kw = dict(camera_type="rgbd", max_keyframes=32, max_map_points=16384)
    tr = dict(max_frames=5, th_depth=35.0, depth_map_factor=depth_map_factor)
    return (jconfig.SystemConfig(camera=jconfig.CameraConfig(**CAM),
                                 orb=jconfig.OrbConfig(**ORB),
                                 tracking=jconfig.TrackingConfig(**tr), **kw),
            tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM),
                                 orb=tconfig.OrbConfig(**ORB),
                                 tracking=tconfig.TrackingConfig(**tr), **kw))


def _view_args():
    return (CAM["height"], CAM["width"], CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"])


@pytest.fixture(scope="module")
def frame():
    """The reference's gray render and depth map of test_rgbd.py's world from
    the origin (numpy), and the world."""
    world = jsyn.make_world(400, seed=3)
    T0 = jnp.eye(4, dtype=jnp.float32)
    gray = np.array(jsyn.render_view(T0, world, *_view_args()))
    depth = np.array(jsyn.render_depth_map(T0, world, *_view_args()))
    return gray, depth, world


def _port_rgbd(gray, depth, tcfg, levels=None, monkeypatch=None):
    """``process_rgbd`` on the port, optionally given the pyramid ``levels``."""
    if levels is not None:
        monkeypatch.setattr(tfront.image_ops, "build_pyramid",
                            lambda img, n, s: [torch.from_numpy(np.array(lv)) for lv in levels])
    return tfront.process_rgbd(torch.from_numpy(gray), torch.from_numpy(depth), tcfg, 0.0)


def test_render_depth_map_matches_reference():
    """Exactly the reference's maps, seen from six poses of a yawing,
    sideways drive (nearest depth wins where sprites overlap)."""
    world = jsyn.make_world(400, seed=3)
    tworld = tsyn.make_world(400, seed=3)
    for T in tsyn.straight_trajectory(6, 0.35, 0.02, 0.1):
        ref = np.array(jsyn.render_depth_map(jnp.asarray(T), world, *_view_args()))
        out = tsyn.render_depth_map(T, tworld, *_view_args())
        assert out.dtype == np.float32 and (ref > 0).sum() > 10000
        np.testing.assert_array_equal(out, ref)
    jcfg, tcfg = _configs()
    jg, jd, jgt, _ = jsyn.render_rgbd_sequence(jcfg, n_frames=3, n_points=300, seed=2, step=0.3)
    tg, td, tgt, _ = tsyn.render_rgbd_sequence(tcfg, n_frames=3, n_points=300, seed=2, step=0.3)
    np.testing.assert_array_equal(td, np.array(jd))
    np.testing.assert_array_equal(tgt, np.array(jgt))
    np.testing.assert_allclose(tg, np.array(jg), rtol=0, atol=1e-3)


def test_process_rgbd_exact_given_reference_pyramid(frame, monkeypatch):
    gray, depth, _ = frame
    jcfg, tcfg = _configs()
    ref = jfront.process_rgbd(jnp.asarray(gray), jnp.asarray(depth), jcfg, 0.0)
    levels = jimage.build_pyramid(jnp.asarray(gray), ORB["n_levels"], 1.2)
    out = _port_rgbd(gray, depth, tcfg, levels, monkeypatch)
    for name in ("xy", "response", "octave", "valid", "depth", "u_right"):
        np.testing.assert_array_equal(getattr(out.features, name).numpy(),
                                      np.array(getattr(ref.features, name)), err_msg=name)
    np.testing.assert_allclose(out.point_cam.numpy(), np.array(ref.point_cam), rtol=1e-6, atol=0)
    valid = np.array(ref.features.valid)
    np.testing.assert_allclose(out.features.angle.numpy()[valid],
                               np.array(ref.features.angle)[valid], rtol=0, atol=1e-5)
    assert (np.array(ref.features.depth) > 0).sum() > 100


def test_process_rgbd_end_to_end(frame):
    """The port's own pyramid: the reference's depth keypoints found at the
    same pixel with the same depth and disparity."""
    gray, depth, _ = frame
    jcfg, tcfg = _configs()
    ref = jfront.process_rgbd(jnp.asarray(gray), jnp.asarray(depth), jcfg, 0.0)
    out = _port_rgbd(gray, depth, tcfg)
    rok = np.array(ref.features.valid & (ref.features.depth > 0))
    ook = (out.features.valid & (out.features.depth > 0)).numpy()
    key = lambda f, ok: {(round(float(x), 3), round(float(y), 3), int(o)): (float(d), float(u))  # noqa: E731
                         for (x, y), o, d, u in zip(np.array(f.xy)[ok], np.array(f.octave)[ok],
                                                    np.array(f.depth)[ok], np.array(f.u_right)[ok])}
    rk, ok_ = key(ref.features, rok), key(out.features, ook)
    same = [k for k in rk if k in ok_ and ok_[k][0] == rk[k][0]
            and abs(ok_[k][1] - rk[k][1]) <= 1e-3]
    assert len(same) >= 0.98 * len(rk), (len(same), len(rk))
    assert abs(int(ook.sum()) - int(rok.sum())) <= 0.02 * rok.sum()


def test_rgbd_reference_bars_on_port(frame):
    """tests/test_rgbd.py's two frame tests, run on the port."""
    gray, depth, world = frame
    _, tcfg = _configs()
    cam = tcfg.camera
    feats = _port_rgbd(gray, depth, tcfg).features
    ok = (feats.valid & (feats.depth > 0)).numpy()
    assert ok.sum() > 100
    d = feats.depth.numpy()[ok]
    x = feats.xy.numpy()[ok, 0]
    np.testing.assert_allclose(feats.u_right.numpy()[ok], x - cam.bf / d, rtol=1e-5, atol=1e-3)
    pts = np.array(world.points)
    kp = feats.xy.numpy()[ok]
    p3 = np.stack([(kp[:, 0] - cam.cx) * d / cam.fx, (kp[:, 1] - cam.cy) * d / cam.fy, d], -1)
    nn = np.argmin(((pts[None, :, :] - p3[:, None, :]) ** 2).sum(-1), axis=1)
    exact = np.abs(d - pts[nn, 2]) < 1e-3 * pts[nn, 2]
    assert exact.mean() > 0.9, exact.mean()
    # DepthMapFactor 5000: raw = metric * 5000
    _, tcfg5 = _configs(5000.0)
    f5 = _port_rgbd(gray, depth * 5000.0, tcfg5).features
    ok5 = (f5.valid & (f5.depth > 0)).numpy()
    np.testing.assert_allclose(f5.depth.numpy()[ok5], feats.depth.numpy()[ok5], rtol=1e-4)


@pytest.mark.slow
def test_rgbd_slam_on_synthetic_sequence():
    """tests/test_rgbd.py's 12-frame drive through ``StereoSlam.process_rgbd``
    on the port: ATE < 0.10 m."""
    _, tcfg = _configs()
    grays, depths, gt, _ = tsyn.render_rgbd_sequence(tcfg, n_frames=12, n_points=500, seed=5,
                                                     step=0.25)
    slam = tslam.StereoSlam(tcfg, device="cpu")
    est = [T.numpy() for i in range(12)
           if (T := slam.process_rgbd(grays[i], depths[i], timestamp=i * 0.1)) is not None]
    assert len(est) >= 11
    ate = ttraj.ate_rmse(np.stack(est), gt[-len(est):])
    assert ate < 0.10, ate


def test_rgbd_slam_matches_reference(monkeypatch):
    """Both ``StereoSlam``s over the same 10 reference RGB-D frames through
    ``_step`` (synchronous decisions, the reference's per-frame RANSAC sets):
    the same keyframe decisions, poses within 5 mm and 1e-3 rad, point
    counts within 2 % (tests/test_torch_slam.py's slice tolerances)."""
    import jax

    from opendlv_perception_vision_orbslam2_tpu.models import slam as jslam
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp as tpnp
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy

    def reference_sets(valid, generator=None, n_hypotheses=tpnp.N_HYPOTHESES):
        w = jnp.asarray(valid.numpy()).astype(jnp.float32)
        idx = jax.random.categorical(jax.random.PRNGKey(0), jnp.log(w + 1e-9),
                                     shape=(n_hypotheses, tpnp.SET_SIZE))
        return torch.from_numpy(np.asarray(idx)).to(torch.int64)

    jcfg, tcfg = _configs()
    grays, depths, _, _ = jsyn.render_rgbd_sequence(jcfg, n_frames=10, n_points=500, seed=5,
                                                    step=0.25)
    off = dict(enable_loop_closing=False, enable_relocalization=False)
    ref = jslam.StereoSlam(jcfg, **off)
    ref._pose_solver = None          # the single-device pose solve, which the port has
    out = tslam.StereoSlam(tcfg, device="cpu", **off)
    ref.force_sync_decisions = out.force_sync_decisions = True
    monkeypatch.setattr(tpnp, "sample_sets", reference_sets)
    for i in range(10):
        cur = jfront.process_rgbd(jnp.asarray(grays[i]), jnp.asarray(depths[i]), jcfg, i * 0.1)
        T_ref = np.asarray(ref._step(cur))
        T = out._step(from_jax_numpy(jax.tree.map(np.asarray, cur))).numpy()
        assert out.n_keyframes == ref.n_keyframes, f"frame {i}"
        assert np.linalg.norm(T[:3, 3] - T_ref[:3, 3]) < 5e-3, f"frame {i}"
        cos = np.clip((np.trace(T_ref[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)
        assert np.arccos(cos) < 1e-3, f"frame {i}"
        n_ref = int(np.asarray(ref.map.pt_valid).sum())
        assert abs(int(out.map.pt_valid.sum()) - n_ref) <= 0.02 * n_ref, f"frame {i}"
        assert not out.lost
    assert out.n_keyframes >= 2


@pytest.mark.slow
def test_kitti_rgbd_reference_run():
    """The reference package over phase 17's KITTI-size drive
    (``chip_smoke.RGBD_DRIVE``, ``RGBD_FRAMES`` frames) on the CPU with its
    defaults, held to phase 17's gates: never lost, finite poses, >= 5
    keyframes, ATE < ``RGBD_ATE_BOUND_M``.  Prints the keyframe count after
    phase 9's 24 frames beside the count at the end.  Several minutes."""
    import dataclasses

    import chip_smoke
    from opendlv_perception_vision_orbslam2_tpu.models import slam as jslam
    from opendlv_perception_vision_orbslam2_tpu.utils import trajectory as jtraj

    cfg = dataclasses.replace(jconfig.SystemConfig(), camera_type="rgbd")
    grays, depths, gt, _ = jsyn.render_rgbd_sequence(cfg, n_frames=chip_smoke.RGBD_FRAMES,
                                                     **chip_smoke.RGBD_DRIVE)
    slam = jslam.StereoSlam(cfg)
    kf_at, n_kf_24 = [], None
    for i in range(grays.shape[0]):
        n_kf = slam.n_keyframes
        T = slam.process_rgbd(jnp.asarray(grays[i]), jnp.asarray(depths[i]),
                              timestamp=i / cfg.camera.fps)
        assert T is not None and np.isfinite(np.asarray(T)).all(), f"frame {i}"
        assert not slam.lost, f"lost at frame {i}"
        if slam.n_keyframes != n_kf:
            kf_at.append(i)
        if i == 23:
            n_kf_24 = slam.n_keyframes
    slam.finish()
    ate = jtraj.ate_rmse([np.asarray(T) for T in slam.trajectory], list(np.asarray(gt)))
    print(f"kitti rgbd reference: keyframes {n_kf_24} after 24 frames, {slam.n_keyframes} "
          f"after {grays.shape[0]} (inserted at frames {kf_at}), map points "
          f"{int(np.asarray(slam.map.pt_valid).sum())}, ATE {ate:.4f} m")
    assert slam.n_keyframes >= 5
    assert ate < chip_smoke.RGBD_ATE_BOUND_M
