"""The port's monocular slice vs the reference package.

Fixtures: ``tests/test_mono.py``'s (512x256 camera, 600 features doubled to
1024 until the map exists, 4 levels; its lateral drive over a close world,
seed 9, and its two-keyframe triangulation scene).  Tolerances, and why:

- ``process_mono`` given the reference's pyramid: keypoints, octaves and
  validity exactly, angles within 1e-5 rad (as the stereo front end);
  ``point_cam`` zeros;
- triangulation between two mono keyframes: the same points created but
  for at most 2 % (a candidate on a gate's edge), positions within 1e-3
  relative (the DLT of the port and of the reference round differently,
  up to ~7e-4 relative at small parallax); ``tests/test_mono.py``'s bars:
  > 100 points, median error < 0.05 of depth, > 100 bound in both;
- the bootstrap from the reference's RANSAC sets (``PRNGKey(21)`` split per
  attempt, injected as ``_InitChain``): the same init frame and the same
  initializer verdicts; the map's point count within 1 %; the second
  keyframe's translation direction within 1e-3 (cosine) and its length
  within 5 %: the bootstrap BA leaves the scale free, and two solvers stop
  at different scales of the same solution;
- the initializer attempts the card made on phase 18's KITTI-size drive
  (``test_torch_mono_kitti_attempts.npz``): both packages refuse every
  draw up to frame 6 and accept some at frame 7;
- slow: ``tests/test_mono.py``'s bootstrap bars on the port with its own
  draws (initialized by frame 4, >= 2 keyframes, > 50 points, direction
  cosine > 0.966, not lost within 4 frames), and the reference package's
  run over ``chip_smoke.py``'s KITTI-size lateral drive, held to phase 18's
  gates (its init frame sets ``MONO_INIT_BY``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.models import initializer as jinit
from opendlv_perception_vision_orbslam2_tpu.models import map_state as jms
from opendlv_perception_vision_orbslam2_tpu.models import mono_slam as jmono
from opendlv_perception_vision_orbslam2_tpu.models.frame import FrameState as JFrame
from opendlv_perception_vision_orbslam2_tpu.models.frame import empty_features
from opendlv_perception_vision_orbslam2_tpu.models.triangulation import (
    triangulate_with_neighbor as jtriangulate,
)
from opendlv_perception_vision_orbslam2_tpu.ops import image as jimage
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu.utils import synthetic as jsyn
from opendlv_perception_vision_orbslam2_tpu_torch.models import frontend as tfront
from opendlv_perception_vision_orbslam2_tpu_torch.models import initializer as tinit
from opendlv_perception_vision_orbslam2_tpu_torch.models import mono_slam as tmono
from opendlv_perception_vision_orbslam2_tpu_torch.models.triangulation import (
    triangulate_with_neighbor as ttriangulate,
)
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256)
ORB = dict(n_features=600, max_keypoints=1024, n_levels=4)
# tests/test_mono.py's lateral drive: sideways-dominant motion over a close
# world gives the parallax a two-view initialization needs
DRIVE = dict(n_frames=10, n_points=600, seed=9, step=0.05, step_x=0.15, z_range=(3.0, 15.0))


def _configs(**kw):
    kw = dict(max_keyframes=32, max_map_points=16384, **kw)
    return (jconfig.SystemConfig(camera=jconfig.CameraConfig(**CAM), orb=jconfig.OrbConfig(**ORB),
                                 tracking=jconfig.TrackingConfig(max_frames=4), **kw),
            tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM), orb=tconfig.OrbConfig(**ORB),
                                 tracking=tconfig.TrackingConfig(max_frames=4), **kw))


@pytest.fixture(scope="module")
def drive():
    """The reference's renders of the lateral drive (numpy) and its poses."""
    jcfg, _ = _configs()
    lefts, _, gt, _ = jsyn.render_stereo_sequence(jcfg, **DRIVE)
    return np.array(lefts), np.array(gt)


class _InitChain:
    """The reference ``MonocularSlam``'s keys: ``PRNGKey(21)`` split before
    every initialization attempt; :meth:`sample_sets` draws that attempt's
    200 sets of 8 from the subkey."""

    def __init__(self):
        self.key = jax.random.PRNGKey(21)

    def sample_sets(self, valid, generator=None):
        self.key, sub = jax.random.split(self.key)
        w = jnp.asarray(valid.cpu().numpy()).astype(jnp.float32)
        idx = jax.random.categorical(sub, jnp.log(w + 1e-9),
                                     shape=(tinit.N_RANSAC, tinit.SET_SIZE))
        return torch.from_numpy(np.array(idx)).to(torch.int64)


def test_process_mono_exact_given_reference_pyramid(drive, monkeypatch):
    lefts, _ = drive
    jcfg, tcfg = _configs()
    ref = jfront.process_mono(jnp.asarray(lefts[0]), jcfg, 0.0)
    levels = jimage.build_pyramid(jnp.asarray(lefts[0]), ORB["n_levels"], 1.2)
    monkeypatch.setattr(tfront.image_ops, "build_pyramid",
                        lambda img, n, s: [torch.from_numpy(np.array(lv)) for lv in levels])
    out = tfront.process_mono(torch.from_numpy(lefts[0]), tcfg, 0.0)
    for name in ("xy", "response", "octave", "valid", "depth", "u_right"):
        np.testing.assert_array_equal(getattr(out.features, name).numpy(),
                                      np.array(getattr(ref.features, name)), err_msg=name)
    valid = np.array(ref.features.valid)
    assert valid.sum() > 300
    np.testing.assert_allclose(out.features.angle.numpy()[valid],
                               np.array(ref.features.angle)[valid], rtol=0, atol=1e-5)
    assert not out.point_cam.any()


def _mono_frame(T_cw, pts, descs, F, noise, seed):
    """tests/test_mono.py's synthetic keyframe: ``pts`` projected with pixel
    noise, one descriptor per point."""
    rng = np.random.default_rng(seed)
    p_c = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
    n = len(pts)
    u = CAM["fx"] * p_c[:, 0] / p_c[:, 2] + CAM["cx"] + rng.normal(0, noise, n)
    v = CAM["fy"] * p_c[:, 1] / p_c[:, 2] + CAM["cy"] + rng.normal(0, noise, n)
    feats = empty_features(F)._replace(
        xy=jnp.zeros((F, 2)).at[:n].set(jnp.asarray(np.stack([u, v], -1).astype(np.float32))),
        desc=jnp.zeros((F, 8), jnp.uint32).at[:n].set(jnp.asarray(descs)),
        valid=jnp.zeros((F,), bool).at[:n].set(True))
    return JFrame(features=feats, T_cw=jnp.asarray(T_cw), point_cam=jnp.zeros((F, 3)),
                  timestamp=jnp.asarray(0.0))


def test_triangulation_creates_points_between_keyframes():
    """tests/test_mono.py's two-keyframe triangulation: its bars on the port,
    and the port against the reference from the same map."""
    F = 256
    rng = np.random.default_rng(0)
    n = 150
    pts = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), rng.uniform(6, 30, n)],
                   axis=-1).astype(np.float32)
    descs = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    jcfg = jconfig.SystemConfig(camera=jconfig.CameraConfig(**CAM),
                                orb=jconfig.OrbConfig(max_keypoints=F))
    tcfg = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM),
                                orb=tconfig.OrbConfig(max_keypoints=F))
    T1 = np.eye(4, dtype=np.float32)
    T1[0, 3] = -0.8                                  # sideways baseline
    m = jms.empty_map(8, 4096, F)
    for T, seed in ((np.eye(4, dtype=np.float32), 1), (T1, 2)):
        m, _ = jms.insert_keyframe(m, _mono_frame(T, pts, descs, F, 0.2, seed),
                                   -jnp.ones((F,), jnp.int32), -1.0)
    ref = jtriangulate(m, 1, 0, jcfg)
    out = ttriangulate(from_jax_numpy(jax.tree.map(np.asarray, m)), 1, 0, tcfg)

    n_created = int(out.pt_valid.sum())
    assert n_created > 100
    binds = out.kf_obs_point[1][:n].numpy()
    got = binds >= 0
    est = out.pt_pos.numpy()[binds[got]]
    assert np.median(np.linalg.norm(est - pts[got], axis=1) / pts[got][:, 2]) < 0.05
    assert (out.kf_obs_point[0][:n].numpy() >= 0).sum() > 100

    ref_binds = np.array(ref.kf_obs_point[1][:n])
    both = got & (ref_binds >= 0)
    assert abs(n_created - int(jnp.sum(ref.pt_valid))) <= 0.02 * n_created
    assert both.sum() >= 0.98 * got.sum()
    np.testing.assert_allclose(out.pt_pos.numpy()[binds[both]],
                               np.array(ref.pt_pos)[ref_binds[both]], rtol=1e-3, atol=1e-4)


def _bootstrap(slam, lefts, n_frames, frontend_input):
    """Feed frames until the map exists; returns ``(init frame, pose)``."""
    for i in range(n_frames):
        T = slam.process(frontend_input(lefts[i]), timestamp=i * 0.1)
        if slam.initialized:
            return i, np.array(T)
    return None, None


def test_bootstrap_matches_reference(drive, monkeypatch):
    """The bootstrap of both packages from the reference's RANSAC sets, with
    tests/test_mono.py's scaled thresholds (60 matches, 40 points)."""
    lefts, _ = drive
    jcfg, tcfg = _configs()
    verdicts = {"ref": [], "port": []}

    def record(inner, tag):
        def wrapped(*args, **kwargs):
            res = inner(*args, **kwargs)
            verdicts[tag].append((bool(res.success), bool(res.used_homography),
                                  int(np.sum(np.asarray(res.point_ok)))))
            return res
        return wrapped

    monkeypatch.setattr(jmono, "initialize_two_view", record(jmono.initialize_two_view, "ref"))
    monkeypatch.setattr(tmono, "initialize_two_view",
                        record(lambda *a, **k: tinit.initialize_two_view(*a, **k), "port"))
    monkeypatch.setattr(tinit, "sample_sets", _InitChain().sample_sets)
    ref = jmono.MonocularSlam(jcfg, enable_loop_closing=False, enable_relocalization=False)
    out = tmono.MonocularSlam(tcfg, enable_loop_closing=False, enable_relocalization=False,
                              device="cpu")
    for s in (ref, out):
        s.min_init_matches, s.min_triangulated = 60, 40
    i_ref, T_ref = _bootstrap(ref, lefts, 5, jnp.asarray)
    i_out, T_out = _bootstrap(out, lefts, 5, lambda x: x)
    assert i_ref is not None and i_out == i_ref
    assert verdicts["port"] == verdicts["ref"]
    n_ref, n_out = int(jnp.sum(ref.map.pt_valid)), int(out.map.pt_valid.sum())
    assert abs(n_out - n_ref) <= 0.01 * n_ref
    t_ref, t_out = T_ref[:3, 3], T_out[:3, 3]
    assert float(t_out @ t_ref) / (np.linalg.norm(t_out) * np.linalg.norm(t_ref)) > 1 - 1e-3
    assert abs(np.linalg.norm(t_out) / np.linalg.norm(t_ref) - 1.0) < 0.05
    assert out.n_keyframes == ref.n_keyframes == 2


@pytest.mark.slow
def test_mono_slam_bootstrap_and_tracking(drive):
    """tests/test_mono.py's bootstrap bars on the port with its own draws."""
    lefts, gt = drive
    _, tcfg = _configs()
    slam = tmono.MonocularSlam(tcfg, enable_loop_closing=False, enable_relocalization=False,
                               device="cpu")
    slam.min_init_matches, slam.min_triangulated = 60, 40
    init_at = lost_at = init_T = None
    for i in range(DRIVE["n_frames"]):
        T = slam.process(lefts[i], timestamp=i * 0.1)
        if slam.initialized and init_at is None:
            init_at, init_T = i, T.numpy()
        if slam.initialized and slam.lost and lost_at is None:
            lost_at = i
    assert slam.initialized and slam.n_keyframes >= 2
    assert int(slam.map.pt_valid.sum()) > 50
    T_gt = gt[init_at] @ np.linalg.inv(gt[0])
    t_est = init_T[:3, 3] / np.linalg.norm(init_T[:3, 3])
    t_gt = T_gt[:3, 3] / np.linalg.norm(T_gt[:3, 3])
    assert float(t_est @ t_gt) > 0.966
    assert init_at <= 4
    assert lost_at is None or lost_at - init_at >= 4


@pytest.mark.slow
def test_kitti_mono_reference_run():
    """The reference package over phase 18's KITTI-size lateral drive
    (``chip_smoke.MONO_DRIVE``) on the CPU with its defaults, held to phase
    18's gates: initialized by ``MONO_INIT_BY``, >= 2 keyframes, more than
    ``MONO_MIN_POINTS`` points, direction cosine > ``MONO_MIN_COS``, not
    lost within ``MONO_LOST_AFTER`` frames of initialization, every pose
    finite.  Prints the init frame that ``MONO_INIT_BY`` is set from.  A few
    minutes."""
    import chip_smoke

    cfg = jconfig.SystemConfig()
    lefts, _, gt, _ = jsyn.render_stereo_sequence(cfg, **chip_smoke.MONO_DRIVE)
    slam = jmono.MonocularSlam(cfg)
    init_at, init_T, lost, ref_idx, ref_at = None, None, [], None, None
    for i in range(lefts.shape[0]):
        ref_before = slam._init_ref
        T = slam.process(lefts[i], timestamp=i / cfg.camera.fps)
        if not slam.initialized:
            if slam._init_ref is not None and slam._init_ref is not ref_before:
                ref_idx = i            # this frame became the init frame
            continue
        if init_at is None:
            init_at, init_T, ref_at = i, np.asarray(T), ref_idx
        assert T is not None and np.isfinite(np.asarray(T)).all(), f"frame {i}"
        if slam.lost:
            lost.append(i)
    assert init_at is not None, "the reference did not initialize"
    gt = np.asarray(gt)
    T_gt = gt[init_at] @ np.linalg.inv(gt[ref_at])
    cos = float(init_T[:3, 3] @ T_gt[:3, 3]
                / (np.linalg.norm(init_T[:3, 3]) * np.linalg.norm(T_gt[:3, 3])))
    n_pts = int(jnp.sum(slam.map.pt_valid))
    print(f"kitti mono reference: initialized at frame {init_at} (init frame {ref_at}), points "
          f"{n_pts}, keyframes "
          f"{slam.n_keyframes}, direction cosine {cos:.5f}, lost frames {lost}")
    assert init_at <= chip_smoke.MONO_INIT_BY
    assert slam.n_keyframes >= 2 and n_pts > chip_smoke.MONO_MIN_POINTS
    assert cos > chip_smoke.MONO_MIN_COS
    assert not lost or lost[0] - init_at >= chip_smoke.MONO_LOST_AFTER


def test_kitti_initializer_attempts_match_reference():
    """The initializer attempts of ``MonocularSlam(cfg)`` on phase 18's
    KITTI-size drive, as the card made them (the matched keypoints of frames
    1-3 and 5-7 against their init frame, saved from a card run of
    ``chip_smoke.py``'s ``MONO_DRIVE``), decided by both packages from the
    reference's ``PRNGKey(21)`` draws: every draw refused up to frame 6 (3
    draws each), several of 8 accepted at frame 7 by each.  At frame 7 a
    single draw's verdict hangs on rounding (about 65 points against
    minTriangulated = 50 and the 0.9 N gate), so there the counts are
    compared, not the draws."""
    data = np.load(Path(__file__).with_name("test_torch_mono_kitti_attempts.npz"))
    cam = tconfig.SystemConfig().camera
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
    for k in range(6):
        xy1, xy2, valid = (data[f"{n}_{k}"] for n in ("xy1", "xy2", "valid"))
        frame = int(data[f"frame_{k}"])
        chain, n_ref, n_out = _InitChain(), 0, 0
        for _ in range(8 if frame == 7 else 3):
            key = chain.key
            sets = chain.sample_sets(torch.from_numpy(valid))
            ref = jinit.initialize_two_view(jnp.asarray(xy1), jnp.asarray(xy2),
                                            jnp.asarray(valid), jax.random.split(key)[1], **kw)
            out = tinit.initialize_two_view(torch.from_numpy(xy1), torch.from_numpy(xy2),
                                            torch.from_numpy(valid), **kw, sets=sets)
            n_ref += bool(ref.success)
            n_out += bool(out.success)
        if frame == 7:
            assert n_ref >= 2 and n_out >= 2, (n_ref, n_out)
        else:
            assert n_ref == n_out == 0, (frame, n_ref, n_out)
