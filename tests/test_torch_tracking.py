"""Port tracking vs the reference package on identical numpy inputs.

Tolerances, and why:

- SE3 helpers are a few float32 ops in another order: within 1e-6 (pixels:
  relative 1e-6);
- Hamming distances, the rotation histogram and the matching ladder only
  count, compare and select: exact;
- EPnP RANSAC gets the reference's hypothesis sets injected (torch cannot
  draw jax.random's bits): the same winner and inlier set exactly, R within
  1e-4, t within 5e-4.  The winner's null vector comes from inverse
  iteration on M^T M + eps I of one 6-point set; float32 sums in another
  order move t by 1.8e-4 on seed 7 and 9.2e-5 on seed 8 (R by <= 7e-6),
  and each float32 implementation is ~2e-3 away from the float64 answer on
  seed 7, so t can agree no tighter than that order;
- pose-only Gauss-Newton sums in another order: within 1e-4;
- the VO slice starts from the reference tracker's state.  Its front end is
  fed the reference pyramid and descriptor blur, the two float32 matmuls
  whose rounding decides tied BRIEF bits on the flat synthetic background
  (see test_torch_frontend.py); everything else is the port's.  Per frame:
  translation within 5 mm, rotation within 1e-3 rad, inliers within 3 %.
  The port's own VO, end to end, is held to the reference's accuracy bound
  (tests/test_tracking.py: ATE < 0.10 m on the 12-frame fixture).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.models import tracking as jtrack
from opendlv_perception_vision_orbslam2_tpu.ops import hamming as jham
from opendlv_perception_vision_orbslam2_tpu.ops import image as jimage
from opendlv_perception_vision_orbslam2_tpu.ops import lie as jlie
from opendlv_perception_vision_orbslam2_tpu.ops import matching as jmatch
from opendlv_perception_vision_orbslam2_tpu.ops import orb as jorb
from opendlv_perception_vision_orbslam2_tpu.optim import pnp as jpnp
from opendlv_perception_vision_orbslam2_tpu.optim import pose_opt as jpose
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu.utils import trajectory as jtraj
from opendlv_perception_vision_orbslam2_tpu_torch.models import tracking as ttrack
from opendlv_perception_vision_orbslam2_tpu_torch.ops import hamming as tham
from opendlv_perception_vision_orbslam2_tpu_torch.ops import image as timage
from opendlv_perception_vision_orbslam2_tpu_torch.ops import lie as tlie
from opendlv_perception_vision_orbslam2_tpu_torch.ops import matching as tmatch
from opendlv_perception_vision_orbslam2_tpu_torch.ops import orb as torb
from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp as tpnp
from opendlv_perception_vision_orbslam2_tpu_torch.optim import pose_opt as tpose
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic as tsyn
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy, to_numpy

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0)
CAM_CFG = dict(CAM, width=512, height=256, fps=10.0)
ORB = dict(n_features=600, max_keypoints=1024, n_levels=4)
JCFG = jconfig.SystemConfig(camera=jconfig.CameraConfig(**CAM_CFG), orb=jconfig.OrbConfig(**ORB))
TCFG = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM_CFG), orb=tconfig.OrbConfig(**ORB))


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------- lie

def test_lie_matches_reference():
    rng = np.random.default_rng(0)
    xi = (rng.standard_normal((16, 6)) * [1, 1, 1, 0.5, 0.5, 0.5]).astype(np.float32)
    xi[0, 3:] = 0.0                      # the small-angle branch
    pts = rng.uniform(-5, 5, (16, 40, 3)).astype(np.float32)
    pts[..., 2] += 10.0
    T_j = jlie.exp_se3(jnp.asarray(xi))
    T_t = tlie.exp_se3(_t(xi))
    tol = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(T_t.numpy(), _np(T_j), **tol)
    np.testing.assert_allclose(tlie.hat(_t(xi[:, :3])).numpy(), _np(jlie.hat(jnp.asarray(xi[:, :3]))), **tol)
    np.testing.assert_allclose(tlie.exp_so3(_t(xi[:, 3:])).numpy(),
                               _np(jlie.exp_so3(jnp.asarray(xi[:, 3:]))), **tol)
    np.testing.assert_allclose(tlie.inv_T(T_t).numpy(), _np(jlie.inv_T(T_j)), **tol)
    np.testing.assert_allclose(
        tlie.make_T(T_t[:, :3, :3], T_t[:, :3, 3]).numpy(),
        _np(jlie.make_T(T_j[:, :3, :3], T_j[:, :3, 3])), **tol)
    pc_t = tlie.transform_points(T_t, _t(pts))
    pc_j = jlie.transform_points(T_j, jnp.asarray(pts))
    np.testing.assert_allclose(pc_t.numpy(), _np(pc_j), rtol=1e-6, atol=1e-5)
    pin = dict(fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"], cy=CAM["cy"])
    np.testing.assert_allclose(tlie.project(_t(pc_j), **pin).numpy(),
                               _np(jlie.project(pc_j, **pin)), rtol=1e-6, atol=0)
    uv, d = pts[0, :, :2] * 50 + 250, pts[0, :, 2]
    np.testing.assert_allclose(tlie.backproject(_t(uv), _t(d), **pin).numpy(),
                               _np(jlie.backproject(jnp.asarray(uv), jnp.asarray(d), **pin)),
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- hamming + rot

def test_hamming_matrix_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (96, 8), dtype=np.uint32)
    ref = _np(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    out = tham.hamming_matrix(_t(a.view(np.int32)), _t(b.view(np.int32))).numpy()
    np.testing.assert_array_equal(out, ref)


def test_rotation_consistency_mask_exact():
    rng = np.random.default_rng(1)
    a = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    b = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    matched = rng.integers(0, 200, 300).astype(np.int32)
    b[matched[:200]] = a[:200] - 0.4     # a dominant rotation
    valid = rng.uniform(size=300) < 0.8
    ref = _np(jham.rotation_consistency_mask(jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(matched), jnp.asarray(valid)))
    out = tham.rotation_consistency_mask(_t(a), _t(b), _t(matched).long(), _t(valid)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert 100 < ref.sum() < valid.sum()


# ------------------------------------------------------------- pose solvers

def _pose_problem(seed, n=200, noise_px=0.3, outlier_frac=0.0, mono=False):
    """The pose problems of tests/test_tracking.py, as numpy arrays."""
    rng = np.random.default_rng(seed)
    p_w = np.stack([rng.uniform(-10, 10, n), rng.uniform(-4, 4, n),
                    rng.uniform(4, 40, n)], axis=-1).astype(np.float32)
    xi = (rng.standard_normal(6) * np.array([0.3, 0.3, 0.3, 0.05, 0.05, 0.05])).astype(np.float32)
    T_true = _np(jlie.exp_se3(jnp.asarray(xi)))
    p_c = p_w @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([CAM["fx"] * p_c[:, 0] / p_c[:, 2] + CAM["cx"],
                   CAM["fy"] * p_c[:, 1] / p_c[:, 2] + CAM["cy"]], axis=-1)
    ur = uv[:, 0] - CAM["bf"] / p_c[:, 2]
    uv += rng.standard_normal(uv.shape) * noise_px
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv[idx] += rng.uniform(-40, 40, (n_out, 2))
    if mono:
        ur = -np.ones_like(ur)
    obs = dict(p_w=p_w, uv=uv.astype(np.float32), u_right=ur.astype(np.float32),
               sigma2=np.ones(n, np.float32), valid=np.ones(n, bool))
    return T_true, obs


@pytest.mark.parametrize(
    "seed,outliers,mono,delta",
    [
        (0, 0.0, False, [0.2, -0.1, 0.15, 0.02, -0.03, 0.01]),
        (1, 0.0, False, [0.2, -0.1, 0.15, 0.02, -0.03, 0.01]),
        (2, 0.0, False, [0.2, -0.1, 0.15, 0.02, -0.03, 0.01]),
        (7, 0.3, False, [0.1, 0.1, -0.1, 0.01, 0.01, -0.01]),
        (3, 0.0, True, [0.1, 0.0, 0.1, 0.0, 0.02, 0.0]),
    ],
)
def test_pose_optimize_matches_reference(seed, outliers, mono, delta):
    T_true, obs = _pose_problem(seed, outlier_frac=outliers, mono=mono)
    T0 = _np(jlie.exp_se3(jnp.asarray(np.float32(delta))) @ jnp.asarray(T_true))
    T_j, inl_j, n_j = jpose.pose_optimize(
        jnp.asarray(T0), jpose.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}), **CAM)
    T_t, inl_t, n_t = tpose.pose_optimize(
        _t(T0), tpose.PoseObs(**{k: _t(v) for k, v in obs.items()}), **CAM)
    np.testing.assert_allclose(T_t.numpy(), _np(T_j), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), _np(inl_j))
    assert int(n_t) == int(n_j)


def _reference_sets(valid):
    """The hypothesis sets the reference draws with PRNGKey(0)."""
    w = jnp.asarray(valid).astype(jnp.float32)
    return _np(jax.random.categorical(jax.random.PRNGKey(0), jnp.log(w + 1e-9),
                                      shape=(jpnp.N_HYPOTHESES, jpnp.SET_SIZE)))


@pytest.mark.parametrize("seed", [7, 8])
def test_pnp_ransac_matches_reference_given_its_sets(seed):
    _, obs = _pose_problem(seed, outlier_frac=0.3)
    obs["valid"][::7] = False
    ref = jpnp.pnp_ransac(jnp.asarray(obs["p_w"]), jnp.asarray(obs["uv"]),
                          jnp.asarray(obs["sigma2"]), jnp.asarray(obs["valid"]),
                          jax.random.PRNGKey(0), fx=CAM["fx"], fy=CAM["fy"],
                          cx=CAM["cx"], cy=CAM["cy"])
    out = tpnp.pnp_ransac(_t(obs["p_w"]), _t(obs["uv"]), _t(obs["sigma2"]), _t(obs["valid"]),
                          fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"], cy=CAM["cy"],
                          idx=_t(_reference_sets(obs["valid"])))
    assert int(out.n_inliers) == int(ref.n_inliers) > 100
    np.testing.assert_array_equal(out.inliers.numpy(), _np(ref.inliers))
    np.testing.assert_allclose(out.R.numpy(), _np(ref.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), _np(ref.t), rtol=0, atol=5e-4)


def test_robust_pose_estimate_matches_reference_given_its_sets():
    T_true, obs = _pose_problem(9, outlier_frac=0.3)
    T0 = _np(jlie.exp_se3(jnp.asarray(np.float32([0.5, -0.3, 0.4, 0.05, 0.02, -0.04])))
             @ jnp.asarray(T_true))
    T_j, inl_j, n_j = jpose.robust_pose_estimate(
        jnp.asarray(T0), jpose.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
        jax.random.PRNGKey(0), **CAM)
    T_t, inl_t, n_t = tpose.robust_pose_estimate(
        _t(T0), tpose.PoseObs(**{k: _t(v) for k, v in obs.items()}), **CAM,
        pnp_idx=_t(_reference_sets(obs["valid"])))
    np.testing.assert_allclose(T_t.numpy(), _np(T_j), rtol=0, atol=1e-4)
    assert int(n_t) == int(n_j)


def test_cpu_pose_solves_run_eagerly_and_never_capture():
    """CPU tensors take the eager chain set: each solve counts
    ``pose.solve_eager``, none captures or replays a CUDA graph."""
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import trace

    T_true, obs = _pose_problem(4, outlier_frac=0.2)
    obs_t = tpose.PoseObs(**{k: _t(v) for k, v in obs.items()})
    T0 = _t(T_true)
    t0 = time.perf_counter_ns()
    tpose.pose_optimize(T0, obs_t, **CAM)
    tpose.robust_pose_estimate(T0, obs_t, torch.Generator().manual_seed(0), **CAM)
    tpose.pose_optimize(T0, obs_t._replace(valid=obs_t.valid & (obs_t.sigma2 > 0)), **CAM)
    counts = {}
    for r in trace.records(since_ns=t0):
        if isinstance(r, trace.Count):
            counts[r.name] = counts.get(r.name, 0) + r.n
    assert counts == {"pose.solve_eager": 3}
    assert not tpose._GRAPHS


# ------------------------------------------------------------- the VO slice

@pytest.fixture(scope="module")
def sequence():
    """The 12-frame fixture of tests/test_tracking.py, rendered in numpy."""
    return tsyn.render_stereo_sequence(TCFG, n_frames=12, n_points=500, seed=5, step=0.25)


@pytest.fixture(scope="module")
def reference_run(sequence):
    """The reference VO over the first 5 frames: states and poses."""
    lefts, rights, _, _ = sequence
    vo = jtrack.StereoVisualOdometry(JCFG)
    states, poses = [], []
    for i in range(5):
        T = vo.process(lefts[i], rights[i], timestamp=i * 0.1)
        states.append(_tree_np(vo.state))
        poses.append(_np(T))
    return states, poses


def test_motion_ladder_match_exact_given_reference_frames(sequence, reference_run):
    states, _ = reference_run
    lefts, rights, _, _ = sequence
    cur = jfront.process_stereo(jnp.asarray(lefts[1]), jnp.asarray(rights[1]), JCFG)
    state = jtrack.init_state(jax.tree.map(jnp.asarray, states[0].last_frame))
    cam = JCFG.camera
    th_far = JCFG.tracking.th_depth * cam.baseline_m
    _, p_w, usable, desc, octv, ang, d_s = jtrack._compact_sources(state, th_far)
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf, width=cam.width,
              height=cam.height, scale_factor=1.2, baseline=cam.baseline_m, th_far=th_far,
              min_matches=jtrack.MIN_MATCHES_MOTION)
    T_pred = jnp.asarray(states[1].T_cw)
    m_j, n_j = jmatch.motion_ladder_match(p_w, usable, desc, octv, ang, d_s, cur.features,
                                          T_pred, z_motion=jnp.float32(0.05), **kw)
    t_state = from_jax_numpy(_tree_np(state))
    _, tp_w, tusable, tdesc, toct, tang, td = ttrack._compact_sources(t_state, th_far)
    np.testing.assert_array_equal(tdesc.numpy(), _np(desc).view(np.int32))
    m_t, n_t = tmatch.motion_ladder_match(
        _t(p_w), tusable, tdesc, toct, tang, td, from_jax_numpy(_tree_np(cur.features)),
        _t(T_pred), z_motion=torch.tensor(0.05), **kw)
    valid = _np(m_j.valid)
    assert int(n_t) == int(n_j) > 20
    np.testing.assert_array_equal(m_t.valid.numpy(), valid)
    np.testing.assert_array_equal(m_t.dst_idx.numpy()[valid], _np(m_j.dst_idx)[valid])
    np.testing.assert_array_equal(m_t.dist.numpy()[valid], _np(m_j.dist)[valid])


def test_vo_slice_matches_reference_per_frame(sequence, reference_run, monkeypatch):
    lefts, rights, _, _ = sequence
    states, poses = reference_run

    def reference_pyramid(img, n_levels, scale_factor):
        levels = jax.vmap(lambda im: jimage.build_pyramid(im, n_levels, scale_factor))(
            jnp.asarray(img.numpy()))
        return [_t(lv) for lv in levels]

    def reference_blur(patches):
        bm = jnp.asarray(jorb._patch_blur_matrix())
        return _t(jnp.einsum("is,nst,jt->nij", bm, jnp.asarray(patches.numpy()), bm))

    monkeypatch.setattr(timage, "build_pyramid", reference_pyramid)
    monkeypatch.setattr(torb, "blur_patches", reference_blur)

    vo = ttrack.StereoVisualOdometry(TCFG, device="cpu")
    vo.state = from_jax_numpy(states[0])
    for i in range(1, 5):
        T = vo.process(lefts[i], rights[i], timestamp=i * 0.1).numpy()
        T_ref = poses[i]
        assert np.linalg.norm(T[:3, 3] - T_ref[:3, 3]) < 5e-3, f"frame {i}"
        cos = np.clip((np.trace(T_ref[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)
        assert np.arccos(cos) < 1e-3, f"frame {i}"
        n_ref = int(states[i].n_inliers)
        assert abs(int(vo.state.n_inliers) - n_ref) <= 0.03 * n_ref, f"frame {i}"


def test_vo_draw_depends_on_the_frame_alone(sequence, monkeypatch):
    """The same state and frame, fed twice, draw the same RANSAC sets and
    give the same pose: each frame re-seeds the generator with the constant
    ``seed``, as the reference draws each frame with a fresh PRNGKey(0)."""
    lefts, rights, _, _ = sequence
    drawn = []
    real = tpnp.sample_sets

    def record(valid, generator, n_hypotheses=tpnp.N_HYPOTHESES):
        idx = real(valid, generator, n_hypotheses)
        drawn.append((valid.clone(), idx.clone()))
        return idx

    monkeypatch.setattr(tpnp, "sample_sets", record)
    vo = ttrack.StereoVisualOdometry(TCFG, device="cpu")
    for i in range(3):
        vo.process(lefts[i], rights[i], timestamp=i * 0.1)
    state = vo.state
    T_a = vo.process(lefts[3], rights[3], timestamp=0.3)
    vo.state = state
    T_b = vo.process(lefts[3], rights[3], timestamp=0.3)
    (valid_a, sets_a), (valid_b, sets_b) = drawn[-2:]
    assert torch.equal(valid_a, valid_b)
    assert torch.equal(sets_a, sets_b)
    assert torch.equal(T_a, T_b)
    fresh = real(valid_a, torch.Generator().manual_seed(vo.seed))
    assert torch.equal(sets_a, fresh)


def test_port_vo_accuracy_bound(sequence):
    """The port end to end (own pyramid and blur) on the 12-frame fixture."""
    lefts, rights, gt, _ = sequence
    vo = ttrack.StereoVisualOdometry(TCFG, device="cpu")
    for i in range(len(lefts)):
        assert vo.process(lefts[i], rights[i], timestamp=i * 0.1) is not None
        assert not vo.lost, f"lost tracking at frame {i}"
    ate = jtraj.ate_rmse([T.numpy() for T in vo.trajectory], list(gt), align=False)
    assert ate < 0.10, f"ATE {ate:.3f} m"


def test_state_round_trip(reference_run):
    states, _ = reference_run
    ref = states[1]
    back = to_numpy(from_jax_numpy(ref))
    assert back.last_frame.features.desc.dtype == np.uint32
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(tuple(back))):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
