"""The port's monocular two-view initializer vs the reference package.

``tests/test_initializer.py``'s scenes (300 points, 320 px focal length,
0.2-0.3 px noise): a general scene (F), an exact plane (H, ambiguous, must
be refused), a plane with relief (must initialize), pure rotation (must be
refused), and the Faugeras decomposition of exact plane homographies.

The RANSAC sets are the reference's (``jax.random.categorical`` from
``PRNGKey(1)``, as its tests draw), handed to the port through
``initialize_two_view(..., sets=...)``: torch cannot draw jax.random's bits.
The SVDs' signs and the order of degenerate singular vectors differ between
LAPACK builds, so what is compared is what the initializer decides:

- the H/F choice and the verdict: identical;
- ``point_ok``: identical where the motion is determined (general scene,
  exact plane, plane with relief); under pure rotation no motion is, and
  the few points that pass are decided by rounding;
- ``T_21``: within 1e-4 (5e-4 for the plane with relief, whose H is
  refined over 300 inliers by an SVD summed in another order).

``search_for_initialization`` on two reference front-end frames: identical
matches (integer distances, first-minimum ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.models import initializer as jinit
from opendlv_perception_vision_orbslam2_tpu.ops import lie as jlie
from opendlv_perception_vision_orbslam2_tpu.ops import matching as jmatch
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu.utils import synthetic as jsyn
from opendlv_perception_vision_orbslam2_tpu_torch.models import initializer as tinit
from opendlv_perception_vision_orbslam2_tpu_torch.ops import matching as tmatch
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0)


def _project(pts, T):
    p = pts @ np.asarray(T)[:3, :3].T + np.asarray(T)[:3, 3]
    u = CAM["fx"] * p[:, 0] / p[:, 2] + CAM["cx"]
    v = CAM["fy"] * p[:, 1] / p[:, 2] + CAM["cy"]
    return np.stack([u, v], -1).astype(np.float32), p[:, 2]


def _scene(kind):
    """``(pts, xi)`` of tests/test_initializer.py's scenes."""
    if kind == "general" or kind == "rotation":
        rng = np.random.default_rng(3 if kind == "general" else 5)
        pts = np.stack([rng.uniform(-6, 6, 300), rng.uniform(-3, 3, 300),
                        rng.uniform(5, 25, 300)], axis=-1)
        xi = [0.6, 0.05, 0.2, 0.0, 0.03, 0.0] if kind == "general" else [0, 0, 0, 0, 0.06, 0]
    elif kind == "plane":
        rng = np.random.default_rng(4)
        x, y = rng.uniform(-6, 6, 300), rng.uniform(-3, 3, 300)
        pts = np.stack([x, y, 10.0 + 0.2 * x], -1)
        xi = [0.5, 0.1, 0.1, 0.0, 0.04, 0.01]
    else:   # a plane with relief
        rng = np.random.default_rng(4)
        x, y = rng.uniform(-4, 4, 300), rng.uniform(-2.5, 2.5, 300)
        pts = np.stack([x, y, 6.0 + 0.2 * x + rng.uniform(-0.6, 0.6, 300)], -1)
        xi = [0.8, 0.1, 0.1, 0.0, 0.04, 0.01]
    return pts.astype(np.float32), np.array(xi, np.float32)


NOISE = {"general": 0.3, "plane": 0.2, "relief": 0.2, "rotation": 0.3}


def _matches(kind, seed=0):
    """tests/test_initializer.py's ``_run_init`` inputs: ``(uv1, uv2, valid,
    T21)`` numpy."""
    pts, xi = _scene(kind)
    T21 = np.asarray(jlie.exp_se3(jnp.asarray(xi)))
    rng = np.random.default_rng(seed)
    uv1, z1 = _project(pts, np.eye(4))
    uv2, z2 = _project(pts, T21)
    valid = (z1 > 0.5) & (z2 > 0.5)
    uv1 = (uv1 + rng.standard_normal(uv1.shape) * NOISE[kind]).astype(np.float32)
    uv2 = (uv2 + rng.standard_normal(uv2.shape) * NOISE[kind]).astype(np.float32)
    return uv1, uv2, valid, T21


def _reference_sets(valid, key=jax.random.PRNGKey(1)):
    w = jnp.asarray(valid).astype(jnp.float32)
    return np.array(jax.random.categorical(key, jnp.log(w + 1e-9),
                                           shape=(tinit.N_RANSAC, tinit.SET_SIZE)))


def _both(kind):
    uv1, uv2, valid, T21 = _matches(kind)
    ref = jinit.initialize_two_view(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
                                    jax.random.PRNGKey(1), **CAM)
    out = tinit.initialize_two_view(torch.from_numpy(uv1), torch.from_numpy(uv2),
                                    torch.from_numpy(valid), **CAM,
                                    sets=torch.from_numpy(_reference_sets(valid)))
    return ref, out, T21


def _rel_err(T_est, T_gt):
    t_e = np.asarray(T_est)[:3, 3] / (np.linalg.norm(np.asarray(T_est)[:3, 3]) + 1e-12)
    t_g = T_gt[:3, 3] / (np.linalg.norm(T_gt[:3, 3]) + 1e-12)
    dR = np.asarray(T_est)[:3, :3].T @ T_gt[:3, :3]
    return (np.arccos(np.clip(np.abs(t_e @ t_g), -1, 1)),
            np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("kind,tol", [("general", 1e-4), ("plane", 1e-4), ("relief", 5e-4),
                                      ("rotation", None)])
def test_initialize_two_view_matches_reference(kind, tol):
    ref, out, _ = _both(kind)
    assert bool(out.success) == bool(ref.success)
    assert bool(out.used_homography) == bool(ref.used_homography)
    if tol is None:
        assert not bool(out.success)
        return
    np.testing.assert_array_equal(out.point_ok.numpy(), np.array(ref.point_ok))
    np.testing.assert_allclose(out.T_21.numpy(), np.array(ref.T_21), rtol=0, atol=tol)
    ok = np.array(ref.point_ok)
    np.testing.assert_allclose(out.points.numpy()[ok], np.array(ref.points)[ok], rtol=1e-3,
                               atol=1e-3)


def test_reference_bars_on_port():
    """tests/test_initializer.py's four scene bars, run on the port with
    sets from its own generator (seeded 1)."""
    def run(kind):
        uv1, uv2, valid, T21 = _matches(kind)
        res = tinit.initialize_two_view(
            torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(valid),
            torch.Generator().manual_seed(1), **CAM)
        return res, T21

    res, T21 = run("general")
    assert bool(res.success) and not bool(res.used_homography)
    dir_err, ang = _rel_err(res.T_21.numpy(), T21)
    assert dir_err < 0.05 and ang < 0.02
    assert int(res.point_ok.sum()) > 150
    assert (res.points.numpy()[res.point_ok.numpy()][:, 2] > 0).mean() > 0.99
    res, _ = run("plane")
    assert bool(res.used_homography) and not bool(res.success)
    res, T21 = run("relief")
    assert bool(res.success)
    dir_err, ang = _rel_err(res.T_21.numpy(), T21)
    assert dir_err < 0.08 and ang < 0.03
    res, _ = run("rotation")
    assert not bool(res.success)


def test_faugeras_decomposition_contains_true_motion():
    """The 8 Faugeras solutions hold the true (R, t/|t|) of an exact plane
    homography (tests/test_initializer.py's bar), and agree with the
    reference's set solution by solution up to the SVD's sign choices."""
    K = np.array([[320.0, 0, 256.0], [0, 320.0, 128.0], [0, 0, 1.0]], np.float32)
    rng = np.random.default_rng(11)
    for trial in range(5):
        xi = np.concatenate([rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.1, 0.1, 3)]).astype(np.float32)
        T = np.asarray(jlie.exp_se3(jnp.asarray(xi)))
        n = np.array([0.2, -0.1, -1.0], np.float32)
        n /= np.linalg.norm(n)
        H = (K @ (T[:3, :3] + np.outer(T[:3, 3], n) / 8.0) @ np.linalg.inv(K)).astype(np.float32)
        R8, t8 = tinit.decompose_homography(torch.from_numpy(H), torch.from_numpy(K))
        R8, t8 = R8.numpy(), t8.numpy()
        t_dir = T[:3, 3] / np.linalg.norm(T[:3, 3])
        assert min(np.linalg.norm(R - T[:3, :3]) for R in R8) < 1e-3, trial
        assert max(float(t @ t_dir) for t in t8) > 0.999, trial
        jR8, jt8 = (np.array(a) for a in jinit.decompose_homography(jnp.asarray(H), jnp.asarray(K)))
        for R, t in zip(jR8, jt8):
            assert min(np.abs(R - R2).max() + np.abs(t - t2).max()
                       for R2, t2 in zip(R8, t8)) < 1e-3, trial


def test_search_for_initialization_matches_reference():
    """Two monocular reference frames 0.3 m apart sideways (the reference's
    front end, 512x256, 1200 features as the doubled init budget): the same
    match for every feature."""
    cfg = jconfig.SystemConfig(camera=jconfig.CameraConfig(width=512, height=256, fx=320.0,
                                                           fy=320.0, cx=256.0, cy=128.0,
                                                           bf=160.0),
                               orb=jconfig.OrbConfig(n_features=1200, max_keypoints=1200,
                                                     n_levels=4))
    world = jsyn.make_world(600, seed=9, z_range=(3.0, 15.0))
    poses = jsyn.straight_trajectory(3, 0.05, 0.0, 0.15)
    frames = [jfront.process_mono(jsyn.render_view(T, world, 256, 512, 320.0, 320.0, 256.0,
                                                   128.0), cfg, 0.0) for T in poses[::2]]
    b_ref, ok_ref = jmatch.search_for_initialization(frames[0].features, frames[1].features)
    fa, fb = (from_jax_numpy(jax.tree.map(np.asarray, f.features)) for f in frames)
    b_out, ok_out = tmatch.search_for_initialization(fa, fb)
    np.testing.assert_array_equal(ok_out.numpy(), np.array(ok_ref))
    ok = np.array(ok_ref)
    assert ok.sum() > 50
    np.testing.assert_array_equal(b_out.numpy()[ok], np.array(b_ref)[ok])
