"""Port front end vs the reference package on identical numpy inputs.

Fixture: the 512x256 camera, 600 features and 4 levels of
``tests/test_frontend.py``.  Tolerances, and why:

- the pyramid is a float32 matmul pair whose sums run in another order than
  XLA:CPU's, so it agrees within 1e-3 intensity, not bit for bit; every
  downstream stage is therefore fed the reference package's pyramid;
- keypoint selection, octave, validity and response only compare and copy:
  exact;
- angles come from a [N, 961] @ [961, 2] moment matmul: within 1e-5 rad;
- the descriptor blur is again a float32 matmul.  On the synthetic fixture's
  flat background two BRIEF samples tie in exact arithmetic and the rounding
  decides the bit, so descriptors are compared (a) given the reference
  blur, exactly, and (b) end to end on a textured image, where ties are
  rare: >= 99 % of valid keypoints with all 8 words equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import extractor as jext
from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.ops import image as jimage
from opendlv_perception_vision_orbslam2_tpu.ops import orb as jorb
from opendlv_perception_vision_orbslam2_tpu.ops import stereo as jstereo
from opendlv_perception_vision_orbslam2_tpu.ops import undistort as jundist
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu.utils import synthetic as jsyn
from opendlv_perception_vision_orbslam2_tpu_torch.models import extractor as text
from opendlv_perception_vision_orbslam2_tpu_torch.models import frontend as tfront
from opendlv_perception_vision_orbslam2_tpu_torch.ops import image as timage
from opendlv_perception_vision_orbslam2_tpu_torch.ops import orb as torb
from opendlv_perception_vision_orbslam2_tpu_torch.ops import stereo as tstereo
from opendlv_perception_vision_orbslam2_tpu_torch.ops import undistort as tundist
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256, fps=10.0)
ORB = dict(n_features=600, max_keypoints=1024, n_levels=4)
JCFG = jconfig.SystemConfig(camera=jconfig.CameraConfig(**CAM), orb=jconfig.OrbConfig(**ORB))
TCFG = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM), orb=tconfig.OrbConfig(**ORB))


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def stereo_pair():
    """The test_frontend.py world seen by both eyes (numpy float32)."""
    world = jsyn.make_world(250, seed=3, x_range=(-8, 8), y_range=(-3, 3),
                            z_range=(3.0, 25.0))
    T_rl = jnp.eye(4).at[0, 3].set(-JCFG.camera.baseline_m)
    render = lambda T: _np(jsyn.render_view(  # noqa: E731
        T, world, 256, 512, CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"]))
    return render(jnp.eye(4)), render(T_rl), world


def _jax_levels(left, right):
    both = jnp.stack([jnp.asarray(left), jnp.asarray(right)])
    return jax.vmap(lambda im: jimage.build_pyramid(im, ORB["n_levels"], 1.2))(both)


@pytest.fixture(scope="module")
def reference_extraction(stereo_pair):
    left, right, _ = stereo_pair
    levels = _jax_levels(left, right)
    return levels, jext.extract_from_pyramid_pair(levels, JCFG.orb)


def test_pyramid_agrees_within_1e3(stereo_pair):
    left, right, _ = stereo_pair
    rnd = np.random.default_rng(0).uniform(0, 255, (256, 512)).astype(np.float32)
    for img in (left, rnd):
        ref = jimage.build_pyramid(jnp.asarray(img), 4, 1.2)
        out = timage.build_pyramid(torch.from_numpy(img), 4, 1.2)
        assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o.numpy(), _np(r), rtol=0, atol=1e-3)


def test_extractor_keypoints_exact_given_reference_pyramid(reference_extraction):
    levels, (jl, jr) = reference_extraction
    tl, tr = text.extract_from_pyramid_pair([_t(lv) for lv in levels], TCFG.orb)
    for j, t in ((jl, tl), (jr, tr)):
        for name in ("xy", "response", "octave", "valid"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), _np(getattr(j, name)))
        valid = _np(j.valid)
        np.testing.assert_allclose(t.angle.numpy()[valid], _np(j.angle)[valid],
                                   rtol=0, atol=1e-5)


def test_brief_exact_given_reference_blur(reference_extraction):
    """Sampling, binning and packing are exact once both sides read the same
    blurred patches; the port's own blur agrees within 1e-4 intensity."""
    levels, _ = reference_extraction
    jsel = jext._select_pyramid_keypoints(levels, JCFG.orb)
    patches = jext._gather_all_patches(levels, jsel[4], jsel[5], JCFG.orb)
    angles = jorb.ic_angles_from_patches(patches)
    bm = jnp.asarray(jorb._patch_blur_matrix())
    blurred = jnp.einsum("is,nst,jt->nij", bm, patches, bm)
    ref = _np(jorb.brief_from_patches(patches, angles, use_matmul=False)).view(np.int32)
    out = torb.brief_from_blurred(_t(blurred), _t(angles)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(torb.blur_patches(_t(patches)).numpy(), _np(blurred),
                               rtol=0, atol=1e-4)


def test_descriptors_agree_on_textured_image():
    rng = np.random.default_rng(7)
    left = rng.uniform(0, 255, (256, 512)).astype(np.float32)
    right = np.roll(left, -6, axis=1)
    levels = _jax_levels(left, right)
    jl, _ = jext.extract_from_pyramid_pair(levels, JCFG.orb)
    tl, _ = text.extract_from_pyramid_pair([_t(lv) for lv in levels], TCFG.orb)
    valid = _np(jl.valid)
    assert valid.sum() > 500
    same = (tl.desc.numpy() == _np(jl.desc).view(np.int32)).all(axis=1)[valid]
    assert same.mean() >= 0.99, f"only {same.mean():.4f} of descriptors agree"


def test_stereo_match_given_reference_features(reference_extraction):
    levels, (jl, jr) = reference_extraction
    atlas_l, offsets = jstereo.build_atlas([lv[0] for lv in levels])
    atlas_r, _ = jstereo.build_atlas([lv[1] for lv in levels])
    ur_ref, d_ref = jstereo.stereo_match(jl, jr, atlas_l, atlas_r, offsets,
                                         1.2, CAM["fx"], CAM["bf"])
    tl, tr = from_jax_numpy(jl), from_jax_numpy(jr)
    t_atlas_l, t_off = tstereo.build_atlas([_t(lv[0]) for lv in levels])
    t_atlas_r, _ = tstereo.build_atlas([_t(lv[1]) for lv in levels])
    np.testing.assert_array_equal(t_atlas_l.numpy(), _np(atlas_l))
    np.testing.assert_array_equal(t_off.numpy(), _np(offsets))
    ur, d = tstereo.stereo_match(tl, tr, t_atlas_l, t_atlas_r, t_off,
                                 1.2, CAM["fx"], CAM["bf"])
    assert int((_np(d_ref) > 0).sum()) > 50
    np.testing.assert_array_equal(d.numpy() > 0, _np(d_ref) > 0)
    np.testing.assert_allclose(ur.numpy(), _np(ur_ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(d.numpy(), _np(d_ref), rtol=0, atol=1e-4)


def test_process_stereo_on_frontend_fixture(stereo_pair):
    """End to end from the port's own pyramid.  Keypoints agree (sub-pixel
    offsets within 1e-3 px through the pyramid's rounding); stereo depth
    follows the descriptors, whose tied bits differ (see module docstring),
    so the port is held to the same ground-truth bound as
    test_frontend.py::test_stereo_depth_accuracy and to the reference on
    the points both match."""
    left, right, world = stereo_pair
    ref = jfront.process_stereo(jnp.asarray(left), jnp.asarray(right), JCFG).features
    out = tfront.process_stereo(torch.from_numpy(left), torch.from_numpy(right), TCFG)
    feats = out.features
    np.testing.assert_array_equal(feats.valid.numpy(), _np(ref.valid))
    np.testing.assert_array_equal(feats.octave.numpy(), _np(ref.octave))
    np.testing.assert_allclose(feats.xy.numpy(), _np(ref.xy), rtol=0, atol=1e-3)
    np.testing.assert_allclose(feats.response.numpy(), _np(ref.response), rtol=0, atol=1e-3)

    depth, depth_ref = feats.depth.numpy(), _np(ref.depth)
    both = (depth > 0) & (depth_ref > 0)
    assert both.sum() >= 0.9 * (depth_ref > 0).sum()
    agree = np.abs(depth[both] - depth_ref[both]) <= 1e-3 * depth_ref[both]
    assert agree.mean() >= 0.98, f"only {agree.mean():.4f} of common depths agree"

    # ground truth: nearest projected world point (test_frontend.py's bound)
    pts = _np(world.points)
    uv = pts[:, :2] * CAM["fx"] / pts[:, 2:3] + [CAM["cx"], CAM["cy"]]
    xy = feats.xy.numpy()
    errs = []
    for i in np.where(depth > 0)[0]:
        j = np.argmin(np.linalg.norm(uv - xy[i], axis=1))
        if np.linalg.norm(uv[j] - xy[i]) < 3.0:
            errs.append(abs(depth[i] - pts[j, 2]) / pts[j, 2])
    assert len(errs) > 40
    assert np.median(errs) < 0.05
    p = out.point_cam.numpy()
    np.testing.assert_array_equal(p[:, 2] > 0, depth > 0)


def test_undistort_matches_reference():
    rng = np.random.default_rng(3)
    k = dict(k1=-0.28, k2=0.07, p1=1e-3, p2=-5e-4, k3=0.0)
    uv = rng.uniform([0, 0], [640, 400], (200, 2)).astype(np.float32)
    ref = _np(jundist.undistort_points(jnp.asarray(uv), 400.0, 400.0, 320.0, 200.0, **k))
    out = tundist.undistort_points(torch.from_numpy(uv), 400.0, 400.0, 320.0, 200.0, **k)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)


def test_undistort_and_bbox_filters_match_reference(reference_extraction):
    _, (jl, _) = reference_extraction
    cam = dict(CAM, k1=-0.2, k2=0.05)
    tr = dict(bbox_min_x=100.0, bbox_max_x=300.0, bbox_min_y=150.0, bbox_max_y=256.0)
    jcfg = dataclasses.replace(JCFG, camera=jconfig.CameraConfig(**cam),
                               tracking=jconfig.TrackingConfig(**tr))
    tcfg = dataclasses.replace(TCFG, camera=tconfig.CameraConfig(**cam),
                               tracking=tconfig.TrackingConfig(**tr))
    jf = jl._replace(u_right=jnp.where(jl.valid, jl.xy[:, 0] - 5.0, -1.0))
    ref = jfront._undistort_features(jfront._bbox_filter(jf, jcfg), jcfg, shift_uright=True)
    out = tfront._undistort_features(tfront._bbox_filter(from_jax_numpy(jf), tcfg), tcfg,
                                     shift_uright=True)
    np.testing.assert_array_equal(out.valid.numpy(), _np(ref.valid))
    assert (_np(ref.valid) != _np(jl.valid)).any()
    np.testing.assert_allclose(out.xy.numpy(), _np(ref.xy), rtol=0, atol=1e-3)
    np.testing.assert_allclose(out.u_right.numpy(), _np(ref.u_right), rtol=0, atol=1e-3)
