"""The port's live-ingest resampling against the reference package:
``rodrigues``, ``stereo_rectify``, ``build_rectify_map``, ``remap_bilinear``
and ``resize_bilinear``, on the same numpy inputs.

Tolerances, and why: the rotations within 1e-6 (float32 products summed in
another order); the rectify maps within 1e-3 px at KITTI size (1241x376)
and at the deploy width (1280x720 per eye), as both packages build them in
float32 with a 3x3 inverse; the remapped and resized images within 1e-3
grey levels (bilinear weights multiplied in another order).  The epipolar
bar of tests/test_undistort.py holds on the port unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.ops import resample as jres
from opendlv_perception_vision_orbslam2_tpu.ops import undistort as jund
from opendlv_perception_vision_orbslam2_tpu_torch.ops import resample as tres
from opendlv_perception_vision_orbslam2_tpu_torch.ops import undistort as tund

torch.set_num_threads(2)

RVEC = [0.02, -0.03, 0.01]
# left (fx, fy, cx, cy) and right intrinsics of tests/test_undistort.py
INTR = (320.0, 318.0, 256.0, 126.0, 322.0, 321.0, 254.0, 130.0)
DIST = (-0.12, 0.03, 4e-4, -3e-4, 0.002)   # k1, k2, p1, p2, k3


def _pair(rvec=RVEC, b=0.5):
    R = np.asarray(jund.rodrigues(jnp.asarray(rvec, jnp.float32)))
    return R, R @ np.array([-b, 0.0, 0.0])   # right camera at +x in LEFT coords


def test_rodrigues_matches_reference():
    for rvec in (RVEC, [0.0, 0.0, 0.0], [1.2, -0.4, 2.0]):
        out = tund.rodrigues(torch.tensor(rvec, dtype=torch.float32)).numpy()
        ref = np.asarray(jund.rodrigues(jnp.asarray(rvec, jnp.float32)))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_stereo_rectify_matches_reference():
    R, T = _pair()
    R1, R2, intr, base = tund.stereo_rectify(torch.from_numpy(R.astype(np.float32)),
                                             torch.from_numpy(T.astype(np.float32)), *INTR)
    jR1, jR2, jintr, jbase = jund.stereo_rectify(jnp.asarray(R, jnp.float32),
                                                 jnp.asarray(T, jnp.float32), *INTR)
    np.testing.assert_allclose(R1.numpy(), np.asarray(jR1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(R2.numpy(), np.asarray(jR2), rtol=0, atol=1e-6)
    assert tuple(map(float, intr)) == tuple(map(float, jintr))
    assert abs(float(base) - float(jbase)) < 1e-6


def test_stereo_rectify_aligns_epipolar_rows():
    """tests/test_undistort.py's bar on the port: a 3-D point projects to
    the same row in both rectified cameras and to disparity f*b/z."""
    rng = np.random.default_rng(0)
    R = tund.rodrigues(torch.tensor([0.02, -0.03, 0.01])).numpy().astype(np.float64)
    b = 0.5
    T = R @ np.array([-b, 0.0, 0.0])
    R1, R2, (fx, fy, cx, cy), base = tund.stereo_rectify(
        torch.tensor(R, dtype=torch.float32), torch.tensor(T, dtype=torch.float32), *INTR)
    R1, R2 = R1.numpy(), R2.numpy()
    assert abs(float(base) - b) < 1e-5
    pts = np.stack([rng.uniform(-4, 4, 50), rng.uniform(-2, 2, 50), rng.uniform(4, 30, 50)], -1)

    def proj(Rrect, offs):
        pc = (pts + offs) @ Rrect.T
        return float(fx) * pc[:, 0] / pc[:, 2] + float(cx), \
            float(fy) * pc[:, 1] / pc[:, 2] + float(cy), pc[:, 2]

    c2 = -R.T @ T
    uL, vL, zL = proj(R1, 0.0)
    uR, vR, _ = proj(R2 @ R, -c2)
    np.testing.assert_allclose(vL, vR, atol=1e-3)
    np.testing.assert_allclose(uL - uR, float(fx) * b / zL, rtol=1e-4)


def _maps(h, w, scale):
    """Both packages' rectify maps for the left eye of a scaled pair."""
    R, T = _pair()
    intr = tuple(v * scale for v in INTR)
    R1, _, (fxn, fyn, cxn, cyn), _ = tund.stereo_rectify(
        torch.from_numpy(R.astype(np.float32)), torch.from_numpy(T.astype(np.float32)), *intr)
    out = tund.build_rectify_map(h, w, *intr[:4], *DIST[:2], *DIST[2:4], DIST[4], R1,
                                 fxn, fyn, cxn, cyn)
    jR1, _, (jfx, jfy, jcx, jcy), _ = jund.stereo_rectify(
        jnp.asarray(R, jnp.float32), jnp.asarray(T, jnp.float32), *intr)
    ref = jund.build_rectify_map(h, w, *intr[:4], *DIST[:2], *DIST[2:4], DIST[4], jR1,
                                 jfx, jfy, jcx, jcy)
    return out, np.asarray(ref)


@pytest.mark.parametrize("h, w, scale", [(376, 1241, 1241 / 512), (720, 1280, 2.5)],
                         ids=["kitti", "deploy"])
def test_build_rectify_map_matches_reference(h, w, scale):
    out, ref = _maps(h, w, scale)
    assert out.shape == (h, w, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)
    # the map moves pixels: distortion and rotation are not the identity
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    assert np.abs(ref - grid).max() > 5.0


def test_remap_bilinear_matches_reference():
    out_grid, ref_grid = _maps(256, 512, 1.0)
    img = np.random.default_rng(1).uniform(0, 255, (256, 512)).astype(np.float32)
    # sample points beyond every border too, and exactly on the last row/column
    grid = out_grid.numpy().copy()
    grid[0, :8] = [[-3.0, -2.0], [600.0, 10.0], [10.0, 300.0], [511.0, 255.0],
                   [511.0, 0.5], [0.25, 255.0], [1e6, -1e6], [255.5, 127.25]]
    out = tund.remap_bilinear(torch.from_numpy(img), torch.from_numpy(grid)).numpy()
    ref = np.asarray(jund.remap_bilinear(jnp.asarray(img), jnp.asarray(grid)))
    assert out.shape == (256, 512)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", [(128, 256), (188, 620)])
def test_resize_bilinear_matches_reference(shape):
    img = np.random.default_rng(2).uniform(0, 255, (256, 512)).astype(np.float32)
    out = tres.resize_bilinear(torch.from_numpy(img), shape).numpy()
    ref = np.asarray(jres.resize_bilinear(jnp.asarray(img), shape))
    assert out.shape == shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
