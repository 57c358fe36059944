"""Port kernels vs the reference package: FAST+NMS and the window gather.

The plain versions (what a CPU tensor runs) are held to the reference
package's XLA chain and to its Pallas kernels in interpret mode, bit for bit:
both kernels only subtract, negate, take min/max or copy float32 values.
The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.ops import fast as jfast
from opendlv_perception_vision_orbslam2_tpu.ops.fast_pallas import fast_nms as jfast_nms
from opendlv_perception_vision_orbslam2_tpu.ops.gather_pallas import (
    gather_patches as jgather,
)
from opendlv_perception_vision_orbslam2_tpu_torch.ops import fast_kernel, gather_kernel

torch.set_num_threads(2)


def _rand_img(h, w, seed=0, integer=False):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    return np.round(img) if integer else img


@pytest.mark.parametrize(
    "h,w,th,integer",
    [(96, 160, 7.0, False), (64, 80, 20.0, False), (40, 52, 7.0, True)],
)
def test_fast_nms_plain_equals_xla_chain_whole_image(h, w, th, integer):
    """Bit-equal to nms_scores(fast_score_map(img, th)) everywhere,
    including the edge rows and columns (tolerance: none)."""
    img = _rand_img(h, w, seed=h, integer=integer)
    ref = np.asarray(jfast.nms_scores(jfast.fast_score_map(jnp.asarray(img), th)))
    out = fast_kernel.fast_nms(torch.from_numpy(img), th).numpy()
    np.testing.assert_array_equal(out, ref)


def test_fast_nms_plain_equals_pallas_inside_halo():
    """Bit-equal to the Pallas kernel (interpret mode) at >= 4 px from the
    edge, where its zero padding cannot reach (tolerance: none)."""
    img = _rand_img(96, 160, seed=3)
    ref = np.asarray(jfast_nms(jnp.asarray(img), 7.0, interpret=True))
    out = fast_kernel.fast_nms(torch.from_numpy(img), 7.0).numpy()
    m = 4
    np.testing.assert_array_equal(out[m:-m, m:-m], ref[m:-m, m:-m])


def test_fast_nms_batch_equals_single_images():
    imgs = np.stack([_rand_img(48, 64, seed=s) for s in (1, 2)])
    both = fast_kernel.fast_nms(torch.from_numpy(imgs), 7.0)
    for e in range(2):
        one = fast_kernel.fast_nms(torch.from_numpy(imgs[e]), 7.0)
        assert torch.equal(both[e], one)


@pytest.mark.parametrize(
    "H,W,ph,pw,n",
    [
        (420, 1332, 45, 45, 100),   # ORB descriptor patches, KITTI L0 scale
        (97, 250, 11, 21, 37),      # stereo SAD strips, small level
        (64, 140, 11, 11, 5),       # left SAD windows
    ],
)
def test_gather_plain_equals_pallas(H, W, ph, pw, n):
    """Bit-equal to the Pallas gather in interpret mode (tolerance: none)."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    y0 = rng.integers(0, H - ph + 1, n).astype(np.int32)
    x0 = rng.integers(0, W - pw + 1, n).astype(np.int32)
    ref = np.asarray(jgather(jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0),
                             ph=ph, pw=pw, interpret=True))
    out = gather_kernel.gather_patches(
        torch.from_numpy(img), torch.from_numpy(y0), torch.from_numpy(x0), ph, pw
    ).numpy()
    np.testing.assert_array_equal(out, ref)


def test_gather_plain_clips_out_of_range_starts():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (40, 200)).astype(np.float32)
    y0 = np.array([-3, 38], np.int32)   # below 0 / beyond H-ph
    x0 = np.array([190, -1], np.int32)
    ref = np.asarray(jgather(jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0),
                             ph=8, pw=16, interpret=True))
    out = gather_kernel.gather_patches(
        torch.from_numpy(img), torch.from_numpy(y0), torch.from_numpy(x0), 8, 16
    ).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, np.stack([img[0:8, 184:200], img[32:40, 0:16]]))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = (fast_kernel.fast_nms.launches, gather_kernel.gather_patches.launches)
    img = torch.from_numpy(_rand_img(32, 48))
    fast_kernel.fast_nms(img, 7.0)
    gather_kernel.gather_patches(img, torch.zeros(3, dtype=torch.int32),
                                 torch.zeros(3, dtype=torch.int32), 5, 5)
    after = (fast_kernel.fast_nms.launches, gather_kernel.gather_patches.launches)
    assert after == before


def test_other_devices_raise():
    img = torch.empty((32, 48), device="meta")
    with pytest.raises(ValueError):
        fast_kernel.fast_nms(img, 7.0)
    with pytest.raises(ValueError):
        gather_kernel.gather_patches(img, torch.zeros(1, dtype=torch.int32, device="meta"),
                                     torch.zeros(1, dtype=torch.int32, device="meta"), 5, 5)
