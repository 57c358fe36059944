"""CUDA kernels vs their plain PyTorch versions, bit for bit, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file imports no
jax (the card's machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu_torch.ops import fast_kernel, gather_kernel


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _rand_img(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


@pytest.mark.cuda
def test_fast_nms_kernel_equals_plain_on_card():
    _require_cuda()
    imgs = np.stack([_rand_img(376, 1241, seed=s) for s in (0, 1)])
    x = torch.from_numpy(imgs).cuda()
    for th in (7.0, 20.0):
        out = fast_kernel.fast_nms(x, th)
        assert torch.equal(out, fast_kernel.fast_nms_plain(x, th))


@pytest.mark.cuda
def test_gather_kernel_equals_plain_on_card():
    _require_cuda()
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (900, 1300)).astype(np.float32)).cuda()
    for ph, pw in ((45, 45), (11, 11), (11, 21)):
        y0 = torch.from_numpy(rng.integers(-50, 950, 2048).astype(np.int32)).cuda()
        x0 = torch.from_numpy(rng.integers(-50, 1350, 2048).astype(np.int32)).cuda()
        out = gather_kernel.gather_patches(img, y0, x0, ph, pw)
        assert torch.equal(out, gather_kernel.gather_patches_plain(img, y0, x0, ph, pw))
