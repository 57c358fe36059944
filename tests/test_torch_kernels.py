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
from opendlv_perception_vision_orbslam2_tpu_torch.ops import fast as tfast
from opendlv_perception_vision_orbslam2_tpu_torch.ops import fast_kernel, gather_kernel
from opendlv_perception_vision_orbslam2_tpu_torch.ops import image as timage

torch.set_num_threads(2)


def _rand_img(h, w, seed=0, integer=False):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    return np.round(img) if integer else img


def _image(kind, h, w, seed=0):
    """Random, integer-valued random, or smooth (two sinusoids, a ramp)."""
    if kind == "smooth":
        y, x = np.mgrid[0:h, 0:w].astype(np.float32)
        return (100 + 40 * np.sin(x / 7) + 30 * np.cos(y / 5) + 0.3 * x).astype(np.float32)
    return _rand_img(h, w, seed=seed, integer=kind == "integer")


# KITTI-00's 8-level pyramid of both eyes (1241x376, scale 1.2)
KITTI_LEVELS = [(2, 376, 1241), (2, 313, 1034), (2, 261, 862), (2, 218, 718),
                (2, 181, 598), (2, 151, 499), (2, 126, 416), (2, 105, 346)]


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


def _launch_counts():
    return (fast_kernel.fast_nms.launches, fast_kernel.fast_nms_pyramid.launches,
            gather_kernel.gather_patches.launches, gather_kernel.gather_patches_multi.launches)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = _launch_counts()
    img = torch.from_numpy(_rand_img(32, 48))
    zeros = torch.zeros(3, dtype=torch.int32)
    fast_kernel.fast_nms(img, 7.0)
    fast_kernel.fast_nms_pyramid([img, img[:16, :24]], 7.0)
    gather_kernel.gather_patches(img, zeros, zeros, 5, 5)
    gather_kernel.gather_patches_multi([(img, zeros, zeros, 5, 5), (img, zeros, zeros, 3, 7)])
    assert _launch_counts() == before


def test_other_devices_raise():
    img = torch.empty((32, 48), device="meta")
    with pytest.raises(ValueError):
        fast_kernel.fast_nms(img, 7.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_nms_pyramid([img], 7.0)
    starts = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        gather_kernel.gather_patches(img, starts, starts, 5, 5)
    with pytest.raises(ValueError):
        gather_kernel.gather_patches_multi([(img, starts, starts, 5, 5)])


def test_fast_nms_pyramid_plain_equals_per_level():
    """The pyramid entry point on the CPU is fast_nms_plain of each level of
    a 4-level two-eye pyramid, bit for bit (tolerance: none)."""
    both = torch.from_numpy(np.stack([_rand_img(96, 160, seed=s) for s in (4, 5)]))
    levels = timage.build_pyramid(both, 4, 1.2)
    maps = fast_kernel.fast_nms_pyramid(levels, 7.0)
    assert len(maps) == 4
    for lv, m in zip(levels, maps):
        assert torch.equal(m, fast_kernel.fast_nms_plain(lv, 7.0))


COMPASS_CASES = [(kind, th) for kind in ("random", "integer", "smooth")
                 for th in (-5.0, 0.0, 7.0, 20.0)]


@pytest.mark.parametrize("kind,th", COMPASS_CASES)
def test_compass_test_keeps_every_corner(kind, th):
    """FAST's compass early-out is exact: each polarity whose 9-arc
    response exceeds the threshold passes it, so every pixel with a
    non-zero fast_score_map is a candidate."""
    img = torch.from_numpy(_image(kind, 48, 64, seed=7))
    bright, dark = tfast.compass_test(img, th)
    d = [n - img for n in tfast._neighbor_views(img)]
    assert not ((tfast._arc_response(d) > th) & ~bright).any()
    assert not ((tfast._arc_response([-x for x in d]) > th) & ~dark).any()
    assert not ((tfast.fast_score_map(img, th) != 0) & ~(bright | dark)).any()


@pytest.mark.parametrize("kind,th", COMPASS_CASES)
def test_kernel_score_rule_equals_plain(kind, th):
    """The kernel's rule, written densely: the compass test as "second
    largest of the 4 compass d_i > th" (bright) and "minus the second
    smallest > th" (dark) equals compass_test; the tree runs only for the
    polarities that pass, v is their max, kept where v > th; then NMS.
    Equals fast_nms_plain bit for bit (tolerance: none)."""
    img = torch.from_numpy(_image(kind, 48, 64, seed=8))
    bright, dark = tfast.compass_test(img, th)
    views = tfast._neighbor_views(img)
    d = [n - img for n in views]
    d0, d4, d8, d12 = (d[k] for k in tfast.COMPASS)
    lo = torch.maximum(torch.minimum(d0, d4), torch.minimum(d8, d12))
    hi = torch.minimum(torch.maximum(d0, d4), torch.maximum(d8, d12))
    assert torch.equal(torch.maximum(lo, hi) > th, bright)
    assert torch.equal(-torch.minimum(lo, hi) > th, dark)
    rb, rd = tfast._arc_response(d), tfast._arc_response([-x for x in d])
    ninf = torch.full_like(img, -float("inf"))
    v = torch.maximum(torch.where(bright, rb, ninf), torch.where(dark, rd, ninf))
    s = torch.where(v > th, v, torch.zeros_like(img))
    assert torch.equal(tfast.nms_scores(s), fast_kernel.fast_nms_plain(img, th))


@pytest.mark.parametrize("shapes", [
    KITTI_LEVELS,
    [(2, 256, 512), (2, 213, 427), (2, 178, 356), (2, 148, 296)],
    [(1, 1, 1), (3, 33, 65), (1, 64, 64), (2, 5, 130)],
], ids=["kitti-8-levels", "fixture-4-levels", "odd"])
def test_pyramid_tile_table_covers_every_output_once(shapes):
    rows, n_blocks = fast_kernel.pyramid_tile_table(shapes)
    cover = [np.zeros(s, np.int32) for s in shapes]
    for flat in range(n_blocks):
        lvl, eye, y0, x0 = fast_kernel.tile_of(flat, rows)
        cover[lvl][eye, y0:y0 + fast_kernel.TILE_H, x0:x0 + fast_kernel.TILE_W] += 1
    for c in cover:
        assert (c == 1).all()


@pytest.mark.parametrize("sizes", [
    [4000 * 45 * 45],
    [2048 * 11 * 11, 2048 * 11 * 21],
    [1, 3, 5, 2049],
    [0, 7, 0],
], ids=["orb", "sad-pair", "odd", "empty"])
def test_gather_job_table_covers_every_output_once(sizes):
    rows, n_floats, n_blocks = gather_kernel.gather_job_table(sizes)
    padded = [-(-n // 4) * 4 for n in sizes]
    cover = np.zeros(n_floats, np.int32)
    for flat in range(n_blocks):
        k, start, stop = gather_kernel.block_span(flat, rows, sizes)
        assert start < stop
        cover[rows[k][0] + start:rows[k][0] + stop] += 1
    assert (cover == 1).all()
    assert all(off % 4 == 0 for off, _ in rows)     # 16-byte aligned outputs
    assert n_floats == sum(padded)


def test_gather_multi_plain_equals_one_gather_per_job():
    """Different images and window shapes, starts out of range included."""
    rng = np.random.default_rng(9)
    jobs = []
    for (H, W, ph, pw) in ((80, 120, 11, 11), (90, 140, 11, 21), (60, 70, 45, 45)):
        img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
        y0 = torch.from_numpy(rng.integers(-20, H + 20, 33).astype(np.int32))
        x0 = torch.from_numpy(rng.integers(-20, W + 20, 33).astype(np.int32))
        jobs.append((img, y0, x0, ph, pw))
    outs = gather_kernel.gather_patches_multi(jobs)
    assert len(outs) == 3
    for out, job in zip(outs, jobs):
        assert torch.equal(out, gather_kernel.gather_patches_plain(*job))
