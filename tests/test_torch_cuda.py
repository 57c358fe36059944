"""The port on the card: CUDA kernels vs their plain PyTorch versions, bit for
bit, and the SLAM stages on the card vs the same stages on the CPU.

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
@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
def test_fast_nms_pyramid_kernel_equals_plain_on_card(integer):
    """One launch over all 8 levels x 2 eyes of a KITTI-size pyramid, bit
    for bit against the plain version at thresholds 0, 7 and 20."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import image

    imgs = np.stack([_rand_img(376, 1241, seed=s) for s in (2, 3)])
    if integer:
        imgs = np.round(imgs)
    levels = image.build_pyramid(torch.from_numpy(imgs).cuda(), 8, 1.2)
    for th in (0.0, 7.0, 20.0):
        before = fast_kernel.fast_nms_pyramid.launches
        maps = fast_kernel.fast_nms_pyramid(levels, th)
        assert fast_kernel.fast_nms_pyramid.launches == before + 1
        torch.cuda.synchronize()
        for lvl, (m, lv) in enumerate(zip(maps, levels)):
            assert torch.equal(m, fast_kernel.fast_nms_plain(lv, th)), f"level {lvl} th {th}"


@pytest.mark.cuda
def test_gather_multi_kernel_equals_plain_on_card():
    """The two SAD gathers in one launch, plus a runtime-shape job; starts
    out of range included."""
    _require_cuda()
    rng = np.random.default_rng(1)
    jobs = []
    for H, W, ph, pw in ((900, 1262, 11, 11), (900, 1272, 11, 21), (300, 400, 7, 13)):
        img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).cuda()
        y0 = torch.from_numpy(rng.integers(-50, H + 50, 2048).astype(np.int32)).cuda()
        x0 = torch.from_numpy(rng.integers(-50, W + 50, 2048).astype(np.int32)).cuda()
        jobs.append((img, y0, x0, ph, pw))
    before = gather_kernel.gather_patches_multi.launches
    outs = gather_kernel.gather_patches_multi(jobs)
    assert gather_kernel.gather_patches_multi.launches == before + 1
    torch.cuda.synchronize()
    for out, job in zip(outs, jobs):
        assert torch.equal(out, gather_kernel.gather_patches_plain(*job))


@pytest.mark.cuda
def test_gather_kernel_equals_plain_on_card():
    _require_cuda()
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (900, 1300)).astype(np.float32)).cuda()
    for ph, pw in ((45, 45), (11, 11), (11, 21), (8, 16), (1, 1)):
        y0 = torch.from_numpy(rng.integers(-50, 950, 2048).astype(np.int32)).cuda()
        x0 = torch.from_numpy(rng.integers(-50, 1350, 2048).astype(np.int32)).cuda()
        out = gather_kernel.gather_patches(img, y0, x0, ph, pw)
        assert torch.equal(out, gather_kernel.gather_patches_plain(img, y0, x0, ph, pw))


def _slam_cfg():
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import (
        CameraConfig, OrbConfig, SystemConfig, TrackingConfig,
    )

    return SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512,
                            height=256, fps=10.0),
        orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
        tracking=TrackingConfig(max_frames=5), max_keyframes=32, max_map_points=4096)


def _to(tree, dev):
    return type(tree)(*(x.to(dev) if isinstance(x, torch.Tensor) else _to(x, dev)
                        for x in tree))


def _assert_map_close(out, ref):
    """Integer and bool fields exact; floats within the CPU parity tests'
    tolerances (2e-3 for triangulated geometry, 5e-5 for poses)."""
    for name, a, b in zip(ref._fields, out, ref):
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            tol = 5e-5 if name == "kf_T_cw" else 2e-3
            torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=name)
        else:
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_slam_stages_on_card_equal_cpu(monkeypatch):
    """The mapping stage and the per-frame tracking program give the same
    map on the card as on the CPU, from the same map and frame."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.models.frontend import process_stereo
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic

    cfg = _slam_cfg()
    lefts, rights, _, _ = synthetic.render_stereo_sequence(cfg, n_frames=16, n_points=500,
                                                           seed=5, step=0.25)
    slam = slam_mod.StereoSlam(cfg, enable_loop_closing=False, enable_relocalization=False,
                               device="cpu")
    slam.force_sync_decisions = True
    i = 0
    while slam.n_keyframes < 3 and i < 15:      # a map with local BA behind it
        slam.process(lefts[i], rights[i], timestamp=i * 0.1)
        i += 1
    assert slam.n_keyframes >= 3
    slot = torch.tensor(slam.last_kf_slot)
    ref, ref_aux = slam_mod.mapping_stage(slam.map, slot, cfg, True, True, True, True)
    out, aux = slam_mod.mapping_stage(_to(slam.map, "cuda"), slot.cuda(), cfg,
                                      True, True, True, True)
    assert torch.equal(aux.cpu(), ref_aux)
    _assert_map_close(out, ref)

    # one tracking step from the same state, with the same RANSAC sets
    sets = pnp.sample_sets(torch.ones(1024, dtype=torch.bool), torch.Generator().manual_seed(0))
    monkeypatch.setattr(pnp, "sample_sets", lambda valid, gen, n=256: sets.to(valid.device))
    cur = process_stereo(torch.from_numpy(lefts[i]), torch.from_numpy(rights[i]), cfg, i * 0.1)
    args = (slam.map, slam.last_frame, slam.last_bindings, slam.T_cw, slam.velocity, cur)
    ref_t = slam_mod.track_frame_with_map(*args, cfg)
    out_t = slam_mod.track_frame_with_map(*(_to(a, "cuda") if isinstance(a, tuple)
                                            else a.cuda() for a in args), cfg)
    torch.testing.assert_close(out_t.T_cw.cpu(), ref_t.T_cw, rtol=0, atol=1e-4)
    for name in ref_t._fields[1:]:
        assert torch.equal(getattr(out_t, name).cpu(), getattr(ref_t, name)), name
