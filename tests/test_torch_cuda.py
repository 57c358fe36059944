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


# ---- place recognition on the card vs the CPU: integers identical, so the
# first-minimum rule among tied distances holds on the card too -----------------


def _descs(m, seed):
    d = np.random.default_rng(seed).integers(0, 2**32, (m, 8), dtype=np.uint32)
    return d.view(np.int32)


def _vocab_and_sets():
    from opendlv_perception_vision_orbslam2_tpu_torch.models import vocabulary as voc

    pool = _descs(3000, 0)
    pool[1500:] = pool[:1500] ^ (1 << np.random.default_rng(1).integers(0, 31, (1500, 8)))
    vocab = voc.train_vocabulary(pool, branching=10, levels=4, seed=0)
    sets = torch.from_numpy(pool[:2400].reshape(12, 200, 8).copy())
    valid = torch.from_numpy(np.random.default_rng(2).uniform(size=(12, 200)) < 0.9)
    return voc, vocab, sets, valid


@pytest.mark.cuda
def test_transform_on_card_equals_cpu():
    _require_cuda()
    voc, vocab, sets, valid = _vocab_and_sets()
    cvocab = voc.vocabulary_to(vocab, "cuda")
    w_cpu, n_cpu = voc.transform_all(vocab, sets, valid)
    w, n = voc.transform_all(cvocab, sets.cuda(), valid.cuda(), kf_chunk=5)
    assert torch.equal(w.cpu(), w_cpu) and torch.equal(n.cpu(), n_cpu)
    w1, n1 = voc.transform(cvocab, sets[3].cuda(), valid[3].cuda())
    assert torch.equal(w1.cpu(), w_cpu[3]) and torch.equal(n1.cpu(), n_cpu[3])
    rows = voc.bow_vectors(cvocab, w)
    torch.testing.assert_close(rows.cpu(), voc.bow_vectors(vocab, w_cpu), rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_detect_candidates_on_card_equals_cpu():
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.models import kfdb

    voc, vocab, sets, valid = _vocab_and_sets()
    words, _ = voc.transform_all(vocab, sets, valid)
    rows = voc.bow_vectors(vocab, words)
    db = kfdb.empty_kfdb(16, vocab.n_words)
    for i in range(12):
        db = kfdb.add_keyframe(db, i, rows[i])
    c = np.triu(np.random.default_rng(3).integers(0, 3, (16, 16)), 1)   # tied weights
    covis = torch.from_numpy((c + c.T).astype(np.int32))
    exclude = torch.zeros(16, dtype=torch.bool)
    exclude[2] = True
    cdb = kfdb.KeyFrameDatabase(db.bow.cuda(), db.has_row.cuda())
    for q in (4, 9):
        query = 0.5 * (rows[q] + rows[(q + 5) % 12])
        ref_c, ref_s = kfdb.detect_candidates(db, query, exclude, 0.0, covis)
        out_c, out_s = kfdb.detect_candidates(cdb, query.cuda(), exclude.cuda(), 0.0,
                                              covis.cuda())
        assert torch.equal(out_c.cpu(), ref_c) and (ref_c >= 0).any()
        torch.testing.assert_close(out_s.cpu(), ref_s, rtol=0, atol=1e-6)
        assert torch.equal(kfdb.common_word_counts(cdb, query.cuda()).cpu(),
                           kfdb.common_word_counts(db, query))


@pytest.mark.cuda
def test_search_by_bow_on_card_equals_cpu():
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import matching

    voc, vocab, sets, valid = _vocab_and_sets()
    rng = np.random.default_rng(4)
    a = sets[0]
    b = a ^ torch.from_numpy((1 << rng.integers(0, 31, (200, 8))).astype(np.int32))
    ang_a = torch.from_numpy(rng.uniform(0, 6.28, 200).astype(np.float32))
    ang_b = ang_a + 0.02
    _, na = voc.transform(vocab, a, valid[0])
    _, nb = voc.transform(vocab, b, valid[1])
    args = (a, na, valid[0], ang_a, b, nb, valid[1], ang_b)
    ref_i, ref_ok = matching.search_by_bow(*args, nn_ratio=0.9)
    out_i, out_ok = matching.search_by_bow(*(x.cuda() for x in args), nn_ratio=0.9)
    assert torch.equal(out_ok.cpu(), ref_ok) and torch.equal(out_i.cpu(), ref_i)
    assert ref_ok.sum() > 50


@pytest.mark.cuda
@pytest.mark.parametrize("P", [5000, 20000])
def test_brute_match_points_on_card_equals_cpu(P):
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.models.relocalization import (
        _brute_match_points,
    )

    rng = np.random.default_rng(P)
    pts = _descs(P, 5)
    pts[P // 2:] = pts[:P - P // 2]                       # twins: ties across blocks
    pt_valid = torch.from_numpy(rng.uniform(size=P) < 0.8)
    feat = torch.from_numpy(pts[rng.integers(0, P, 512)] ^ (1 << rng.integers(0, 31, (512, 8))))
    feat_valid = torch.from_numpy(rng.uniform(size=512) < 0.9)
    pts = torch.from_numpy(pts)
    ref_i, ref_ok = _brute_match_points(feat, feat_valid, pts, pt_valid)
    out_i, out_ok = _brute_match_points(feat.cuda(), feat_valid.cuda(), pts.cuda(),
                                        pt_valid.cuda())
    assert torch.equal(out_i.cpu(), ref_i) and torch.equal(out_ok.cpu(), ref_ok)
    assert ref_ok.sum() > 300


@pytest.mark.cuda
def test_refine_pose_on_card_equals_cpu():
    """The relocalization pose solve on outlier-heavy BoW matches (the case of
    tests/test_torch_reloc.py: 105 pairs, an EPnP consensus of 60): the same
    inliers on the card as on the CPU and the pose within 1e-3.  Pose
    optimization over all 105 matches, which the reference package runs, is
    not held: its answer hangs on rounding on either device."""
    _require_cuda()
    from pathlib import Path

    from opendlv_perception_vision_orbslam2_tpu_torch.models.relocalization import refine_pose
    from opendlv_perception_vision_orbslam2_tpu_torch.optim.pose_opt import PoseObs
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import SystemConfig

    case = np.load(Path(__file__).with_name("test_torch_reloc_case.npz"))
    f = {k: torch.from_numpy(case[k]) for k in case.files}
    cam = SystemConfig().camera
    K = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf)
    obs = PoseObs(f["p_w"], f["uv"], f["u_right"], f["sigma2"],
                  torch.ones(len(f["p_w"]), dtype=torch.bool))
    T_cpu, inl_cpu = refine_pose(f["T_pnp"], obs, f["consensus"], **K)
    T, inl = refine_pose(f["T_pnp"].cuda(), PoseObs(*(x.cuda() for x in obs)),
                         f["consensus"].cuda(), **K)
    assert int(inl_cpu.sum()) >= 60 and torch.equal(inl.cpu(), inl_cpu)
    assert float((T.cpu() - T_cpu).abs().max()) < 1e-3
    assert float(torch.linalg.vector_norm(T.cpu()[:3, 3] - f["T_gt"][:3, 3])) < 0.05
