"""The port on the card: CUDA kernels vs their plain PyTorch versions, bit for
bit, the SLAM stages on the card vs the same stages on the CPU, and the CLI
on several ranks (gloo on one card; NCCL one rank a card, with two or more).

Marked ``cuda``: each test skips without a CUDA device.  This file imports no
jax (the card's machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import time

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


# ---- the pose solve's chain set replayed from a CUDA graph: bit for bit the
# eager ``_pose_optimize_chains`` on the card ---------------------------------------

POSE_CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0)


def _pose_case(seed, n=200, outlier_frac=0.0, mono_frac=0.0):
    """A pose problem on the card (``tests/test_torch_tracking.py``'s, with
    a share of monocular edges): the perturbed start and the observations."""
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import lie
    from opendlv_perception_vision_orbslam2_tpu_torch.optim.pose_opt import PoseObs

    rng = np.random.default_rng(seed)
    p_w = np.stack([rng.uniform(-10, 10, n), rng.uniform(-4, 4, n),
                    rng.uniform(4, 40, n)], axis=-1).astype(np.float32)
    xi = (rng.standard_normal(6) * [0.3, 0.3, 0.3, 0.05, 0.05, 0.05]).astype(np.float32)
    T_true = lie.exp_se3(torch.from_numpy(xi)).numpy()
    p_c = p_w @ T_true[:3, :3].T + T_true[:3, 3]
    c = POSE_CAM
    uv = np.stack([c["fx"] * p_c[:, 0] / p_c[:, 2] + c["cx"],
                   c["fy"] * p_c[:, 1] / p_c[:, 2] + c["cy"]], axis=-1)
    ur = uv[:, 0] - c["bf"] / p_c[:, 2]
    uv += rng.standard_normal(uv.shape) * 0.3
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv[idx] += rng.uniform(-40, 40, (n_out, 2))
    ur[rng.uniform(size=n) < mono_frac] = -1.0
    delta = (rng.standard_normal(6) * [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]).astype(np.float32)
    T0 = lie.exp_se3(torch.from_numpy(delta)) @ torch.from_numpy(T_true)
    valid = rng.uniform(size=n) < 0.95
    obs = PoseObs(*(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        p_w, uv.astype(np.float32), ur.astype(np.float32), np.ones(n, np.float32), valid)))
    return T0.cuda(), obs


def _pose_counts(t0):
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import trace

    out = {}
    for r in trace.records(since_ns=t0):
        if isinstance(r, trace.Count) and r.name.startswith("pose."):
            out[r.name] = out.get(r.name, 0) + r.n
    return out


def _assert_equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,outliers,mono", [
    (0, 0.0, 0.0), (1, 0.3, 0.0), (2, 0.0, 1.0), (3, 0.3, 1.0), (4, 0.1, 0.5), (5, 0.25, 0.3),
])
def test_graphed_pose_solves_equal_eager_chains_on_card(monkeypatch, seed, outliers, mono):
    """``pose_optimize`` (C = 1) and ``robust_pose_estimate`` (C = 2) replay
    their chain set's graph; T, inliers and counts equal the eager
    ``_pose_optimize_chains`` on the same card with ``torch.equal``."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp, pose_opt

    T0, obs = _pose_case(seed, outlier_frac=outliers, mono_frac=mono)
    t0 = time.perf_counter_ns()
    graphed = pose_opt.pose_optimize(T0, obs, **POSE_CAM)
    T, inl, n = pose_opt._pose_optimize_chains(T0[None], obs._replace(valid=obs.valid[None]),
                                               *POSE_CAM.values())
    _assert_equal(graphed, (T[0], inl[0], n[0]))
    assert int(graphed[2]) > 100

    sets = pnp.sample_sets(obs.valid, torch.Generator("cuda").manual_seed(seed))
    robust = pose_opt.robust_pose_estimate(T0, obs, pnp_idx=sets, **POSE_CAM)
    assert _pose_counts(t0).get("pose.solve_graphed") == 2
    monkeypatch.setattr(pose_opt, "_solve_chains", pose_opt._pose_optimize_chains)
    _assert_equal(robust, pose_opt.robust_pose_estimate(T0, obs, pnp_idx=sets, **POSE_CAM))


@pytest.mark.cuda
def test_pose_graphs_capture_once_a_shape_and_keep_held_outputs_on_card():
    """Several problems through one graph in a row: one capture a shape,
    one replay a call, and what call 1 returned is unchanged after call 2.
    The cache keeps the ``GRAPH_CACHE_SIZE`` most recent shapes."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import pose_opt

    pose_opt._GRAPHS.clear()
    t0 = time.perf_counter_ns()
    held = []
    for seed in range(4):
        T0, obs = _pose_case(10 + seed, outlier_frac=0.2, mono_frac=0.3)
        out = pose_opt.pose_optimize(T0, obs, **POSE_CAM)
        held.append((out, [x.clone() for x in out]))
        _assert_equal(out, [x[0] for x in pose_opt._pose_optimize_chains(
            T0[None], obs._replace(valid=obs.valid[None]), *POSE_CAM.values())])
    for out, copy in held:
        _assert_equal(out, copy)
    for seed in range(3):
        T0, obs = _pose_case(20 + seed, outlier_frac=0.3)
        pose_opt.robust_pose_estimate(T0, obs, torch.Generator("cuda").manual_seed(seed),
                                      **POSE_CAM)
    T0, obs = _pose_case(30, n=105, outlier_frac=0.3)
    pose_opt.pose_optimize(T0, obs, **POSE_CAM)
    pose_opt.pose_optimize(T0, obs, **dict(POSE_CAM, bf=120.0))
    assert _pose_counts(t0) == {"pose.graph_capture": 4, "pose.solve_graphed": 9}
    assert len(pose_opt._GRAPHS) == 4
    for n in range(110, 120):
        pose_opt.pose_optimize(*_pose_case(40, n=n), **POSE_CAM)
    assert len(pose_opt._GRAPHS) == pose_opt.GRAPH_CACHE_SIZE
    pose_opt._GRAPHS.clear()


# ---- loop closing on the card vs the CPU: the ring of tests/test_loop_closing.py
# rebuilt without jax (this file runs where there is none) ------------------------

RING_F, RING_LAP, RING_KF, RING_R = 512, 20, 26, 20.0


def _ring_pose(i):
    th = 2 * np.pi * i / RING_LAP
    T_wc = np.eye(4)
    T_wc[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
    T_wc[:3, 3] = [RING_R * np.sin(th), 0.0, RING_R * (1 - np.cos(th))]
    return np.linalg.inv(T_wc).astype(np.float32)


def _ring_map():
    """The drifted 26-keyframe ring (30 points in front of each pose, random
    descriptors, a constant yaw bias on the odometry), inserted keyframe by
    keyframe with the port's ``insert_keyframe`` and registered in a
    keyframe database: ``(cfg, maps, dbs, nodes)`` per keyframe, on the CPU."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import map_state as ms
    from opendlv_perception_vision_orbslam2_tpu_torch.models import vocabulary as voc
    from opendlv_perception_vision_orbslam2_tpu_torch.models.frame import Features, FrameState
    from opendlv_perception_vision_orbslam2_tpu_torch.models.kfdb import add_keyframe, empty_kfdb
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import lie
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import (
        CameraConfig, OrbConfig, SystemConfig,
    )

    cam = CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256)
    cfg = SystemConfig(camera=cam, orb=OrbConfig(max_keypoints=RING_F))
    rng = np.random.default_rng(0)
    pts = []
    for i in range(RING_LAP):
        T_wc = np.linalg.inv(_ring_pose(i))
        local = np.stack([rng.uniform(-5, 5, 30), rng.uniform(-2, 2, 30),
                          rng.uniform(3.0, 12.0, 30)], axis=-1)
        pts.append(local @ T_wc[:3, :3].T + T_wc[:3, 3])
    pts = np.concatenate(pts).astype(np.float32)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    vocab = voc.train_vocabulary(descs, branching=8, levels=3, seed=1)
    bias = lie.exp_se3(torch.tensor([0.01, 0, 0.01, 0, 0.004, 0])).numpy()
    gt = [_ring_pose(i) for i in range(RING_KF)]
    drifted = [gt[0]]
    for i in range(1, RING_KF):
        drifted.append((bias @ (gt[i] @ np.linalg.inv(gt[i - 1])) @ drifted[-1])
                       .astype(np.float32))
    F = RING_F
    m = ms.empty_map(32, 32768, F)
    db = empty_kfdb(32, vocab.n_words)
    nodes = torch.full((32, F), -1, dtype=torch.int32)
    slot_of_world = -np.ones(len(pts), np.int64)
    last_seen = np.full(len(pts), -100)
    out = []
    for i in range(RING_KF):
        p_c = pts @ gt[i][:3, :3].T + gt[i][:3, 3]
        z = p_c[:, 2]
        vis = (z > 1.0) & (z < 14.0) & (np.abs(p_c[:, 0] / np.maximum(z, 1e-3)) < 0.7)
        idx = np.nonzero(vis)[0][:F]
        n = len(idx)
        u = cam.fx * p_c[idx, 0] / z[idx] + cam.cx
        v = cam.fy * p_c[idx, 1] / z[idx] + cam.cy

        def pad(a, fill, shape=()):
            full = np.full((F,) + shape, fill, np.float32)
            full[:n] = a
            return torch.from_numpy(full)

        desc = np.zeros((F, 8), np.uint32)
        desc[:n] = descs[idx]
        valid = torch.zeros(F, dtype=torch.bool)
        valid[:n] = True
        feats = Features(xy=pad(np.stack([u, v], -1), 0.0, (2,)), response=torch.zeros(F),
                         octave=torch.zeros(F, dtype=torch.int32), angle=torch.zeros(F),
                         desc=torch.from_numpy(desc.view(np.int32)), valid=valid,
                         u_right=pad(u - cam.bf / z[idx], -1.0), depth=pad(z[idx], -1.0))
        frame = FrameState(features=feats, T_cw=torch.from_numpy(drifted[i]),
                           point_cam=pad(p_c[idx], 0.0, (3,)), timestamp=torch.tensor(0.0))
        tracked = -np.ones(F, np.int32)
        tracked[:n] = np.where((i - last_seen[idx]) <= 3, slot_of_world[idx], -1)
        m, slot = ms.insert_keyframe(m, frame, torch.from_numpy(tracked), 20.0)
        slot = int(slot)
        slot_of_world[idx] = m.kf_obs_point[slot].numpy()[:n]
        last_seen[idx] = i
        words, kf_nodes = voc.transform(vocab, m.kf_desc[slot], m.kf_feat_valid[slot])
        db = add_keyframe(db, slot, voc.bow_vector(vocab, words))
        nodes = nodes.clone()
        nodes[slot] = kf_nodes
        out.append((m, db, nodes, slot))
    return cfg, out


def ring_closure():
    """The ring's map at the keyframe whose detection nominated the loop
    (the port's synchronous closer on the CPU), its database and node
    table, the nomination and the ring's truth, on the CPU."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing as lc

    cfg, steps = _ring_map()
    closer = lc.LoopCloser(cfg)
    closer.last_loop_kf_id = -100
    closer.defer_gba = True
    dets, inner = [], closer.harvest_detect
    closer.harvest_detect = lambda pending: dets.append(inner(pending)) or dets[-1]
    for m, db, nodes, slot in steps:
        if closer.on_keyframe(m, db, nodes, slot)[1]:
            break
    else:
        raise AssertionError("no loop closed on the ring")
    gt = [_ring_pose(i) for i in range(int(m.kf_valid.sum()))]
    return dict(cfg=cfg, map=m, db=db, nodes=nodes, det=tuple(int(x) for x in dets[-1]),
                gt=gt)


# the engine's GBA lifecycle on the ring's closure (tests/test_torch_multi_loop.py)
CHUNKS_BEFORE_PAUSE = 2        # step 2
CHUNKS_BEFORE_GROWTH = 1       # after step 4
N_OUTER = 10                   # IncrementalGBA's chunks a solve


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _kf_poses(m):
    return _host(m.kf_T_cw)[_host(m.kf_valid)]


def lifecycle(slam, c, split_key=None, pause_check=None):
    """The post-loop GBA's lifecycle that only the engine drives, on
    ``slam`` (either package's ``StereoSlam``) holding ``c``'s closure map:

    1. a valid verdict (``_dispatch_verify``, ``_try_harvest_loop``) starts
       the GBA;
    2. one chunk a frame (``_service_gba``), ``CHUNKS_BEFORE_PAUSE`` times;
    3. a second verification in flight pauses it (``pause_check()``, when
       given, calls ``_service_gba`` then and says whether it left the GBA
       where it stood);
    4. the second verdict replaces it; ``CHUNKS_BEFORE_GROWTH`` chunks;
    5. a capacity growth drops it;
    6. a third verdict starts one of the grown map's shapes;
    7. ``finish()`` drains it to its merge.

    Returns each verdict, the keyframe poses and capacity after it, the
    carry after each chunk and the final map, on the host.  ``split_key``
    is called before each verification (a test's set chain)."""
    rec = dict(verdicts=[], corrected=[], K=[], carries=[], gbas=[])

    def verify():
        if split_key is not None:
            split_key()
        slam._dispatch_verify(c["det"])

    def verdict():
        loops = slam.loops_closed
        slam._try_harvest_loop(force=True)
        rec["verdicts"].append(slam.loops_closed - loops)
        rec["corrected"].append(_kf_poses(slam.map))
        rec["K"].append(int(slam.map.kf_capacity))
        rec["gbas"].append(slam.pending_gba)

    def chunk():
        gba = slam.pending_gba
        slam._service_gba()
        rec["carries"].append(tuple(_host(x) for x in gba.carry))

    verify()                                          # 1
    verdict()
    for _ in range(CHUNKS_BEFORE_PAUSE):              # 2
        chunk()
    verify()                                          # 3
    if pause_check is not None:
        rec["paused"] = pause_check()
    verdict()                                         # 4
    for _ in range(CHUNKS_BEFORE_GROWTH):
        chunk()
    slam._occ = (slam.map.kf_capacity - 4, 0)         # 5
    slam._maybe_resize()
    rec["dropped"] = slam.pending_gba is None
    rec["grown"] = int(slam.map.kf_capacity)
    verify()                                          # 6
    verdict()
    rec["before_merge"] = _kf_poses(slam.map)
    last = slam.pending_gba
    slam.finish()                                     # 7
    rec["last_carry"] = tuple(_host(x) for x in last.carry)
    rec["iters_left"] = last.iters_left
    rec["final"] = _kf_poses(slam.map)
    rec["final_pts"] = _host(slam.map.pt_pos)[_host(slam.map.pt_valid)]
    rec["pending_after"] = slam.pending_gba
    return rec


def port_engine(c, device="cpu"):
    """The port's ``StereoSlam`` on ``device`` holding ``c``'s closure map."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing as lc
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod

    slam = slam_mod.StereoSlam(c["cfg"], enable_relocalization=False, device=device)
    slam.map, slam.db = _to(c["map"], device), _to(c["db"], device)
    slam.kf_nodes = c["nodes"].to(device)
    slam.loop_closer = lc.LoopCloser(c["cfg"], device)
    return slam


def pause_check(slam):
    """Step 3's check: ``_service_gba`` with a verification in flight leaves
    the GBA where it stood and makes no collective."""
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import collectives

    def check():
        gba, stats = slam.pending_gba, dict(collectives.STATS)
        iters = gba.iters_left
        slam._service_gba()
        return (slam.pending_gba is gba and gba.iters_left == iters
                and collectives.STATS == stats)

    return check


def _bits(x):
    if isinstance(x, np.ndarray):
        return (x.shape, x.dtype.str, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_bits(y) for y in x]
    return x


@pytest.mark.cuda
def test_loop_stages_on_card_equal_cpu(monkeypatch):
    """``chip_smoke.py`` phase 16's gates on the ring's closure: from the
    same map and the same RANSAC sets, ``compute_loop_transform`` finds the
    same pairs, verdict and counts and ``T_rel`` within 1e-3 on the card as on
    the CPU; ``correct_loop`` moves every keyframe within 1e-3 m and 1e-3 rad
    of the CPU's (the GBA chunk: the next test)."""
    _require_cuda()
    import chip_smoke
    from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing as lc

    c = ring_closure()                     # the synchronous closer on the CPU
    cfg, m, nodes = c["cfg"], c["map"], c["nodes"]
    cur, cur_id, cand, cand_id = c["det"]
    draw, pair_oks, sets = lc.sample_sets, [], []

    def fixed_sets(pair_ok, generator, *a):
        """The CPU's draw (generator seeded 7), given to the card too."""
        pair_oks.append(pair_ok.cpu())
        if not sets:
            sets.append(draw(pair_ok.cpu(), torch.Generator().manual_seed(7)))
        return sets[0].to(pair_ok.device)

    monkeypatch.setattr(lc, "sample_sets", fixed_sets)
    ref = lc.compute_loop_transform(m, nodes, cur, cand, None, cfg)
    out = lc.compute_loop_transform(_to(m, "cuda"), nodes.cuda(), cur, cand, None, cfg)
    assert torch.equal(pair_oks[0], pair_oks[1]) and int(pair_oks[0].sum()) >= 20
    assert [(bool(x.ok), int(x.n_inliers), int(x.n_total)) for x in (out, ref)][0] == \
        (bool(ref.ok), int(ref.n_inliers), int(ref.n_total))
    assert bool(ref.ok)
    assert float((out.T_rel.cpu() - ref.T_rel).abs().max()) < 1e-3

    c_ref = lc.correct_loop(m, cur, cand, ref.T_rel, ref.s_rel)
    c_out = lc.correct_loop(_to(m, "cuda"), cur, cand, ref.T_rel.cuda(), ref.s_rel.cuda())
    dt, dr = chip_smoke._pose_gap(c_out.kf_T_cw, c_ref.kf_T_cw, m.kf_valid.numpy())
    assert dt < 1e-3 and dr < 1e-3


def _ba_problem(n_poses=8, n_pts=600, seed=0):
    """A well-conditioned GBA problem: poses 1 m apart along z, points 5-40 m
    ahead of every pose and seen from all, stereo, 0.4 px noise, starts
    perturbed (one chunk takes the cost from 134747 to 2015, and summing the
    edges in another order moves its poses 5.5e-6)."""
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import lie
    from opendlv_perception_vision_orbslam2_tpu_torch.optim.ba import BAProblem

    rng = np.random.default_rng(seed)
    fx = fy = 320.0
    cx, cy, bf = 256.0, 128.0, 160.0
    pts = np.stack([rng.uniform(-8, 8, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(12, 40, n_pts)], -1).astype(np.float32)
    T = np.stack([np.eye(4, dtype=np.float32)] * n_poses)
    T[:, 2, 3] = -np.arange(n_poses, dtype=np.float32)
    p_c = pts[None] + T[:, None, :3, 3]
    u = fx * p_c[..., 0] / p_c[..., 2] + cx + rng.normal(0, 0.4, p_c.shape[:2])
    v = fy * p_c[..., 1] / p_c[..., 2] + cy + rng.normal(0, 0.4, p_c.shape[:2])
    ur = u - bf / p_c[..., 2]
    noise = torch.from_numpy((rng.standard_normal((n_poses, 6)) * 0.01).astype(np.float32))
    T0 = (lie.exp_se3(noise) @ torch.from_numpy(T)).numpy()
    T0[0] = T[0]
    E = n_poses * n_pts
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    prob = BAProblem(
        T_opt=f(T0), opt_valid=torch.ones(n_poses, dtype=torch.bool),
        T_fix=torch.eye(4)[None], fix_valid=torch.zeros(1, dtype=torch.bool),
        pts=f(pts + rng.normal(0, 0.05, pts.shape)), pt_valid=torch.ones(n_pts, dtype=torch.bool),
        e_kf=torch.arange(n_poses, dtype=torch.int32).repeat_interleave(n_pts),
        e_pt=torch.arange(n_pts, dtype=torch.int32).repeat(n_poses),
        e_uv=f(np.stack([u, v], -1).reshape(E, 2)), e_ur=f(ur.reshape(E)),
        e_sigma2=torch.ones(E), e_valid=torch.ones(E, dtype=torch.bool))
    return prob, dict(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf)


@pytest.mark.cuda
def test_gba_chunk_on_card_equals_cpu():
    """Phase 16's GBA gate on a small well-conditioned problem: one chunk
    (one LM iteration, 40 CG steps) from the same start, cost within 1e-3
    relative and poses within 1e-3 on the card and on the CPU.  (The loop
    ring's map is no place for this gate: one float32 chunk there moves
    its poses by 1.9e-4 when the edges are summed in another order and by
    4.8e-4 when every measured pixel moves by one ulp, and lands 6.4e-3
    from the float64 solve after its correction; see
    tests/test_torch_loop.py.)"""
    _require_cuda()
    import chip_smoke
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import gba

    prob, cam = _ba_problem()
    ref = gba.global_bundle_adjust_chunk(prob, gba.gba_init_carry(prob), **cam)
    cprob = _to(prob, "cuda")
    out = gba.global_bundle_adjust_chunk(cprob, gba.gba_init_carry(cprob), **cam)
    cost_ref, cost_out = float(ref[3]), float(out[3])
    assert abs(cost_out - cost_ref) < 1e-3 * abs(cost_ref)
    dt, dr = chip_smoke._pose_gap(out[0], ref[0], np.ones(len(ref[0]), bool))
    assert dt < 1e-3 and dr < 1e-3
    cost0 = float(gba.gba_core(prob, **cam, n_outer=0)[2])
    assert cost_ref < 0.5 * cost0


# ---- the RGB-D and mono slice: one-eye kernel cases, deterministic GBA sums, the
# repaired host syncs ------------------------------------------------------------


@pytest.mark.cuda
def test_one_eye_kernels_equal_plain_on_card():
    """The RGB-D and monocular front ends' kernel cases at KITTI size: one
    ``fast_nms_pyramid`` launch over the 8 levels of one eye, and one ORB
    atlas gather (N = 2000, and 2048 at the monocular initialization
    budget), bit for bit; no SAD gather."""
    _require_cuda()
    import chip_smoke
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import SystemConfig

    cfg = SystemConfig()
    cam = cfg.camera
    grays, depths, _, _ = synthetic.render_rgbd_sequence(cfg, n_frames=1, n_points=900, seed=0)
    levels, th, orb_job, mono_job = chip_smoke.record_one_eye(
        cfg, torch.from_numpy(grays[0]).cuda(), torch.from_numpy(depths[0]).cuda())
    assert len(levels) == 8 and levels[0].shape == (1, cam.height, cam.width)
    for t in (0.0, th, 20.0):
        before = fast_kernel.fast_nms_pyramid.launches
        maps = fast_kernel.fast_nms_pyramid(levels, t)
        assert fast_kernel.fast_nms_pyramid.launches == before + 1
        for lvl, (m, lv) in enumerate(zip(maps, levels)):
            assert torch.equal(m, fast_kernel.fast_nms_plain(lv, t)), f"level {lvl} th {t}"
    assert orb_job[1].shape[0] == 2000 and mono_job[1].shape[0] == 2048
    for job in (orb_job, mono_job):
        assert torch.equal(gather_kernel.gather_patches(*job),
                           gather_kernel.gather_patches_plain(*job))


@pytest.mark.cuda
def test_pose_graph_twice_bit_equal_on_card():
    """The pose graph's normal system sums in a fixed order
    (``block_order``), so the same problem solved twice on the card gives
    the same bits: 128 vertices, 1500 edges, many into each vertex (a float
    ``index_add`` there adds by atomics in arrival order)."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import lie
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import pose_graph as pg

    g = torch.Generator().manual_seed(0)
    K, E = 128, 1500
    T = lie.exp_se3(torch.randn((K, 6), generator=g) * 0.3)
    e_i, e_j = torch.randint(0, K, (E,), generator=g), torch.randint(0, K, (E,), generator=g)
    noise = lie.exp_se3(torch.randn((E, 6), generator=g) * 0.01)
    prob = pg.PoseGraphProblem(
        T=T, v_valid=torch.ones(K, dtype=torch.bool), v_fixed=torch.arange(K) == 0,
        e_i=e_i.to(torch.int32), e_j=e_j.to(torch.int32),
        e_T_ij=noise @ pg.relative_pose(T[e_i], T[e_j]), e_weight=torch.ones(E),
        e_valid=e_i != e_j)
    cprob = pg.PoseGraphProblem(*(None if x is None else x.cuda() for x in prob))
    a, b = pg.optimize_pose_graph(cprob, n_iters=5), pg.optimize_pose_graph(cprob, n_iters=5)
    assert torch.isfinite(a[0]).all()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_mapping_stage_twice_bit_equal_on_card():
    """One mapping stage (point cull, triangulation, fusion, the windowed
    descriptor and normal refresh, grid local BA, keyframe cull) run twice on
    the card from the same map gives the same bits: the point normals sum in
    a fixed order (``map_state.refresh_windowed``), where a float
    ``index_add`` adds by atomics in arrival order."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic

    cfg = _slam_cfg()
    lefts, rights, _, _ = synthetic.render_stereo_sequence(cfg, n_frames=16, n_points=500,
                                                           seed=5, step=0.25)
    slam = slam_mod.StereoSlam(cfg, enable_loop_closing=False, enable_relocalization=False,
                               device="cpu")
    slam.force_sync_decisions = True
    i = 0
    while slam.n_keyframes < 3 and i < 15:
        slam.process(lefts[i], rights[i], timestamp=i * 0.1)
        i += 1
    assert slam.n_keyframes >= 3
    m, slot = _to(slam.map, "cuda"), torch.tensor(slam.last_kf_slot, device="cuda")
    runs = [slam_mod.mapping_stage(m, slot, cfg, True, True, True, True) for _ in range(2)]
    for name, a, b in zip(m._fields, runs[0][0], runs[1][0]):
        assert torch.equal(a, b), name
    assert torch.equal(runs[0][1], runs[1][1])


_STAGE_MAP = {}


def _stage_map():
    """``(map, slot)`` on the card: test_mapping_stage_twice_bit_equal_on_card's
    map, built once on the CPU (3 keyframes, local BA behind it)."""
    if not _STAGE_MAP:
        from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
        from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic

        cfg = _slam_cfg()
        lefts, rights, _, _ = synthetic.render_stereo_sequence(cfg, n_frames=16, n_points=500,
                                                               seed=5, step=0.25)
        slam = slam_mod.StereoSlam(cfg, enable_loop_closing=False,
                                   enable_relocalization=False, device="cpu")
        slam.force_sync_decisions = True
        i = 0
        while slam.n_keyframes < 3 and i < 15:
            slam.process(lefts[i], rights[i], timestamp=i * 0.1)
            i += 1
        assert slam.n_keyframes >= 3
        _STAGE_MAP["m"] = (_to(slam.map, "cuda"),
                           torch.tensor(slam.last_kf_slot, device="cuda"))
    return _STAGE_MAP["m"]


def _mapping_counts(t0):
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import trace

    out = {}
    for r in trace.records(since_ns=t0):
        if isinstance(r, trace.Count) and r.name.startswith("mapping."):
            out[r.name] = out.get(r.name, 0) + r.n
    return out


def _assert_stage_equal(got, want):
    (m, aux), (m_ref, aux_ref) = got, want
    for name, a, b in zip(m_ref._fields, m, m_ref):
        assert (a is None and b is None) or torch.equal(a, b), name
    assert torch.equal(aux, aux_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("grown", [False, True], ids=["32kf", "128kf"])
@pytest.mark.parametrize("do_lba", [True, False], ids=["lba", "no_lba"])
def test_graphed_mapping_stage_equals_eager_on_card(grown, do_lba):
    """``mapping_stage`` on the card: the first call of a key runs eagerly,
    the second captures and replays, the third replays; each equals
    ``_mapping_stage_eager`` on every map field and ``aux`` with
    ``torch.equal``, in two capacity buckets and with local BA on and off."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.models import map_state
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod

    cfg = _slam_cfg()
    m, slot = _stage_map()
    if grown:
        m = map_state.grow_map(m, 4 * m.kf_capacity, 4 * m.pt_capacity)
    flags = (True, True, do_lba, True)
    slam_mod._GRAPHS.clear()
    slam_mod._SEEN.clear()
    want = slam_mod._mapping_stage_eager(m, slot, cfg, *flags)
    t0 = time.perf_counter_ns()
    runs = [slam_mod.mapping_stage(m, slot, cfg, *flags) for _ in range(3)]
    assert _mapping_counts(t0) == {"mapping.eager": 1, "mapping.graph_capture": 1,
                                   "mapping.graphed": 1}
    for got in runs:
        _assert_stage_equal(got, want)
    assert int(want[1][2]) > 100
    slam_mod._GRAPHS.clear()
    slam_mod._SEEN.clear()


@pytest.mark.cuda
def test_mapping_graphs_capture_once_a_key_and_keep_held_outputs_on_card():
    """What one replay returned is unchanged after a later replay of the
    same key from another map; a key is captured once, and the cache keeps
    the ``MAPPING_GRAPH_CACHE_SIZE`` most recently used keys."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod

    cfg = _slam_cfg()
    m, slot = _stage_map()
    flags = (True, True, True, True)
    slam_mod._GRAPHS.clear()
    slam_mod._SEEN.clear()
    t0 = time.perf_counter_ns()
    for _ in range(2):
        slam_mod.mapping_stage(m, slot, cfg, *flags)
    shift = torch.zeros(4, 4, device="cuda")
    shift[0, 3] = 0.01                      # every keyframe 1 cm along x
    m2 = m._replace(kf_T_cw=m.kf_T_cw + shift)
    first = slam_mod.mapping_stage(m, slot, cfg, *flags)
    held = [x.clone() for x in (*first[0], first[1])]
    second = slam_mod.mapping_stage(m2, slot, cfg, *flags)
    for name, a, b in zip(first[0]._fields + ("aux",), (*first[0], first[1]), held):
        assert torch.equal(a, b), name
    assert not torch.equal(first[0].kf_T_cw, second[0].kf_T_cw)
    _assert_stage_equal(second, slam_mod._mapping_stage_eager(m2, slot, cfg, *flags))
    assert _mapping_counts(t0) == {"mapping.eager": 1, "mapping.graph_capture": 1,
                                   "mapping.graphed": 2}
    n = slam_mod.MAPPING_GRAPH_CACHE_SIZE
    keys = [tuple(bool(k >> b & 1) for b in range(4)) for k in range(1, n + 1)]
    t0 = time.perf_counter_ns()
    for k in keys:
        for _ in range(2):
            slam_mod.mapping_stage(m, slot, cfg, *k)
    assert _mapping_counts(t0) == {"mapping.eager": n, "mapping.graph_capture": n}
    assert len(slam_mod._GRAPHS) == n
    assert {key[2] for key in slam_mod._GRAPHS} == set(keys)
    slam_mod._GRAPHS.clear()
    slam_mod._SEEN.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["blocked", "general"])
def test_gba_chunk_twice_bit_equal_on_card(layout):
    """The GBA's fixed-order sums: one chunk run twice on the card gives the
    same bits, on ``extract_global_ba``'s blocked layout and on the edges
    shuffled."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import gba

    prob, cam = _ba_problem()
    if layout == "general":
        perm = torch.from_numpy(np.random.default_rng(0).permutation(prob.e_kf.shape[0]))
        prob = prob._replace(**{f: getattr(prob, f)[perm] for f in prob._fields
                                if f.startswith("e_")})
    cprob = _to(prob, "cuda")
    sums = gba.edge_sums(cprob)
    runs = [gba.global_bundle_adjust_chunk(cprob, gba.gba_init_carry(cprob), **cam, sums=sums)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_repaired_sites_make_no_host_sync_on_card():
    """One SLAM frame's device programs on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: the image upload, the front
    end, the keyframe insert and the mapping stage (point allocation,
    fusion, local BA and keyframe culling write their dump slots by device
    fills) raise on any host sync."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.models.frontend import process_stereo
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic

    cfg = _slam_cfg()
    lefts, rights, _, _ = synthetic.render_stereo_sequence(cfg, n_frames=16, n_points=500,
                                                           seed=5, step=0.25)
    slam = slam_mod.StereoSlam(cfg, enable_loop_closing=False, enable_relocalization=False,
                               device="cuda")
    slam.force_sync_decisions = True
    i = 0
    while slam.n_keyframes < 3 and i < 15:
        slam.process(lefts[i], rights[i], timestamp=i * 0.1)
        i += 1
    assert slam.n_keyframes >= 3
    slot = torch.full((), slam.last_kf_slot, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        left, right = slam._to_device(lefts[i], 0), slam._to_device(rights[i], 1)
        cur = process_stereo(left, right, cfg, i * 0.1)
        m, new_slot, _, _ = slam_mod.insert_stage(slam.map, cur, slam.last_bindings, cfg)
        slam_mod.mapping_stage(m, new_slot, cfg, True, True, True, True)
        slam_mod.mapping_stage(slam.map, slot, cfg, True, True, True, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_remap_bilinear_on_card_equals_cpu():
    """The live ingest's rectification remap of a 512x256 frame, card
    against CPU, within 1e-3 grey levels, from the same float32 maps."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.ops import undistort

    R = undistort.rodrigues(torch.tensor([0.002, -0.001, 0.0015]))
    R1, _, (fx, fy, cx, cy), _ = undistort.stereo_rectify(
        R, torch.tensor([-0.5, 0.0, 0.0]), 320.0, 320.0, 256.0, 128.0, 320.0, 320.0, 256.0, 128.0)
    grid = undistort.build_rectify_map(256, 512, 320.0, 320.0, 256.0, 128.0, -0.05, 0.01, 1e-4,
                                       -2e-4, 0.0, R1, fx, fy, cx, cy)
    img = torch.from_numpy(_rand_img(256, 512, seed=4))
    out = undistort.remap_bilinear(img.cuda(), grid.cuda())
    ref = undistort.remap_bilinear(img, grid)
    assert float((out.cpu() - ref).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_selflocalization_track_makes_no_host_sync_on_card():
    """One ``Selflocalization.track`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: the engine's frame, the
    publisher's fetch of the pose and map size, and the sends of the frames
    whose fetch has landed raise on any host sync."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.models.selflocalization import (
        Selflocalization,
    )
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic

    cfg = _slam_cfg()
    lefts, rights, _, _ = synthetic.render_stereo_sequence(cfg, n_frames=10, n_points=500,
                                                           seed=5, step=0.25)
    sent = []
    od4 = type("Session", (), {"send": lambda self, m, timestamp=None: sent.append(m),
                               "close": lambda self: None})()
    sel = Selflocalization(cfg, od4=od4)
    for i in range(9):
        sel.track(lefts[i], rights[i], timestamp=i * 0.1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sel.track(lefts[9], rights[9], timestamp=0.9)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sel.shutdown()
    assert sel.frame_count == 10 and len(sel.map_sizes) == 10
    assert sum(type(m).__name__ == "Geolocation" for m in sent) == 10


@pytest.mark.cuda
def test_sharded_gba_chunk_two_ranks_on_card(tmp_path):
    """Two gloo ranks on ``cuda:0``, one edge-sharded GBA chunk of a small BA
    problem (``test_torch_parallel.ba_problem``): both ranks' carries bit for
    bit, and the poses within 1e-3 of the single-device chunk on the card
    (phase 16's card-vs-CPU bar for one chunk)."""
    _require_cuda()
    from test_torch_parallel import WORLD, ba_problem, launch

    rcs, logs = launch(tmp_path, "cuda_chunk", {"prob": ba_problem(0)})
    assert rcs == [0] * WORLD, "\n".join(logs)
    r0, r1 = (torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(WORLD))
    assert all(torch.equal(a, b) for a, b in zip(r0["carry"], r1["carry"]))
    assert float((r0["carry"][0] - r0["single"][0]).abs().max()) < 1e-3
    assert abs(float(r0["carry"][3]) - float(r0["single"][3])) <= 1e-3 * float(r0["single"][3])


# the 512x256 fixture's flags for the CLI (tests/test_torch_io.py's CLI_FLAGS)
_CLI_FLAGS = ["--Camera.fx=320", "--Camera.fy=320", "--Camera.cx=256", "--Camera.cy=128",
              "--Camera.bf=160", "--Camera.fps=10", "--width=512", "--height=256",
              "--ORBextractor.nFeatures=600", "--ORBextractor.nLevels=4"]


def _cli_on_ranks(tmp_path, monkeypatch, ranks, n=8):
    """``__main__.main`` over an ``n``-frame 512x256 KITTI directory on the
    card with ``ranks``: its exit code, its ``LocalRanks`` and the dumped
    poses, after checking that no group and no child process is left."""
    import multiprocessing

    import chip_smoke
    import torch.distributed as dist

    from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as cli
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import launch
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic

    lefts, rights, _, _ = synthetic.render_stereo_sequence(_slam_cfg(), n_frames=n,
                                                           n_points=500, seed=5, step=0.25)
    chip_smoke.write_kitti_dir(tmp_path, lefts, rights, 10.0)
    made = []

    class Kept(launch.LocalRanks):
        def __init__(self, plan):
            super().__init__(plan)
            made.append(self)

    monkeypatch.setattr(launch, "LocalRanks", Kept)
    rc = cli.main([f"--kittiPath={tmp_path}"] + _CLI_FLAGS, ranks=ranks)
    assert not dist.is_initialized() and multiprocessing.active_children() == []
    poses = chip_smoke.read_kitti_poses(tmp_path / "poses.txt")
    assert len(poses) == n and all(np.isfinite(T).all() for T in poses)
    return rc, made[0]


@pytest.mark.cuda
def test_cli_on_two_ranks_on_card(tmp_path, monkeypatch):
    """``main(..., ranks=2)``: two gloo ranks on ``cuda:0`` on a host with one
    card (NCCL refuses two ranks on one card), NCCL on ``cuda:0`` and
    ``cuda:1`` with more; exit 0, the worker served and exited 0, nothing
    left behind."""
    _require_cuda()
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import launch

    rc, ranks = _cli_on_ranks(tmp_path, monkeypatch, 2)
    want = launch.GLOO if torch.cuda.device_count() < 2 else launch.NCCL
    assert rc == 0 and ranks.plan.backend == want and ranks.exit_codes == [0]
    assert ranks.reports[1]["served"] > 0


@pytest.mark.cuda
def test_cli_on_every_card_over_nccl(tmp_path, monkeypatch):
    """The user's default on a host with several cards: one rank a card
    over NCCL, exit 0, every worker served and exited 0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices (NCCL takes one rank a card)")
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import launch

    rc, ranks = _cli_on_ranks(tmp_path, monkeypatch, None)
    d = torch.cuda.device_count()
    assert rc == 0 and ranks.plan.world == d and ranks.plan.backend == launch.NCCL
    assert ranks.exit_codes == [0] * (d - 1)
    assert all(ranks.reports[r]["served"] > 0 for r in range(1, d))


LIFECYCLE_FIELDS = ("verdicts", "K", "corrected", "carries", "before_merge", "last_carry",
                    "final", "final_pts")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_engine_started_sharded_gba_on_two_ranks_equals_witness(monkeypatch, backend):
    """The post-loop GBA started by a verdict inside ``StereoSlam`` on rank
    0 of two ranks on the card, its worker spawned by the CLI's launcher:
    gloo with both on ``cuda:0``, NCCL on ``cuda:0`` and ``cuda:1`` (two or
    more cards).  Over ``lifecycle`` (start, chunks, the pause, the
    replacing verdict, the growth drop, ``finish()``), each correction, every
    carry and the final map equal the split witness's on ``cuda:0`` bit for
    bit, and the worker served every init and chunk and exited 0."""
    _require_cuda()
    if backend == "nccl":
        _need_cards(2)
    import chip_smoke
    from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing as lc
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import launch

    c = ring_closure()
    draw = lc.sample_sets
    monkeypatch.setattr(lc, "sample_sets", lambda pair_ok, generator, *a: draw(
        pair_ok.cpu(), torch.Generator().manual_seed(7), *a).to(pair_ok.device))
    cuda0 = torch.device("cuda", 0)
    plan = (launch.RankPlan(2, launch.GLOO, (cuda0, cuda0)) if backend == "gloo"
            else launch.plan_ranks("cuda", 2, torch.cuda.device_count()))
    ranks = launch.LocalRanks(plan)
    with ranks as dev:
        slam = port_engine(c, dev)
        out = lifecycle(slam, c, pause_check=pause_check(slam))
    with chip_smoke.SplitWitness(c["cfg"].camera, 2):
        slam = port_engine(c, cuda0)
        witness = lifecycle(slam, c, pause_check=pause_check(slam))
    assert out["verdicts"] == [1, 1, 1] and out["paused"] and out["dropped"]
    assert all(g._sharded is not None for g in out["gbas"])
    for field in LIFECYCLE_FIELDS:
        assert _bits(out[field]) == _bits(witness[field]), field
    n_chunks = CHUNKS_BEFORE_PAUSE + CHUNKS_BEFORE_GROWTH + N_OUTER
    ops = ranks.reports[1]["ops"]
    assert ranks.exit_codes == [0]
    assert ops["gba_init"]["n"] == 3 and ops["gba_step"]["n"] == n_chunks


def _need_cards(n: int):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} or more CUDA devices (NCCL takes one rank a card)")


@pytest.mark.cuda
def test_cli_nccl_worker_killed_makes_main_raise(tmp_path, monkeypatch):
    """One rank a card: the last worker killed after frame 3 makes rank 0's
    next op raise (the launcher's watch thread writes ``serve/failed``),
    well within the group's timeout; the other workers are stopped and
    nothing is left behind.  Prints the seconds from the kill to the raise
    (run with -s)."""
    _need_cards(2)
    import multiprocessing
    import time

    import torch.distributed as dist

    import chip_smoke
    from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as cli
    from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as sel
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import launch
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic

    monkeypatch.setattr(launch, "GROUP_TIMEOUT_S", 30.0)
    lefts, rights, _, _ = synthetic.render_stereo_sequence(_slam_cfg(), n_frames=6,
                                                           n_points=500, seed=5, step=0.25)
    chip_smoke.write_kitti_dir(tmp_path, lefts, rights, 10.0)
    killed, made = [], []

    class Killing(sel.Selflocalization):
        def track(self, *args, **kwargs):
            if self.frame_count == 3:
                p = multiprocessing.active_children()[-1]
                p.kill()
                p.join()
                killed.append(time.monotonic())
            return super().track(*args, **kwargs)

    class Kept(launch.LocalRanks):
        def __init__(self, plan):
            super().__init__(plan)
            made.append(self)

    monkeypatch.setattr(sel, "Selflocalization", Killing)
    monkeypatch.setattr(launch, "LocalRanks", Kept)
    with pytest.raises(RuntimeError, match="ended during the run"):
        cli.main([f"--kittiPath={tmp_path}"] + _CLI_FLAGS)
    took = time.monotonic() - killed[0]
    print(f"\nNCCL, {made[0].plan.world} ranks: main raised {took:.2f} s after a worker was "
          f"killed (group timeout {launch.GROUP_TIMEOUT_S} s); worker exit codes "
          f"{made[0].exit_codes}")
    assert made[0].plan.backend == launch.NCCL and took < launch.GROUP_TIMEOUT_S
    assert sorted(made[0].exit_codes)[0] == -9 and sorted(made[0].exit_codes)[1:] == [0] * (
        len(made[0].exit_codes) - 1)
    assert not dist.is_initialized() and multiprocessing.active_children() == []


@pytest.mark.cuda
def test_cli_nccl_idle_live_session(monkeypatch):
    """One rank a card: a live session whose camera sends nothing for 2.5
    group timeouts tracks every frame and every rank exits 0 (NCCL's
    watchdog ends a collective that waits longer than the timeout; the
    workers wait in the store).  Prints the run's seconds (run with -s)."""
    _need_cards(2)
    import multiprocessing
    import time

    import torch.distributed as dist

    from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as cli
    from opendlv_perception_vision_orbslam2_tpu_torch.io import od4
    from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as sel
    from opendlv_perception_vision_orbslam2_tpu_torch.parallel import launch
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic

    timeout_s = 10.0
    monkeypatch.setattr(launch, "GROUP_TIMEOUT_S", timeout_s)
    monkeypatch.setattr(od4, "OD4Session", lambda *a, **k: od4.NullSession())   # no socket
    lefts, rights, _, _ = synthetic.render_stereo_sequence(_slam_cfg(), n_frames=5,
                                                           n_points=500, seed=5, step=0.25)
    frames = [(np.hstack([a, b]), 0.1 * i) for i, (a, b) in enumerate(zip(lefts, rights))]
    made, kept = [], []

    class Kept(launch.LocalRanks):
        def __init__(self, plan):
            super().__init__(plan)
            made.append(self)

    class Keeping(sel.Selflocalization):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    def paused():
        yield from frames[:2]
        time.sleep(2.5 * timeout_s)
        yield from frames[2:]

    monkeypatch.setattr(launch, "LocalRanks", Kept)
    monkeypatch.setattr(sel, "Selflocalization", Keeping)
    live = ["--cid=111", "--name=cam0", "--width=1024", "--height=256", "--bpp=24"] + [
        f for f in _CLI_FLAGS if not f.startswith(("--width", "--height"))]
    t = time.monotonic()
    assert cli.main(live, frames=paused()) == 0
    ranks = made[0]
    print(f"\nNCCL, {ranks.plan.world} ranks: a live session idle {2.5 * timeout_s:.0f} s "
          f"(group timeout {timeout_s} s) ended with exit 0 in {time.monotonic() - t:.1f} s; "
          f"worker exit codes {ranks.exit_codes}, ops served "
          f"{[r['served'] for r in ranks.reports.values()]}")
    assert ranks.plan.backend == launch.NCCL and ranks.exit_codes == [0] * (ranks.plan.world - 1)
    assert len(kept[0].slam.trajectory) == len(frames)
    assert all(r["served"] >= len(frames) - 1 for r in ranks.reports.values())
    assert not dist.is_initialized() and multiprocessing.active_children() == []


ROAD_SEED = 2147480006          # the road world the card once lost (ROADMAP.md §2, fault 2.1)
ROAD_FRAMES = 100
ROAD_FRAME = 82                 # published 12.03 m off then; 0.288 m on the CPU
ROAD_BOUND_M = 0.5


@pytest.mark.cuda
def test_the_road_world_is_tracked_on_card(monkeypatch):
    """``benchmark/traffic/road-explore.json``'s world of seed 2147480006 under
    ``benchmark/configs/kitti00-stereo.json`` (KITTI00-02.yaml's camera,
    2000 features, ORBvoc's shape of vocabulary), frames 0-99 through
    ``Selflocalization`` on the card as the benchmark hands them: no frame
    lost, and frame 82 within 0.5 m of the truth in the camera frame of the
    newest keyframe of the map it was published from, the CPU's bar (0.288
    m there).  While a deferred keyframe decision inserted the frame before
    the one its stats certified, the card lost frames 74-80 and 83-89 of this
    world and put frame 82 12.03 m off."""
    _require_cuda()
    import json
    import sys
    from pathlib import Path

    bench = Path(__file__).resolve().parent.parent / "benchmark"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    from harness import frames, vocab
    from reference import poses as ref

    from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as sel
    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_tpu_torch.models.vocabulary import (
        load_text_vocabulary,
    )
    from opendlv_perception_vision_orbslam2_tpu_torch.utils.config import (
        config_from_flags, parse_flags,
    )

    cfg = json.loads((bench / "configs" / "kitti00-stereo.json").read_text())
    traffic = json.loads((bench / "traffic" / "road-explore.json").read_text())
    cam = frames.camera_from_flags(cfg["flags"])
    seq = frames.Sequence(traffic, cam, ROAD_SEED)
    voc_path, _ = vocab.ensure(bench / "cache" / "vocab", cfg["vocabulary"])
    config = config_from_flags(parse_flags(list(cfg["flags"]) + [f"--vocFilePath={voc_path}"]))
    inserts = []            # (keyframe id, timestamp), read once the drive is over
    insert = slam_mod.insert_stage

    def noted(m, frame, bindings, config):
        inserts.append((m.next_kf_id, frame.timestamp))
        return insert(m, frame, bindings, config)

    monkeypatch.setattr(slam_mod, "insert_stage", noted)

    class Sink:
        def send(self, message, timestamp=None, sender_stamp=0):
            pass

        def close(self):
            pass

    pipe = sel.Selflocalization(config, od4=Sink(), vocab=load_text_vocabulary(str(voc_path)),
                                device="cuda")
    lost, at = [], None
    for i in range(ROAD_FRAMES):
        left, right = seq.frame(i)
        pipe.track(left, right, i / cam.fps)
        if pipe.slam.lost:
            lost.append(i)
        if i == ROAD_FRAME:
            m = pipe.slam.map
            at = (pipe.slam.T_cw, m.kf_valid, m.kf_id, m.kf_T_cw)
    pipe.slam.finish()
    assert not lost, lost
    T, valid, ids, T_kf = (x.cpu().numpy() for x in at)
    k = int(np.argmax(np.where(valid, ids, -1)))
    made_from = {int(kf_id): int(round(float(ts) * cam.fps)) for kf_id, ts in inserts}
    kf_frame = made_from[int(ids[k])]
    n = ref.pose_numbers([(ROAD_FRAME, ref.centre_of(T), ref.yaw_of(T))],
                         {ROAD_FRAME: (kf_frame, T_kf[k].astype(np.float64))},
                         lambda f: seq.pose(f))
    assert n["pose_rel_m"] < ROAD_BOUND_M, n
