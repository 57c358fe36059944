"""The port's loop-closing modules vs the reference package.

The same numpy inputs go through both packages: the Sim3 and log maps,
Horn's alignment, the essential-graph pose-graph solve, and loop detection,
verification and correction on ``test_loop_closing.py``'s drifted
26-keyframe ring (global BA: ``test_torch_gba.py``; the SLAM slice:
``test_torch_loop_slam.py``), and the pending-GBA fault on the ring's
closure: in the reference a verified correction is adopted while an older
GBA keeps stepping, and that GBA's merge writes its snapshot's poses back
over the correction; the port pauses GBA while a verification is in flight
and replaces it with one from the corrected map on a valid verdict (a
declined verdict lets it resume).  The Sim3 RANSAC sets are the reference's
(``jax.random.categorical`` from its ``PRNGKey(7)`` chain), injected through
``loop_closing.sample_sets``: torch cannot draw jax.random's bits.

Tolerances, and why:

- Lie maps: 2e-6 absolute on unit-scale inputs (float32 rounding of the same
  formulas); the Jacobians of the pose-graph residual 1e-5;
- Horn: R 1e-5, t 1e-4, s 1e-5.  The port takes the dominant eigenvector by
  repeated squaring where the reference calls ``eigh``: the two agree to
  float32 rounding unless the top two eigenvalues of N tie, where the
  eigenvector itself is undetermined; no set here has a relative gap below
  1e-3 (asserted);
- pose graph: poses 1e-4, scales 1e-5 (twenty float32 solves of the
  [7K, 7K] system, summed in another order);
- essential edges, detection (candidates, consistency groups, votes) and the
  Sim3 pipeline's pairs and counts: identical (integer distances and
  first-minimum ties).  BoW candidate scores within 1e-6: candidates whose
  covisibility-group sums tie in exact arithmetic are ordered by float32
  rounding (sums in another order) and may come in another order; where
  the ring test needs the reference's order it hands the port that order
  for tied scores only (``_reference_order``);
- the relative Sim3 ``T_rel`` 1e-4; corrected keyframe poses 1e-4, points
  1e-3 (a pose-graph solve and a point re-anchoring in float32); after the
  blocking global BA 5e-3 (see the ring test: float32 CG rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_loop_closing as ring
from opendlv_perception_vision_orbslam2_tpu.models import global_ba as jgba
from opendlv_perception_vision_orbslam2_tpu.models import loop_closing as jloop
from opendlv_perception_vision_orbslam2_tpu.models import map_state as jms
from opendlv_perception_vision_orbslam2_tpu.models import vocabulary as jvoc
from opendlv_perception_vision_orbslam2_tpu.models.kfdb import add_keyframe, empty_kfdb
from opendlv_perception_vision_orbslam2_tpu.ops import horn as jhorn
from opendlv_perception_vision_orbslam2_tpu.models import slam as jslam
from opendlv_perception_vision_orbslam2_tpu.ops import lie as jlie
from opendlv_perception_vision_orbslam2_tpu.optim import pose_graph as jpg
from opendlv_perception_vision_orbslam2_tpu_torch.models import global_ba as tgba
from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing as tloop
from opendlv_perception_vision_orbslam2_tpu_torch.models import map_state as tms
from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as tslam
from opendlv_perception_vision_orbslam2_tpu_torch.ops import horn as thorn
from opendlv_perception_vision_orbslam2_tpu_torch.ops import lie as tlie
from opendlv_perception_vision_orbslam2_tpu_torch.optim import pose_graph as tpg
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy

torch.set_num_threads(2)

TCFG = tconfig.SystemConfig(
    camera=tconfig.CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512,
                                height=256),
    orb=tconfig.OrbConfig(max_keypoints=512))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


class _KeyChain:
    """The reference ``LoopCloser``'s keys: ``PRNGKey(7)`` split on every
    dispatch that runs the geometric query and before every verification;
    :meth:`sample_sets` draws the Sim3 sets from the latest subkey."""

    def __init__(self):
        self.key, self.sub = jax.random.PRNGKey(7), None

    def split(self):
        self.key, self.sub = jax.random.split(self.key)

    def sample_sets(self, pair_ok, generator=None, n_hypotheses=tloop.N_SIM3_HYPOTHESES):
        w = jnp.asarray(pair_ok.cpu().numpy()).astype(jnp.float32)
        idx = jax.random.categorical(self.sub, jnp.log(w + 1e-9), shape=(n_hypotheses, 3))
        return torch.from_numpy(np.array(idx)).to(torch.int64)

    def follow(self, closer):
        """Advance with ``closer`` (the port's) where the reference's splits."""
        dispatch, harvest_detect = closer.dispatch, closer.harvest_detect

        def split_dispatch(*args):
            pend = dispatch(*args)
            if pend is not None and pend["run_geo"]:
                self.split()
            return pend

        def split_harvest(pending):
            det = harvest_detect(pending)
            if det is not None:
                self.split()
            return det

        closer.dispatch, closer.harvest_detect = split_dispatch, split_harvest


# ------------------------------------------------------------ Lie maps

@pytest.mark.parametrize("scale", [1e-5, 0.3, 1.5, 3.1])
def test_sim3_and_log_maps_match_reference(scale):
    """At angle magnitudes from the small-angle series to near pi."""
    rng = np.random.default_rng(int(scale * 100))
    z = rng.standard_normal((40, 7)).astype(np.float32)
    z[:, 3:6] *= scale / np.linalg.norm(z[:, 3:6], axis=1, keepdims=True)
    z[:, 6] *= 0.3
    z[:5, 6] = 1e-7                              # the sigma series branch
    R_j, t_j, s_j = jlie.exp_sim3(jnp.asarray(z))
    R_t, t_t, s_t = tlie.exp_sim3(_t(z))
    for out, ref in ((R_t, R_j), (t_t, t_j), (s_t, s_j)):
        _close(out, ref, 2e-6, 2e-6)
    R = np.asarray(R_j)
    _close(tlie.log_so3(_t(R)), jlie.log_so3(jnp.asarray(R)), 2e-6 if scale < 3 else 2e-4)
    T = np.asarray(jlie.exp_se3(jnp.asarray(z[:, :6])))
    _close(tlie.log_se3(_t(T)), jlie.log_se3(jnp.asarray(T)), 2e-5 if scale < 3 else 5e-4)
    t, s = np.asarray(t_j), np.asarray(s_j)
    inv_j = jlie.sim3_inverse(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s))
    inv_t = tlie.sim3_inverse(_t(R), _t(t), _t(s))
    comp_j = jlie.sim3_compose(*inv_j, jnp.asarray(R), jnp.asarray(t), jnp.asarray(s))
    comp_t = tlie.sim3_compose(*inv_t, _t(R), _t(t), _t(s))
    for out, ref in zip(inv_t + comp_t, inv_j + comp_j):
        _close(out, ref, 2e-6, 2e-6)
    pts = rng.standard_normal((40, 9, 3)).astype(np.float32) * 5
    _close(tlie.sim3_apply(_t(R), _t(t), _t(s), _t(pts)),
           jlie.sim3_apply(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s), jnp.asarray(pts)),
           2e-5, 2e-6)


def test_pose_graph_residual_jacobians_match_reference():
    rng = np.random.default_rng(1)
    T = np.asarray(jlie.exp_se3(jnp.asarray(rng.standard_normal((3, 6)).astype(np.float32))))
    s = np.array([1.0, 1.2, 0.9], np.float32)
    args_j = (jnp.asarray(T[0]), jnp.asarray(s[0]), jnp.asarray(T[1]), jnp.asarray(s[1]),
              jnp.asarray(T[2]), jnp.asarray(s[2]))
    for dx0 in (np.zeros(14, np.float32), 0.05 * rng.standard_normal(14).astype(np.float32)):
        J_i, J_j = jax.jacfwd(jpg.edge_residual, argnums=(0, 1))(
            jnp.asarray(dx0[:7]), jnp.asarray(dx0[7:]), *args_j)
        J = tpg.forward_jacobian(
            lambda d: tpg.edge_residual(d[..., :7], d[..., 7:], *map(_t, (T[0], s[0], T[1], s[1],
                                                                         T[2], s[2]))), _t(dx0))
        _close(J, np.concatenate([np.asarray(J_i), np.asarray(J_j)], axis=1), 1e-5, 1e-5)


# ------------------------------------------------------------ Horn

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_align_matches_reference(weighted, fix_scale):
    rng = np.random.default_rng(3 + weighted)
    n_sets, n = 64, 12
    a = rng.standard_normal((n_sets, n, 3)).astype(np.float32) * 4
    R = np.asarray(jlie.exp_so3(jnp.asarray(rng.standard_normal((n_sets, 3)).astype(np.float32))))
    b = (1.25 * np.einsum("bij,bnj->bni", R, a) + rng.standard_normal((n_sets, 1, 3)) * 3
         + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
    w = (rng.uniform(size=(n_sets, n)) < 0.6).astype(np.float32) if weighted else None
    ref = jhorn.horn_align(jnp.asarray(a), jnp.asarray(b), None if w is None else jnp.asarray(w),
                           fix_scale=fix_scale)
    out = thorn.horn_align(_t(a), _t(b), None if w is None else _t(w), fix_scale=fix_scale)
    for o, r, tol in zip(out, ref, (1e-5, 1e-4, 1e-5)):
        _close(o, r, tol, tol)
    # no near-degenerate set: the top two eigenvalues of N are apart
    M = np.einsum("bn,bni,bnj->bij", np.ones((n_sets, n)) if w is None else w,
                  a - a.mean(1, keepdims=True), b - b.mean(1, keepdims=True))
    ev = np.linalg.eigvalsh(np.stack([_horn_n(x) for x in M]))
    assert np.all((ev[:, -1] - ev[:, -2]) > 1e-3 * np.abs(ev).max(axis=1))


def _horn_n(S):
    return np.array([
        [S[0, 0] + S[1, 1] + S[2, 2], S[1, 2] - S[2, 1], S[2, 0] - S[0, 2], S[0, 1] - S[1, 0]],
        [S[1, 2] - S[2, 1], S[0, 0] - S[1, 1] - S[2, 2], S[0, 1] + S[1, 0], S[2, 0] + S[0, 2]],
        [S[2, 0] - S[0, 2], S[0, 1] + S[1, 0], -S[0, 0] + S[1, 1] - S[2, 2], S[1, 2] + S[2, 1]],
        [S[0, 1] - S[1, 0], S[2, 0] + S[0, 2], S[1, 2] + S[2, 1], -S[0, 0] - S[1, 1] + S[2, 2]]])


def test_horn_zero_weights_take_the_last_basis_vector():
    """No weight at all: the quaternion LAPACK's eigh returns for a zero N."""
    a = np.random.default_rng(0).standard_normal((2, 5, 3)).astype(np.float32)
    ref = jhorn.horn_align(jnp.asarray(a), jnp.asarray(a), jnp.zeros((2, 5)))
    out = thorn.horn_align(_t(a), _t(a), torch.zeros(2, 5))
    _close(out[0], ref[0], 1e-6)


# ------------------------------------------------------------ pose graph

def _circle_problem():
    """``tests/test_pose_graph.py``'s drifted circle."""
    from test_pose_graph import _circle_poses

    n = 24
    gt = _circle_poses(n)
    rng = np.random.default_rng(0)
    drifted = [gt[0]]
    for i in range(1, n):
        noise = jlie.exp_se3(jnp.asarray((rng.standard_normal(6) * np.array(
            [0.02, 0.02, 0.02, 0.004, 0.004, 0.004])).astype(np.float32)))
        drifted.append((np.asarray(noise) @ (gt[i] @ np.linalg.inv(gt[i - 1]))
                        @ drifted[-1]).astype(np.float32))
    e_T = [drifted[i] @ np.linalg.inv(drifted[i - 1]) for i in range(1, n)]
    e_T.append(gt[n - 1] @ np.linalg.inv(gt[0]))
    return _graph(np.stack(drifted), list(range(1, n)) + [n - 1], list(range(n - 1)) + [0],
                  e_T, [1.0] * (n - 1) + [5.0], None), dict(n_iters=15)


def _mono_problem():
    """``tests/test_loop_closing.py``'s monocular Sim3 case (scale drift)."""
    n = 20
    gt = [ring._gt_pose(i) for i in range(n)]
    drifted, scale_acc = [gt[0]], 1.0
    for i in range(1, n):
        rel = gt[i] @ np.linalg.inv(gt[i - 1])
        scale_acc *= 1.015
        rel[:3, 3] *= scale_acc
        drifted.append((rel @ drifted[-1]).astype(np.float32))
    e_T = [drifted[i] @ np.linalg.inv(drifted[i - 1]) for i in range(1, n)]
    e_T.append(gt[n - 1] @ np.linalg.inv(gt[0]))
    return _graph(np.stack(drifted), list(range(1, n)) + [n - 1], list(range(n - 1)) + [0],
                  e_T, [1.0] * (n - 1) + [5.0], [1.0] * (n - 1) + [scale_acc]), dict(
        n_iters=25, fix_scale=False)


def _graph(T_n, e_i, e_j, e_T, e_w, e_s):
    K, n = 32, T_n.shape[0]
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:n] = T_n
    v_valid = np.arange(K) < n
    return jpg.PoseGraphProblem(
        T=jnp.asarray(T), v_valid=jnp.asarray(v_valid), v_fixed=jnp.asarray(np.arange(K) == 0),
        e_i=jnp.asarray(e_i, jnp.int32), e_j=jnp.asarray(e_j, jnp.int32),
        e_T_ij=jnp.asarray(np.stack(e_T).astype(np.float32)),
        e_weight=jnp.asarray(e_w, jnp.float32), e_valid=jnp.ones((len(e_i),), bool),
        e_s_ij=None if e_s is None else jnp.asarray(e_s, jnp.float32))


@pytest.mark.parametrize("make", [_circle_problem, _mono_problem])
def test_optimize_pose_graph_matches_reference(make):
    prob, kw = make()
    T_ref, s_ref = jpg.optimize_pose_graph(prob, **kw)
    T_out, s_out = tpg.optimize_pose_graph(from_jax_numpy(_np_tree(prob)), **kw)
    _close(T_out, T_ref, 1e-4)
    _close(s_out, s_ref, 1e-5)
    moved = np.abs(np.asarray(T_ref) - np.asarray(prob.T)).max()
    assert moved > 0.1      # the solve did correct something
    _close(tpg.relative_pose(_t(prob.T[3]), _t(prob.T[4])),
           jpg.relative_pose(prob.T[3], prob.T[4]), 1e-6)


def test_pose_graph_block_sums_match_index_add():
    """The normal system's fixed-order sums (``block_order`` /
    ``block_sum``) against the ``index_add`` calls they replace, bit for
    bit on the CPU: each edge's four blocks and the diagonal floor, vertices
    shared by many edges."""
    g = torch.Generator().manual_seed(0)
    K, E, D = 9, 60, tpg.D
    e_i, e_j = torch.randint(0, K, (E,), generator=g), torch.randint(0, K, (E,), generator=g)
    blocks = [torch.randn((E, D, D), generator=g) for _ in range(4)]
    diag = torch.randn((K, D, D), generator=g)
    diag_at = torch.arange(K) * (K + 1)
    targets = [e_i * K + e_i, e_j * K + e_j, e_i * K + e_j, e_j * K + e_i, diag_at]
    ref = torch.zeros((K * K, D, D))
    for t, v in zip(targets, blocks + [diag]):
        ref = ref.index_add(0, t, v)
    out = tpg.block_sum(torch.cat(blocks + [diag]), *tpg.block_order(torch.cat(targets), K * K))
    assert torch.equal(out, ref)
    rows = [torch.randn((E, D), generator=g) for _ in range(2)]
    ref = torch.zeros((K, D)).index_add(0, e_i, rows[0]).index_add(0, e_j, rows[1])
    out = tpg.block_sum(torch.cat(rows), *tpg.block_order(torch.cat([e_i, e_j]), K))
    assert torch.equal(out, ref)


def test_singular_pose_graph_gives_a_zero_step():
    """A system with a free vertex and no edge is singular (up to the 1e-6
    floor); a NaN measurement makes the step non-finite: both are zeroed,
    nothing raises."""
    prob, _ = _circle_problem()
    e_T = np.array(prob.e_T_ij)
    e_T[0, 0, 3] = np.nan
    out = tpg.optimize_pose_graph(from_jax_numpy(_np_tree(prob._replace(e_T_ij=e_T))),
                                  n_iters=2)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(prob.T))


# ------------------------------------------------------------ the ring

@pytest.fixture(scope="module")
def ring_run():
    """The reference's synchronous loop closer over the drifted ring of
    ``test_loop_closing_corrects_drift``, to its closure: per keyframe the
    inputs to ``on_keyframe``, the detection verdict and the consistency
    groups right after detection; at the closure the key the verification drew with."""
    pts, descs = ring._ring_world()
    vocab = jvoc.train_vocabulary(descs, branching=8, levels=3, seed=1)
    gt = [ring._gt_pose(i) for i in range(ring.N_KF)]
    bias = np.asarray(jlie.exp_se3(jnp.asarray(np.array([0.01, 0, 0.01, 0, 0.004, 0],
                                                        np.float32))))
    drifted = [gt[0]]
    for i in range(1, ring.N_KF):
        drifted.append((bias @ (gt[i] @ np.linalg.inv(gt[i - 1])) @ drifted[-1])
                       .astype(np.float32))
    F = ring.F
    m = jms.empty_map(32, 32768, F)
    db = empty_kfdb(32, vocab.n_words)
    kf_nodes = -jnp.ones((32, F), jnp.int32)
    closer = jloop.LoopCloser(ring.CFG)
    closer.last_loop_kf_id = -100
    dets, keys = [], []
    inner_detect, inner_verify = closer.harvest_detect, jloop.verify_and_apply

    def record_detect(pending):
        det = inner_detect(pending)
        dets.append((det, [set(g) for g in closer.prev_groups], list(closer.prev_counts)))
        return det

    def record_verify(*args):
        keys.append(args[6])
        return inner_verify(*args)

    closer.harvest_detect = record_detect
    jloop.verify_and_apply = record_verify
    steps = []
    slot_of_world = -np.ones(len(pts), np.int64)
    last_seen = np.full(len(pts), -100)
    try:
        for i in range(ring.N_KF):
            frame, idx = ring._frame_for(gt[i], drifted[i], pts, descs)
            tracked = -np.ones(F, np.int32)
            fresh = (i - last_seen[idx]) <= 3
            tracked[: len(idx)] = np.where(fresh, slot_of_world[idx], -1)
            m, slot = jms.insert_keyframe(m, frame, jnp.asarray(tracked), 20.0)
            slot_of_world[idx] = np.asarray(m.kf_obs_point[slot])[: len(idx)]
            last_seen[idx] = i
            words, nodes = jvoc.transform(vocab, m.kf_desc[slot], m.kf_feat_valid[slot])
            db = add_keyframe(db, slot, jvoc.bow_vector(vocab, words))
            kf_nodes = kf_nodes.at[slot].set(nodes)
            n_dets = len(dets)
            inputs = _np_tree((m, db, kf_nodes)), int(slot)
            m, closed, _ = closer.on_keyframe(m, db, kf_nodes, int(slot))
            det, groups, counts = (dets[n_dets] if len(dets) > n_dets else
                                   (None, [set(g) for g in closer.prev_groups],
                                    list(closer.prev_counts)))
            steps.append(dict(inputs=inputs, det=det, groups=groups, counts=counts,
                              closed=closed))
            if closed:
                break
    finally:
        jloop.verify_and_apply = inner_verify
    assert steps[-1]["closed"], "the reference closed no loop"
    return steps, _np_tree(m), keys


def _reference_order(out, ref):
    """The port's ``loop_candidates`` output in the reference's order, after
    checking that only scores tied within 1e-6 are ordered differently."""
    c_out, s_out = (x.numpy() for x in out)
    c_ref, s_ref = (np.asarray(x) for x in ref)
    _close(s_out, s_ref, 1e-6)
    for c in set(c_out) | set(c_ref):
        if c >= 0:
            assert c in c_ref and c in c_out and abs(
                s_out[list(c_out).index(c)] - s_ref[list(c_ref).index(c)]) <= 1e-6
    return torch.from_numpy(c_ref.astype(np.int64)), out[1]


def _port_inputs(step):
    (m, db, nodes), slot = step["inputs"]
    return from_jax_numpy(m), from_jax_numpy(db), _t(nodes), slot


def test_loop_closer_matches_reference_over_the_ring(ring_run, monkeypatch):
    """Keyframe by keyframe from the reference's inputs: the same
    nominations, consistency groups and counts, the closure at the same
    keyframe with the same candidate, and the same corrected map (after the
    blocking 10-iteration global BA both closers run)."""
    steps, m_ref, _ = ring_run
    chain = _KeyChain()
    monkeypatch.setattr(tloop, "sample_sets", chain.sample_sets)
    inner, ref = tloop.loop_candidates, {}
    monkeypatch.setattr(tloop, "loop_candidates",
                        lambda *args: _reference_order(inner(*args), ref["out"]))
    closer = tloop.LoopCloser(TCFG)
    closer.last_loop_kf_id = -100
    chain.follow(closer)
    for i, step in enumerate(steps):
        m, db, nodes, slot = _port_inputs(step)
        (jm, jdb, _), _ = step["inputs"]
        ref["out"] = jloop.loop_candidates(jax.tree.map(jnp.asarray, jm),
                                           jax.tree.map(jnp.asarray, jdb), slot)
        pending = closer.dispatch(m, db, nodes, slot, int(m.kf_id[slot]))
        det = None if pending is None else closer.harvest_detect(pending)
        assert det == step["det"], f"keyframe {i}"
        assert closer.prev_groups == step["groups"] and closer.prev_counts == step["counts"]
    assert det is not None
    kf_slot, kf_id, cand_slot, cand_id = det
    m2, valid, _, _ = tloop.verify_and_apply(m, nodes, kf_slot, cand_slot, kf_id, cand_id,
                                             closer.generator, TCFG, True)
    assert bool(valid)
    from opendlv_perception_vision_orbslam2_tpu_torch.models.global_ba import run_global_ba

    m2 = run_global_ba(m2, TCFG, n_outer=10)
    # 5e-3: from the same corrected map, one float32 LM iteration (40 CG
    # steps on this ring's ill-conditioned reduced system) lands 4.4e-3
    # (reference) and 6.4e-3 (port) from the float64 solve, 2.5e-3 from
    # each other; over the 10 iterations the gap stays at 0.8-7.2e-3 and
    # ends at 1.4e-3
    _close(m2.kf_T_cw, m_ref.kf_T_cw, 5e-3)
    np.testing.assert_array_equal(m2.loop_valid.numpy(), m_ref.loop_valid)
    np.testing.assert_array_equal(m2.covis.numpy(), m_ref.covis)


def test_loop_queries_match_reference(ring_run):
    """``loop_min_score``, ``loop_candidates`` and the geometric vote at
    every keyframe of the ring."""
    steps, _, _ = ring_run
    for i, step in enumerate(steps):
        (m, db, _), slot = step["inputs"]
        jm, jdb = jax.tree.map(jnp.asarray, m), jax.tree.map(jnp.asarray, db)
        tm, tdb = from_jax_numpy(m), from_jax_numpy(db)
        _close(tloop.loop_min_score(tm, tdb, slot), jloop.loop_min_score(jm, jdb, slot), 1e-6)
        _reference_order(tloop.loop_candidates(tm, tdb, slot),
                         jloop.loop_candidates(jm, jdb, slot))
        n_ref, o_ref = jloop._geometric_loop_query(jm, slot, jax.random.PRNGKey(0), ring.CFG)
        n_out, o_out = tloop._geometric_loop_query(tm, slot, TCFG)
        assert (int(n_out), int(o_out)) == (int(n_ref), int(o_ref)), f"kf {i}"


@pytest.fixture(scope="module")
def closure(ring_run):
    """The closure keyframe's inputs, the verification's key and sets."""
    steps, _, keys = ring_run
    (m, db, nodes), _ = steps[-1]["inputs"]
    return m, nodes, steps[-1]["det"], keys[-1]


def _sets_of(key):
    chain = _KeyChain()
    chain.sub = key
    return chain.sample_sets


def test_compute_loop_transform_matches_reference(closure, monkeypatch):
    m, nodes, (cur, _, cand, _), key = closure
    ref = jloop.compute_loop_transform(jax.tree.map(jnp.asarray, m), jnp.asarray(nodes), cur,
                                       cand, key, ring.CFG, True)
    monkeypatch.setattr(tloop, "sample_sets", _sets_of(key))
    out = tloop.compute_loop_transform(from_jax_numpy(m), _t(nodes), cur, cand, None, TCFG)
    assert bool(out.ok) and bool(ref.ok)
    assert type(from_jax_numpy(_np_tree(ref))) is tloop.LoopMatch
    assert int(out.n_inliers) == int(ref.n_inliers) >= tloop.MIN_LOOP_INLIERS
    assert int(out.n_total) == int(ref.n_total) >= tloop.MIN_LOOP_TOTAL
    _close(out.T_rel, ref.T_rel, 1e-4)
    _close(out.s_rel, ref.s_rel, 1e-6)
    # the opposite side of the ring declines on both
    far = (cur + len(m.kf_valid) // 2) % 20
    ref2 = jloop.compute_loop_transform(jax.tree.map(jnp.asarray, m), jnp.asarray(nodes), cur,
                                        far, key, ring.CFG, True)
    out2 = tloop.compute_loop_transform(from_jax_numpy(m), _t(nodes), cur, far, None, TCFG)
    assert not bool(ref2.ok) and not bool(out2.ok)
    assert (int(out2.n_inliers), int(out2.n_total)) == (int(ref2.n_inliers), int(ref2.n_total))


def test_sim3_gn_refine_matches_reference():
    """The Gauss-Newton Sim3 refine, scale fixed and free, from a perturbed
    start on exact pairs."""
    rng = np.random.default_rng(5)
    x_b = (rng.standard_normal((60, 3)) * [3, 1, 2] + [0, 0, 9]).astype(np.float32)
    R = np.asarray(jlie.exp_so3(jnp.asarray(np.array([0.02, -0.05, 0.03], np.float32))))
    t = np.array([0.3, -0.1, 0.4], np.float32)
    x_a = (1.1 * x_b @ R.T + t).astype(np.float32)
    cam = ring.CAM
    proj = lambda x: np.stack([cam.fx * x[:, 0] / x[:, 2] + cam.cx,  # noqa: E731
                               cam.fy * x[:, 1] / x[:, 2] + cam.cy], -1).astype(np.float32)
    w = (rng.uniform(size=60) < 0.8).astype(np.float32)
    R0 = np.asarray(jlie.exp_so3(jnp.asarray(np.array([0.03, -0.04, 0.02], np.float32))))
    for fix_scale in (True, False):
        args = (x_b, x_a, proj(x_a), proj(x_b), w, R0, np.array([0.2, 0.0, 0.5], np.float32),
                np.float32(1.0))
        ref = jloop._sim3_gn_refine(*map(jnp.asarray, args), cam, fix_scale)
        out = tloop._sim3_gn_refine(*map(_t, args), cam, fix_scale)
        for o, r in zip(out, ref):
            _close(o, r, 2e-5, 2e-5)


def test_essential_edges_and_loop_edge_match_reference(closure):
    m, _, (cur, _, cand, _), _ = closure
    T_loop = np.asarray(jlie.exp_se3(jnp.asarray(np.array([0.1, 0, 0.2, 0, 0.03, 0],
                                                          np.float32))))
    jm = jax.tree.map(jnp.asarray, m)
    # one stored loop edge from an earlier closure joins the graph
    jm = jms.add_loop_edge(jm, jnp.asarray(3, jnp.int32), jnp.asarray(1, jnp.int32),
                           jnp.asarray(T_loop), jnp.asarray(1.0))
    tm = tms.add_loop_edge(from_jax_numpy(m), 3, 1, _t(T_loop), 1.0)
    for f in ("loop_i", "loop_j", "loop_valid", "loop_T", "loop_s"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), f)
    ref = jloop.build_essential_edges(jm, jnp.asarray(cur), jnp.asarray(cand),
                                      jnp.asarray(T_loop), jnp.asarray(1.0))
    out = tloop.build_essential_edges(tm, cur, cand, _t(T_loop), torch.tensor(1.0))
    for f in ("e_i", "e_j", "e_valid"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), f)
    for f in ("e_T", "e_s", "e_w"):   # e_T: products of 4x4s in another order
        _close(getattr(out, f), getattr(ref, f), 1e-5, msg=f)
    assert int(np.asarray(ref.e_valid)[5 * 32:-1].sum()) == 1   # the stored edge is live


@pytest.mark.parametrize("density", [0.05, 0.6])
def test_essential_edges_static_nonzero_matches_reference(density):
    """Strong covisibility edges taken by the static-shape stable sort: the
    first 4K of the upper triangle in row-major order, (0, 0) padding, with
    fewer (density 0.05) and more (0.6: truncated) than 4K strong pairs, and
    keyframe slots out of id order with holes."""
    K = 32
    rng = np.random.default_rng(int(density * 100))
    m = _np_tree(jms.empty_map(K, 64, 8))
    covis = np.where(rng.uniform(size=(K, K)) < density, rng.integers(100, 300, (K, K)),
                     rng.integers(0, 50, (K, K))).astype(np.int32)
    kf_valid = rng.uniform(size=K) < 0.8
    kf_id = np.where(kf_valid, rng.permutation(K), -1).astype(np.int32)
    T = np.asarray(jlie.exp_se3(jnp.asarray(rng.standard_normal((K, 6)).astype(np.float32))))
    m = m._replace(covis=covis + covis.T, kf_valid=kf_valid, kf_id=kf_id, kf_T_cw=T)
    T_loop = T[2] @ np.linalg.inv(T[5])
    ref = jloop.build_essential_edges(jax.tree.map(jnp.asarray, m), jnp.asarray(5),
                                      jnp.asarray(2), jnp.asarray(T_loop), jnp.asarray(1.0))
    out = tloop.build_essential_edges(from_jax_numpy(m), 5, 2, _t(T_loop), torch.tensor(1.0))
    for f in ("e_i", "e_j", "e_valid"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), f)
    _close(out.e_T, ref.e_T, 1e-5)
    n_strong = int(np.asarray(ref.e_valid)[K:5 * K].sum())
    assert (n_strong == 4 * K) == (density > 0.5) and n_strong > 0


def test_correct_loop_matches_reference(closure):
    m, nodes, (cur, _, cand, _), key = closure
    lm = jloop.compute_loop_transform(jax.tree.map(jnp.asarray, m), jnp.asarray(nodes), cur,
                                      cand, key, ring.CFG, True)
    ref = jloop.correct_loop(jax.tree.map(jnp.asarray, m), cur, cand, lm.T_rel, lm.s_rel)
    out = tloop.correct_loop(from_jax_numpy(m), cur, cand, _t(lm.T_rel), _t(lm.s_rel))
    _close(out.kf_T_cw, ref.kf_T_cw, 1e-4)
    _close(out.pt_pos, ref.pt_pos, 1e-3)
    np.testing.assert_array_equal(out.covis.numpy(), np.asarray(ref.covis))
    assert np.abs(np.asarray(ref.kf_T_cw) - m.kf_T_cw).max() > 0.1


@pytest.mark.parametrize("expect_ok", [True, False])
def test_verify_and_apply_matches_reference(closure, expect_ok, monkeypatch):
    """The closure verifies and applies on both; with a stale candidate id
    (its slot recycled) neither applies and the map comes back unchanged."""
    m, nodes, (cur, cur_id, cand, cand_id), key = closure
    cand_id = cand_id if expect_ok else cand_id + 1
    ref = jloop.verify_and_apply(jax.tree.map(jnp.asarray, m), jnp.asarray(nodes), cur, cand,
                                 cur_id, cand_id, key, ring.CFG, True)
    monkeypatch.setattr(tloop, "sample_sets", _sets_of(key))
    tm = from_jax_numpy(m)
    out = tloop.verify_and_apply(tm, _t(nodes), cur, cand, cur_id, cand_id, None, TCFG)
    assert bool(out[1]) == bool(ref[1]) == expect_ok
    for f in tm._fields:
        o, r = getattr(out[0], f), getattr(ref[0], f)
        if f in ("kf_T_cw", "pt_pos", "loop_T"):
            _close(o, r, 1e-3 if f == "pt_pos" else 1e-4, msg=f)
        else:
            o = o.numpy().view(np.uint32) if f in ("kf_desc", "pt_desc") else o.numpy()
            np.testing.assert_array_equal(o, np.asarray(r), err_msg=f)
    _close(out[2], ref[2], 0)
    _close(out[3], ref[3], 1e-4)
    if not expect_ok:
        for f in tm._fields:
            assert torch.equal(getattr(out[0], f), getattr(tm, f)), f


# ------------------------------------------------------------ pending GBA

@pytest.mark.parametrize("valid", [True, False])
def test_pending_gba_does_not_undo_a_correction(closure, valid, monkeypatch):
    """A verified correction dispatched while an older GBA is one chunk from
    its merge.  Reference order: the GBA steps and merges during the
    verification and writes its snapshot's pre-correction pose back over the
    corrected keyframe.  The port: no GBA step or merge while the verdict is
    in flight; the valid verdict replaces the old GBA with one from the
    corrected map, whose merge keeps the correction and lands where the
    reference's GBA from its corrected map lands (1e-2: ten float32 CG
    chunks on the ring, ``test_torch_gba.py``).  With a declined verdict (a
    stale candidate id) nothing is corrected and the old GBA resumes and
    merges on both."""
    JRING = ring.CFG
    m_np, nodes, (cur, cur_id, cand, cand_id), key = closure
    cand_id = cand_id if valid else cand_id + 1
    det = (cur, cur_id, cand, cand_id)

    # the reference's order
    jm = jax.tree.map(jnp.asarray, m_np)
    ref = jslam.StereoSlam(JRING, enable_relocalization=False)
    ref.map, ref.kf_nodes = jm, jnp.asarray(nodes)
    ref.loop_closer = jloop.LoopCloser(JRING)
    ref.loop_closer.key = jax.random.PRNGKey(7)
    old = jgba.IncrementalGBA(jm, JRING, n_outer_total=2, sharded=False)
    old.step()
    ref.pending_gba = old
    ref._dispatch_verify(det)
    m_corrected_ref = ref.map
    T_corrected_ref = np.asarray(m_corrected_ref.kf_T_cw[cur])
    ref._service_gba()                                # the old GBA merges now
    T_after_ref = np.asarray(ref.map.kf_T_cw[cur])
    ref._try_harvest_loop(force=True)

    # the port
    first_key = jax.random.split(jax.random.PRNGKey(7))[1]   # the closer's first subkey
    monkeypatch.setattr(tloop, "sample_sets", _sets_of(first_key))
    tm = from_jax_numpy(m_np)
    slam = tslam.StereoSlam(TCFG, enable_relocalization=False, device="cpu")
    slam.map, slam.kf_nodes = tm, torch.from_numpy(np.array(nodes))
    slam.loop_closer = tloop.LoopCloser(TCFG)
    old_t = tgba.IncrementalGBA(tm, TCFG, n_outer_total=2)
    old_t.step()
    slam.pending_gba = old_t
    slam._dispatch_verify(det)
    T_corrected = slam.map.kf_T_cw[cur].numpy()
    slam._service_gba()                               # paused: the verdict is in flight
    assert slam.pending_gba is old_t and old_t.iters_left == 1
    np.testing.assert_array_equal(slam.map.kf_T_cw[cur].numpy(), T_corrected)
    slam._try_harvest_loop(force=True)
    np.testing.assert_allclose(T_corrected, T_corrected_ref, atol=1e-4)

    moved = np.linalg.norm(T_corrected[:3, 3] - m_np.kf_T_cw[cur][:3, 3])
    if valid:
        assert moved > 0.2                            # the correction is real
        # reference: the old GBA's merge undid it
        assert np.linalg.norm(T_after_ref[:3, 3] - T_corrected_ref[:3, 3]) > 0.5 * moved
        assert np.linalg.norm(T_after_ref[:3, 3] - m_np.kf_T_cw[cur][:3, 3]) < 0.5 * moved
        # port: a new GBA from the corrected map; its merge keeps the correction
        assert slam.loops_closed == 1 and slam.pending_gba is not old_t
        while slam.pending_gba is not None:
            slam._service_gba()
        T_final = slam.map.kf_T_cw[cur].numpy()
        assert (np.linalg.norm(T_final[:3, 3] - T_corrected[:3, 3])
                < 0.25 * np.linalg.norm(T_final[:3, 3] - m_np.kf_T_cw[cur][:3, 3]))
        # ... where the reference's GBA started from its corrected map lands
        fresh = jgba.IncrementalGBA(m_corrected_ref, JRING, sharded=False)
        while not fresh.step():
            pass
        np.testing.assert_allclose(
            T_final, np.asarray(fresh.merge(m_corrected_ref).kf_T_cw[cur]), atol=1e-2)
    else:
        assert moved == 0.0 and slam.loops_closed == 0
        np.testing.assert_array_equal(T_after_ref, np.asarray(old.merge(jm).kf_T_cw[cur]))
        assert slam.pending_gba is old_t              # resumes
        slam._service_gba()
        assert slam.pending_gba is None
        np.testing.assert_allclose(slam.map.kf_T_cw[cur].numpy(), T_after_ref, atol=5e-3)
