"""The benchmark's plain reference of the loop correction
(``benchmark/reference/loop.py``) and the port's ``correct_loop`` against it.

The reference is imported by path: it belongs to the benchmark, imports
nothing of either package, and solves the essential graph to convergence in
float64 (numpy).  The graphs are seeded: a chain of keyframes around a circle whose
odometry drifts, strong covisibility between near keyframes, and a loop edge
from the last keyframe to the first taken from the truth; ``fix_scale``
False adds a scale drift that the loop edge's scale corrects (monocular).

Tolerances, and why:

- the reference alone, on graphs whose every edge agrees with a known set
  of poses: it reaches them from perturbed starts to 1e-9 (rotation, in
  radians; centres and scales, relative): float64 and a solve run to
  convergence, limited by the central differences' 1e-10;
- at its minimum on the drifted graphs: a step of 1e-4 along a seeded
  direction changes the cost at first order by under 1e-3 of its second-
  order change, i.e. the gradient is zero to that precision;
- the port's ``correct_loop`` (float32 on the CPU, 15 Gauss-Newton steps
  damped by ``LM_DAMPING``, the error's translation taken without ``W^-1``)
  against it: ``LIMITS`` below, each about ten times the largest reading
  over the seeds here, 3.9e-5 deg, 5.9e-7 of the extent and 2.9e-5 m; the
  bf16 control reads at least 0.064 deg, 6.0e-4 and 0.027 m, 160 times the
  limits and more, and the loop edge dropped 1.25 deg and more;
- the controls must fail a limit: the reference solved on the edges
  rounded to bfloat16, and with the loop edge dropped.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing as tloop
from opendlv_perception_vision_orbslam2_tpu_torch.models import map_state as tms

torch.set_num_threads(2)

_SPEC = importlib.util.spec_from_file_location(
    "bench_reference_loop", Path(__file__).resolve().parent.parent / "benchmark" / "reference"
    / "loop.py")
ref = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ref)

#: the comparison's limits for the port on the CPU (module docstring)
LIMITS = {"rot_deg": 4e-4, "trans_rel": 6e-6, "point_m": 3e-4}
SEEDS = (0, 1, 2)


def _T(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def _circle(n, radius=20.0):
    """True ``T_cw`` of ``n`` keyframes around a circle, heading tangent."""
    out = []
    for i in range(n):
        th = 2 * math.pi * i / n
        c = np.array([radius * (1 - math.cos(th)), 0.0, radius * math.sin(th)])
        R_wc = ref.exp_so3(np.array([0.0, th, 0.0]))
        out.append(_T(R_wc.T, -R_wc.T @ c))
    return out


def drifted_map(seed, n=16, K=24, P=400, F=8, fix_scale=True):
    """``(map, cur, cand, T_loop, s_loop)``: ``n`` keyframes in slots
    ``0..n-1`` of a ``K``-slot map whose poses drift along the chain, strong
    covisibility between keyframes one and two apart, points seen from each
    keyframe, and the loop edge cur = n - 1 -> cand = 0 from the truth."""
    rng = np.random.default_rng(seed)
    gt = _circle(n)
    drifted, scale = [gt[0]], 1.0
    for i in range(1, n):
        rel = gt[i] @ np.linalg.inv(gt[i - 1])
        noise = rng.standard_normal(6) * np.array([0.004, 0.004, 0.004, 0.03, 0.03, 0.03])
        rel = _T(ref.exp_so3(noise[:3]) @ rel[:3, :3], rel[:3, 3] + noise[3:])
        if not fix_scale:
            scale *= 1.015
            rel[:3, 3] *= scale
        drifted.append(rel @ drifted[-1])
    T = np.tile(np.eye(4), (K, 1, 1))
    T[:n] = np.stack(drifted)
    covis = np.zeros((K, K), np.int32)
    for i in range(n):
        for d in (1, 2):
            if i + d < n:
                covis[i, i + d] = covis[i + d, i] = 150 - 30 * d
    kf_valid = np.arange(K) < n
    # points a few metres ahead of each keyframe, 20 a keyframe
    ref_kf = np.arange(P) // 20
    pt_valid = ref_kf < n
    ref_kf = np.where(pt_valid, ref_kf, -1)
    p_cam = rng.standard_normal((P, 3)) * np.array([3.0, 1.0, 2.0]) + np.array([0.0, 0.0, 8.0])
    T_wc = np.linalg.inv(T[np.clip(ref_kf, 0, K - 1)])
    p_w = (T_wc[:, :3, :3] @ p_cam[..., None])[..., 0] + T_wc[:, :3, 3]
    m = tms.empty_map(K, P, F)._replace(
        kf_valid=torch.from_numpy(kf_valid),
        kf_id=torch.from_numpy(np.where(kf_valid, np.arange(K), -1).astype(np.int32)),
        kf_T_cw=torch.from_numpy(T.astype(np.float32)), covis=torch.from_numpy(covis),
        pt_valid=torch.from_numpy(pt_valid),
        pt_pos=torch.from_numpy(np.where(pt_valid[:, None], p_w, 0.0).astype(np.float32)),
        pt_ref_kf=torch.from_numpy(ref_kf.astype(np.int32)))
    T_loop = torch.from_numpy((gt[n - 1] @ np.linalg.inv(gt[0])).astype(np.float32))
    s_loop = torch.tensor(scale if not fix_scale else 1.0, dtype=torch.float32)
    return m, n - 1, 0, T_loop, s_loop


def loop_inputs(m, cur, cand, T_loop, s_loop, fix_scale=True):
    """The reference's inputs: what ``correct_loop`` is given, with the edge
    set ``build_essential_edges`` makes of it."""
    e = tloop.build_essential_edges(m, cur, cand, T_loop, s_loop)
    return dict(T_cw=m.kf_T_cw, kf_valid=m.kf_valid, fixed=cand, e_i=e.e_i, e_j=e.e_j,
                e_T=e.e_T, e_s=e.e_s, e_w=e.e_w, e_valid=e.e_valid, fix_scale=fix_scale,
                pt_pos=m.pt_pos, pt_ref_kf=m.pt_ref_kf, pt_valid=m.pt_valid)


@pytest.fixture(scope="module", params=[True, False], ids=["fixed_scale", "free_scale"])
def solved(request):
    """Each seed's map, the port's correction and the reference's."""
    fix_scale = request.param
    out = []
    for seed in SEEDS:
        m, cur, cand, T_loop, s_loop = drifted_map(seed, fix_scale=fix_scale)
        inputs = loop_inputs(m, cur, cand, T_loop, s_loop, fix_scale)
        port = tloop.correct_loop(m, cur, cand, T_loop, s_loop, fix_scale=fix_scale)
        out.append((m, inputs, port, ref.correct(inputs)))
    return fix_scale, out


@pytest.mark.parametrize("fix_scale", [True, False])
def test_the_reference_recovers_poses_its_edges_agree_with(fix_scale):
    """Every edge from one set of similarities: from perturbed starts the
    solve returns them (the fixed vertex holds its own)."""
    rng = np.random.default_rng(5)
    n = 10
    gt = _circle(n)
    s_true = np.ones(n)
    if not fix_scale:
        s_true = 1.0 + 0.05 * rng.random(n)
        s_true[0] = 1.0
    R = np.stack([T[:3, :3] for T in gt])
    t = np.stack([T[:3, 3] for T in gt]) * s_true[:, None]
    pairs = [(i, i - 1) for i in range(1, n)] + [(i, i - 2) for i in range(2, n)] + [(n - 1, 0)]
    e_i = np.array([p[0] for p in pairs])
    e_j = np.array([p[1] for p in pairs])
    # S_ij = S_i o S_j^-1
    R_m, t_m, s_m = ref.compose(R[e_i], t[e_i], s_true[e_i],
                                *ref.inverse(R[e_j], t[e_j], s_true[e_j]))
    e_T = np.tile(np.eye(4), (len(pairs), 1, 1))
    e_T[:, :3, :3], e_T[:, :3, 3] = R_m, t_m
    start = np.stack(gt)
    noise = rng.standard_normal((n, 6)) * 0.05
    noise[0] = 0.0
    start[:, :3, :3] = ref.exp_so3(noise[:, :3]) @ start[:, :3, :3]
    start[:, :3, 3] += noise[:, 3:]
    out = ref.essential_graph(start, np.ones(n, bool), 0, e_i, e_j, e_T, s_m,
                              np.ones(len(pairs)), np.ones(len(pairs), bool), fix_scale)
    ang = np.linalg.norm(ref.log_so3(out["R"] @ R.transpose(0, 2, 1)), axis=-1)
    assert ang.max() < 1e-9
    assert np.linalg.norm(out["t"] - t, axis=-1).max() < 1e-9 * 40.0
    assert np.abs(out["s"] - s_true).max() < 1e-9
    assert out["cost"] < 1e-18 * max(out["cost0"], 1.0)


def test_the_reference_stops_at_a_minimum(solved):
    fix_scale, runs = solved
    rng = np.random.default_rng(3)
    for m, inputs, _, out in runs:
        assert out["cost"] < 0.05 * out["cost0"]          # the loop was closed
        live = m.kf_valid.numpy().copy()
        live[inputs["fixed"]] = False
        step = np.where(live[:, None], rng.standard_normal((live.shape[0], 7)) * 1e-4, 0.0)
        if fix_scale:
            step[:, 6] = 0.0
        c0 = ref.graph_cost(out, inputs)
        up, down = (ref.graph_cost(dict(zip("Rts", ref.retract(k * step, out["R"], out["t"],
                                                               out["s"]))), inputs)
                    for k in (1.0, -1.0))
        first, second = abs(up - down) / 2, (up + down) / 2 - c0
        assert second > 0 and first < 1e-3 * second, (first, second)


def test_correct_loop_matches_the_reference(solved):
    fix_scale, runs = solved
    for m, inputs, port, out in runs:
        numbers = ref.compare(port.kf_T_cw, port.pt_pos, out, m.kf_valid, m.pt_valid)
        ok, checks = ref.judge(numbers, LIMITS)
        assert ok, checks
        # the correction moved the current keyframe by much more than that
        moved = ref.compare(m.kf_T_cw, m.pt_pos, out, m.kf_valid, m.pt_valid)
        assert moved["trans_rel"] > 100 * LIMITS["trans_rel"]
        if not fix_scale:
            assert np.abs(out["s"][:16] - 1).max() > 0.05


@pytest.mark.parametrize("control", ["bf16", "no_loop"])
def test_the_controls_fail_the_comparison(solved, control):
    _, runs = solved
    for m, inputs, _, out in runs:
        numbers = ref.compare(*(lambda c: (c["T_cw"], c["pt_pos"]))(ref.control(control, inputs)),
                              out, m.kf_valid, m.pt_valid)
        ok, checks = ref.judge(numbers, LIMITS)
        assert not ok, checks


def test_a_point_of_a_dead_keyframe_stays_and_the_fixed_vertex_holds(solved):
    _, runs = solved
    m, inputs, port, out = runs[0]
    assert np.array_equal(out["T_cw"][0], m.kf_T_cw[0].double().numpy())
    dead = dict(inputs, kf_valid=inputs["kf_valid"].clone())
    dead["kf_valid"][3] = False
    moved = ref.correct(dead)
    held = m.pt_ref_kf.numpy() == 3
    assert np.array_equal(moved["pt_pos"][held], m.pt_pos.double().numpy()[held])


def test_the_reference_package_s_damping_fails_the_comparison(solved, monkeypatch):
    """The essential-graph solve damped as the reference package damps it
    (1e-3 of the diagonal at every step) leaves part of each correction
    undone after its 15 steps: the comparison refuses it."""
    from opendlv_perception_vision_orbslam2_tpu_torch.optim import pose_graph as tpg

    fix_scale, runs = solved
    monkeypatch.setattr(tpg, "LM_DAMPING", 1e-3)
    for m, inputs, _, out in runs:
        cur = int(inputs["e_i"][-1])
        T_loop, s_loop = inputs["e_T"][-1], inputs["e_s"][-1]
        damped = tloop.correct_loop(m, cur, inputs["fixed"], T_loop, s_loop, fix_scale=fix_scale)
        ok, checks = ref.judge(ref.compare(damped.kf_T_cw, damped.pt_pos, out, m.kf_valid,
                                           m.pt_valid), LIMITS)
        assert not ok, checks


def test_loop_check_holds_an_applied_correction_against_the_reference():
    """``benchmark/loop_check.py``'s capture and judge on the engine's
    verification of ``tests/test_torch_cuda.py``'s ring closure: one applied
    correction, of the nominated keyframes, the program within ``LIMITS`` and
    the bf16 control outside them."""
    import sys

    import test_torch_cuda as card

    from opendlv_perception_vision_orbslam2_tpu_torch.models import slam

    bench = Path(__file__).resolve().parent.parent / "benchmark"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    import loop_check

    c = card.ring_closure()
    engine = card.port_engine(c)
    kept, undo = loop_check.capture(slam)
    try:
        engine._dispatch_verify(c["det"])
    finally:
        undo()
    assert slam.apply_loop is tloop.apply_loop
    (row,) = loop_check.judge_loops(kept, LIMITS)
    assert row["kf_ids"] == [c["det"][1], c["det"][3]]
    assert row["program_ok"] and not row["bf16_ok"]
    assert row["moved"]["rot_deg"] > 1.0
