"""A loop closure on several ranks: the engine's post-loop GBA sharded over
the group inside ``StereoSlam``, against the split witness and the
reference package on two devices.

Rank 0 is this process: ``launch.LocalRanks`` (the CLI's launcher) spawns
rank 1 over gloo, which serves the sharded solves (``parallel/serve.py``).
On rank 0 a ``StereoSlam`` holds the closure map of
``tests/test_torch_cuda.py``'s drifted 26-keyframe ring (built once, without
jax) and goes through the lifecycle that only the engine drives:

1. a valid verdict (``_dispatch_verify``, then ``_try_harvest_loop``)
   starts the GBA, sharded (the worker's ``gba_init``);
2. one chunk a frame (``_service_gba``);
3. a second verification in flight pauses it: no chunk, no collective;
4. the second, valid verdict replaces it (a second ``gba_init``);
5. a capacity growth (32 -> 128 keyframe slots) drops it;
6. a third verdict on the grown map starts one of the new shapes;
7. ``finish()`` drains it to its merge; then the launcher stops the
   worker, whose report counts every init and chunk rank 0 made.

The same steps run on the split witness (no group; ``chip_smoke.
SplitWitness``: each reduction the sum of two edge blocks in rank order,
the bits two ranks give) and on the reference package, its GBA built on
``jax.devices()[:2]`` as its ``IncrementalGBA`` builds it over every local
device (conftest gives 8), its verdicts from its ``PRNGKey(7)`` chain, whose
sets the port is handed (``_KeyChain``).  The reference runs step 3 in the
port's order: its own engine steps the GBA during a verification (ROADMAP
queue 3, the pending GBA), which is not what is compared here.

Tolerances, and why:

- rank 0 against the split witness: every corrected map, every carry after
  every chunk and the final map, bit for bit (the ranks add the same
  blocks in the same order);
- against the reference: the same verdicts; keyframe poses after each
  correction 2 cm / 2e-3 rad and after the final merge as well
  (``tests/test_torch_loop_slam.py``'s bars), and so the poses after the
  first chunk of the first two GBAs (read here: 5.0 and 3.0 mm, 4.9e-4
  and 6.9e-4 rad; their costs, printed with -s, 0.5 % and 0.3 % apart: on
  the ring one float32 chunk moves by 1.9e-4 with the summation order
  alone, ``tests/test_torch_cuda.py``, and the port sums and inverts the
  landmark blocks in float64, the reference in float32); the keyframes'
  ATE against the ring's truth within 1 cm before the last merge and 3 cm
  after it (``test_torch_loop_slam.py``'s bars; read here: 1e-5 and 5e-5
  m apart).

``test_loop_drive_on_two_ranks_matches_reference`` (``slow``, several
minutes): the 90-frame 512x256 loop drive of ``test_torch_loop_slam.py``
with the port's engine on rank 0 of two ranks, against the reference with
its pose solve and GBA on two devices (each frame's pose within 2 cm plus
the reference's own gap between one and two devices there) and against
the split witness, bit for bit.
"""

import multiprocessing

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_loop_closing as ring
from opendlv_perception_vision_orbslam2_tpu.models import global_ba as jgba
from opendlv_perception_vision_orbslam2_tpu.models import kfdb as jkfdb
from opendlv_perception_vision_orbslam2_tpu.models import loop_closing as jloop
from opendlv_perception_vision_orbslam2_tpu.models import map_state as jms
from opendlv_perception_vision_orbslam2_tpu.models import slam as jslam
from opendlv_perception_vision_orbslam2_tpu.parallel import sharded_pose as jsp
from opendlv_perception_vision_orbslam2_tpu_torch.models import loop_closing as tloop
from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as tslam
from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp as tpnp
from opendlv_perception_vision_orbslam2_tpu_torch.parallel import collectives, launch, serve
from opendlv_perception_vision_orbslam2_tpu_torch.utils import trajectory as ttraj
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy, to_numpy
from test_torch_cuda import (
    CHUNKS_BEFORE_GROWTH, CHUNKS_BEFORE_PAUSE, LIFECYCLE_FIELDS, N_OUTER, _bits, lifecycle,
    pause_check, port_engine, ring_closure,
)
from test_torch_loop import _KeyChain, corrected_like_the_port

torch.set_num_threads(2)

WORLD = 2
TRANS_TOL, ROT_TOL = 2e-2, 2e-3


@pytest.fixture(autouse=True)
def nothing_left_behind():
    yield
    assert not dist.is_initialized(), "a default process group outlived the test"
    assert multiprocessing.active_children() == [], "a child process outlived the test"


@pytest.fixture(scope="module")
def closure():
    return ring_closure()


def _jax_tree(tree, module):
    """A port NamedTuple as the reference's of the same name."""
    cls = getattr(module, type(tree).__name__)
    return cls(*(jnp.asarray(x) for x in to_numpy(tree)))


def _reference_lifecycle(c, mp):
    """The lifecycle on the reference engine, its GBA on two devices."""
    mp.setattr(jax, "local_device_count", lambda: WORLD)
    corrected_like_the_port(mp)
    try:
        ref = jslam.StereoSlam(ring.CFG, enable_relocalization=False)
        ref.map, ref.db = _jax_tree(c["map"], jms), _jax_tree(c["db"], jkfdb)
        ref.kf_nodes = jnp.asarray(c["nodes"].numpy())
        ref.loop_closer = jloop.LoopCloser(ring.CFG)
        rec = lifecycle(ref, c)
        rec["sharded"] = [g is None or g._sharded is not None for g in rec["gbas"]]
        return rec
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(closure):
    """The lifecycle on rank 0 of two gloo ranks (and the worker's report),
    on the split witness, and on the reference with its GBA on two
    devices."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        chain = _KeyChain()
        mp.setattr(tloop, "sample_sets", chain.sample_sets)
        ranks = launch.LocalRanks(launch.plan_ranks("cpu", WORLD, 0))
        with ranks:
            collectives.reset_stats()
            slam = port_engine(closure)
            out["ranks"] = lifecycle(slam, closure, chain.split, pause_check(slam))
            out["pose_solver"] = slam._pose_solver
            out["stats"] = dict(collectives.STATS)
        out["exit_codes"], out["reports"] = ranks.exit_codes, ranks.reports
        chain = _KeyChain()
        mp.setattr(tloop, "sample_sets", chain.sample_sets)
        with chip_smoke.SplitWitness(closure["cfg"].camera, WORLD):
            slam = port_engine(closure)
            out["witness"] = lifecycle(slam, closure, chain.split, pause_check(slam))
    finally:
        mp.undo()
    out["reference"] = _reference_lifecycle(closure, mp)
    return out


# ---- the lifecycle on rank 0 ------------------------------------------------------

N_CHUNKS = CHUNKS_BEFORE_PAUSE + CHUNKS_BEFORE_GROWTH + N_OUTER   # every chunk served


def test_valid_verdict_starts_the_sharded_gba(runs):
    r = runs["ranks"]
    assert r["verdicts"] == [1, 1, 1]
    assert all(g is not None and g._sharded is not None for g in r["gbas"])
    assert r["gbas"][0].prob.e_kf.shape[0] % WORLD == 0
    assert isinstance(runs["pose_solver"], serve.EnginePoseSolver)


def test_gba_pauses_while_a_verification_is_in_flight(runs):
    assert runs["ranks"]["paused"]


def test_second_verdict_replaces_the_gba(runs):
    first, second, _ = runs["ranks"]["gbas"]
    assert second is not first
    assert second._sharded.handle == first._sharded.handle + 1
    assert first.iters_left == N_OUTER - CHUNKS_BEFORE_PAUSE    # dropped where it stood


def test_growth_drops_the_gba_and_the_next_has_the_new_shapes(runs, closure):
    r = runs["ranks"]
    assert r["dropped"] and r["K"] == [32, 32, 128] and r["grown"] == 128
    third = r["gbas"][2]
    F = closure["cfg"].orb.max_keypoints
    assert third.prob.T_opt.shape[0] == 128 and third.prob.e_kf.shape[0] == 128 * F


def test_finish_drains_the_gba_before_the_workers_stop(runs):
    r = runs["ranks"]
    assert r["iters_left"] == 0 and r["pending_after"] is None
    assert runs["exit_codes"] == [0]
    ops = runs["reports"][1]["ops"]
    # every init and chunk rank 0 made was served, the ones inside finish() too
    assert ops["gba_init"]["n"] == 3 and ops["gba_step"]["n"] == N_CHUNKS
    assert "pose" not in ops
    assert runs["reports"][1]["served"] == 3 + N_CHUNKS
    assert runs["reports"][1]["collectives"]["all_reduce"] == runs["stats"]["all_reduce"]
    assert runs["reports"][1]["collectives"]["broadcast"] == runs["stats"]["broadcast"]
    assert not any(runs["reports"][1]["launches"].values())


# ---- rank 0 against the split witness, bit for bit ---------------------------------

@pytest.mark.parametrize("field", LIFECYCLE_FIELDS)
def test_ranks_equal_the_split_witness(runs, field):
    a, b = runs["ranks"][field], runs["witness"][field]
    assert _bits(a) == _bits(b), field


def test_witness_went_through_the_same_steps(runs):
    w = runs["witness"]
    assert w["paused"] and w["dropped"] and w["pending_after"] is None
    assert all(type(g).__name__ == "SplitGBA" for g in w["gbas"])


# ---- against the reference on two devices --------------------------------------------

def _pose_gaps(a, b):
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1).max()
    cos = (np.einsum("kij,kij->k", a[:, :3, :3], b[:, :3, :3]) - 1) / 2
    return dt, np.arccos(np.clip(cos, -1, 1)).max()


def test_reference_ran_sharded_on_two_devices(runs):
    ref = runs["reference"]
    assert ref["sharded"] == [True, True, True]
    assert ref["verdicts"] == runs["ranks"]["verdicts"] == [1, 1, 1]
    assert ref["K"] == runs["ranks"]["K"] and ref["dropped"]


@pytest.mark.parametrize("k", range(3))
def test_corrections_match_reference(runs, k):
    dt, dr = _pose_gaps(runs["ranks"]["corrected"][k], runs["reference"]["corrected"][k])
    assert dt < TRANS_TOL and dr < ROT_TOL, (dt, dr)


@pytest.mark.parametrize("k", [0, CHUNKS_BEFORE_PAUSE], ids=["first GBA", "second GBA"])
def test_first_chunk_of_each_gba_matches_reference(runs, k, capsys):
    out, ref = runs["ranks"]["carries"][k], runs["reference"]["carries"][k]
    valid = np.asarray(runs["ranks"]["gbas"][0].prob.opt_valid)
    dt, dr = _pose_gaps(out[0][valid], ref[0][valid])
    cost = abs(float(out[3]) - float(ref[3])) / abs(float(ref[3]))
    with capsys.disabled():
        print(f"\nchunk {k}: {dt:.3g} m, {dr:.3g} rad, cost {float(out[3]):.6g} vs "
              f"{float(ref[3]):.6g} ({cost:.3g})")
    assert dt < TRANS_TOL and dr < ROT_TOL, (dt, dr)


def test_merged_map_matches_reference(runs):
    dt, dr = _pose_gaps(runs["ranks"]["final"], runs["reference"]["final"])
    assert dt < TRANS_TOL and dr < ROT_TOL, (dt, dr)


def test_ate_matches_reference_before_and_after_the_merge(runs, closure, capsys):
    gt = closure["gt"]
    ate = {k: [ttraj.ate_rmse(list(r[f]), gt, align=True) for f in ("before_merge", "final")]
           for k, r in (("port", runs["ranks"]), ("reference", runs["reference"]))}
    with capsys.disabled():
        print(f"\nring keyframes' ATE before / after the last merge: port on 2 ranks "
              f"{ate['port']}, reference on 2 devices {ate['reference']}")
    assert abs(ate["port"][0] - ate["reference"][0]) < 0.01
    assert abs(ate["port"][1] - ate["reference"][1]) < 0.03


# ---- the loop drive on two ranks (slow) ------------------------------------------------

class _Counted:
    """Within it, every ``IncrementalGBA`` the port's engine starts (the
    class in place at entry: the real one, or the split witness's) counts its
    starts and chunks in ``starts`` and ``chunks``."""

    def __enter__(self):
        inner = self.inner = tslam.IncrementalGBA
        counts = self

        class Counted(inner):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                counts.starts += 1
                counts.sharded.append(getattr(self, "_sharded", None) is not None)

            def step(self):
                counts.chunks += 1
                return super().step()

        self.starts, self.chunks, self.sharded = 0, 0, []
        tslam.IncrementalGBA = Counted
        return self

    def __exit__(self, *exc):
        tslam.IncrementalGBA = self.inner
        return False


def _port_drive(frames, monkeypatch):
    """The port's engine over ``frames`` as ``test_loop_slam_slice_matches_
    reference`` drives it: poses, keyframes a frame, verifications, closures,
    the retro-corrected trajectory before and after ``finish()``."""
    from test_torch_loop_slam import TCFG, _LoopKeys, _np_tree

    keys = _LoopKeys()
    monkeypatch.setattr(tloop, "sample_sets", keys.sample_sets)
    slam = tslam.StereoSlam(TCFG, device="cpu")
    slam.force_sync_decisions = True
    Closer, verified, poses = keys.attach(slam)
    monkeypatch.setattr(tslam, "LoopCloser", Closer)
    n_kf, closed_at = [], []
    for i, cur in enumerate(frames):
        loops = slam.loops_closed
        poses.append(slam._step(from_jax_numpy(_np_tree(cur))).numpy())
        n_kf.append(slam.n_keyframes)
        assert not slam.lost, f"frame {i}"
        if slam.loops_closed != loops:
            closed_at.append(i)
    before = [np.asarray(T) for T in slam.corrected_trajectory()]
    slam.finish()
    return dict(poses=poses, n_kf=n_kf, verified=verified, closed_at=closed_at,
                before=before, after=[np.asarray(T) for T in slam.corrected_trajectory()],
                loops=slam.loops_closed, solver=slam._pose_solver)


def _reference_drive(frames, monkeypatch, devices: int):
    """The reference over ``frames`` in the synchronous schedule, its pose
    solve and GBA on ``jax.devices()[:devices]`` (one: its single-device
    solves): poses, keyframes a frame, verifications, closures, the
    retro-corrected trajectory before and after ``finish()``, and whether
    each GBA it started was sharded."""
    from jax.sharding import Mesh

    from test_torch_loop_slam import JCFG

    verified, poses, sharded = [], [], []
    inner = jloop.verify_and_apply

    def noted(m, nodes, cur, cand, cur_id, cand_id, *rest):
        verified.append((len(poses), cur_id, cand_id))
        return inner(m, nodes, cur, cand, cur_id, cand_id, *rest)

    class Noted(jgba.IncrementalGBA):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            sharded.append(self._sharded is not None)

    with monkeypatch.context() as mp:
        mp.setattr(jax, "local_device_count", lambda: devices)
        corrected_like_the_port(mp)
        inner = jloop.verify_and_apply
        mp.setattr(jloop, "verify_and_apply", noted)
        mp.setattr(jgba, "IncrementalGBA", Noted)
        ref = jslam.StereoSlam(JCFG)
        ref.force_sync_decisions = True
        cam = JCFG.camera
        ref._pose_solver = None if devices == 1 else jsp.make_sharded_pose_optimizer(
            Mesh(np.array(jax.devices()[:devices]), ("obs",)), "obs", fx=cam.fx, fy=cam.fy,
            cx=cam.cx, cy=cam.cy, bf=cam.bf)
        n_kf, closed_at = [], []
        for i, cur in enumerate(frames):
            loops = ref.loops_closed
            poses.append(np.asarray(ref._step(cur)))
            n_kf.append(ref.n_keyframes)
            if ref.loops_closed != loops:
                closed_at.append(i)
        before = [np.asarray(T) for T in ref.corrected_trajectory()]
        ref.finish()
    return dict(poses=poses, n_kf=n_kf, verified=verified, closed_at=closed_at, before=before,
                after=[np.asarray(T) for T in ref.corrected_trajectory()],
                loops=ref.loops_closed, sharded=sharded)


@pytest.mark.slow
def test_loop_drive_on_two_ranks_matches_reference(monkeypatch, capsys):
    """The 90-frame 512x256 loop drive (``test_torch_loop_slam.py``'s: the
    reference front end's frames, its RANSAC sets, the synchronous
    schedule) with the port's engine on rank 0 of two gloo ranks, against
    the reference with its pose solve and GBA on ``jax.devices()[:2]`` and
    against the split witness (bit for bit).  That file's bars: the same
    keyframes a frame, verifications and closures; ATE within 1 cm before
    ``finish()`` and 3 cm after it; each frame's pose within 2e-3 rad and
    within 2 cm of the two-device reference's plus the reference's own gap
    between its one-device and two-device drives at that frame.  The plus:
    at frame 34 a mapping stage's gate goes the other way by the float32
    rounding of the pose solve summed in two blocks, and the reference's
    own two drives part there by 5.2 cm, 5.5 cm at most, 1.0 cm after the
    loop correction (its drives in this test; the port's gap to the
    two-device reference read 4.3 cm there).  The worker served every GBA
    start and chunk.  Several minutes; run with ``-m slow -s``."""
    import time

    from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
    from opendlv_perception_vision_orbslam2_tpu.utils import synthetic as jsyn
    from test_torch_loop_slam import JCFG, LOOP_DRIVE, TCFG, _frame_sets

    t0 = time.perf_counter()
    lefts, rights, gt, _ = jsyn.render_loop_sequence(JCFG, **LOOP_DRIVE)
    frames = [jfront.process_stereo(jnp.asarray(lefts[i]), jnp.asarray(rights[i]), JCFG, i * 0.1)
              for i in range(LOOP_DRIVE["n_frames"])]
    gt = list(np.asarray(gt))
    ref = _reference_drive(frames, monkeypatch, WORLD)
    one = _reference_drive(frames, monkeypatch, 1)
    assert ref["closed_at"] and all(ref["sharded"]) and not any(one["sharded"])
    t_ref = time.perf_counter() - t0

    monkeypatch.setattr(tpnp, "sample_sets", _frame_sets)
    ranks = launch.LocalRanks(launch.plan_ranks("cpu", WORLD, 0))
    t1 = time.perf_counter()
    with ranks, _Counted() as counted:
        port = _port_drive(frames, monkeypatch)
    t_ranks = time.perf_counter() - t1
    with chip_smoke.SplitWitness(TCFG.camera, WORLD), _Counted() as w_counted:
        witness = _port_drive(frames, monkeypatch)

    ops = ranks.reports[1]["ops"]
    ate = [ttraj.ate_rmse(t, gt, align=True) for t in (port["before"], ref["before"],
                                                       port["after"], ref["after"])]
    gap = lambda A, B: [float(np.linalg.norm(T[:3, 3] - R[:3, 3]))  # noqa: E731
                        for T, R in zip(A, B)]
    gaps, spread = gap(port["poses"], ref["poses"]), gap(one["poses"], ref["poses"])
    with capsys.disabled():
        print(f"\nloop drive on {WORLD} ranks: closures port {port['closed_at']} reference "
              f"{ref['closed_at']}, keyframes {port['n_kf'][-1]} / {ref['n_kf'][-1]}, GBA "
              f"starts {counted.starts} (sharded {counted.sharded}) chunks {counted.chunks}, "
              f"worker ops {ops}; pose gap to the two-device reference max {max(gaps):.4g} m "
              f"at frame {int(np.argmax(gaps))}, the reference's one- vs two-device gap max "
              f"{max(spread):.4g} m at frame {int(np.argmax(spread))} ({spread[34]:.4g} at "
              f"frame 34); ATE before / after finish() port {ate[0]:.4f} / {ate[2]:.4f} m, "
              f"reference {ate[1]:.4f} / {ate[3]:.4f} m; split witness poses "
              f"{'bit-equal' if _bits(port['poses']) == _bits(witness['poses']) else 'DIFFER'};"
              f" the references {t_ref:.0f} s, the ranks {t_ranks:.0f} s")
    assert isinstance(port["solver"], serve.EnginePoseSolver)
    assert port["n_kf"] == ref["n_kf"]
    assert port["verified"] == ref["verified"]
    assert port["closed_at"] == ref["closed_at"] and port["loops"] == ref["loops"]
    for i, (T, R) in enumerate(zip(port["poses"], ref["poses"])):
        assert gaps[i] < TRANS_TOL + spread[i], f"frame {i}"
        cos = np.clip((np.trace(R[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)
        assert np.arccos(cos) < ROT_TOL, f"frame {i}"
    assert abs(ate[0] - ate[1]) < 0.01 and abs(ate[2] - ate[3]) < 0.03, ate
    assert counted.starts >= 1 and all(counted.sharded)
    assert ranks.exit_codes == [0]
    assert ops["gba_init"]["n"] == counted.starts and ops["gba_step"]["n"] == counted.chunks
    for field in ("poses", "n_kf", "verified", "closed_at", "before", "after"):
        assert _bits(port[field]) == _bits(witness[field]), field
    assert (w_counted.starts, w_counted.chunks) == (counted.starts, counted.chunks)
