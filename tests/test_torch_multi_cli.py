"""The port's CLI on several ranks (``parallel/launch.py``) against the
reference CLI sharded over two devices, and what ends the ranks.

``main(argv, device="cpu", ranks=2)`` runs in the test's process as rank 0,
so the test's monkeypatches reach the engine, and spawns rank 1, which
serves the sharded pose solve (``parallel/serve.py``).  The reference CLI
runs here too, its pose solve ``make_sharded_pose_optimizer`` over
``jax.devices()[:2]`` of conftest's 8 virtual CPU devices, as its
``StereoSlam`` builds it over every device.

Bars, and why:

- KITTI mode with the reference's front end patched into the port and the
  reference's RANSAC sets injected, both CLIs in the synchronous schedule:
  the same keyframe count, and poses.txt within 5 mm and 1e-3 rad of the
  reference's re-chained trajectory (``test_kitti_cli_matches_reference``'s
  bar for one device; two ranks sum the normal system in the reference's
  two blocks);
- every run leaves no default group and no child process, whether ``main``
  returns or raises (an autouse check);
- the drills end within the group's timeout, made small here through the
  launcher: a corrupt PNG makes rank 0 raise and the worker exit 0; a worker
  killed during the run makes rank 0 raise; SIGTERM ends the CLI with 143
  and its worker with it;
- a live session whose frame source pauses for 2.5 times the group's
  timeout tracks every frame (live mode writes no dump files, as the
  reference's: a pose and a message each) and its worker serves the ops
  after the pause.
"""

import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from opendlv_perception_vision_orbslam2_tpu import __main__ as jcli
from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.models import selflocalization as jsel
from opendlv_perception_vision_orbslam2_tpu.parallel import sharded_pose as jsp
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as tcli
from opendlv_perception_vision_orbslam2_tpu_torch.io import od4 as tod4
from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as tsel
from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as tslam
from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp as tpnp
from opendlv_perception_vision_orbslam2_tpu_torch.parallel import collectives, launch, serve
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic as tsyn
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy
from test_torch_io import CAM, CLI_FLAGS, Recorder, _kitti_dir
from test_torch_service import LIVE_FLAGS
from test_torch_slam import _np_tree, _reference_sets

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N_FRAMES = 6            # test_kitti_cli_matches_reference's directory
DRILL_TIMEOUT_S = 10.0  # the group's timeout in the drills
IDLE_TIMEOUT_S = 2.0    # the group's timeout of the idle session
IDLE_PAUSE_S = 2.5 * IDLE_TIMEOUT_S


@pytest.fixture(autouse=True)
def nothing_left_behind():
    yield
    assert not dist.is_initialized(), "a default process group outlived the test"
    assert multiprocessing.active_children() == [], "a child process outlived the test"


@pytest.fixture
def ranks_made(monkeypatch):
    """Every ``LocalRanks`` that ``main`` makes, kept for its exit codes
    and reports."""
    made = []

    class Kept(launch.LocalRanks):
        def __init__(self, plan):
            super().__init__(plan)
            made.append(self)

    monkeypatch.setattr(launch, "LocalRanks", Kept)
    return made


# ---- the rank plan -------------------------------------------------------------

def _cuda(*idx):
    return tuple(torch.device("cuda", i) for i in idx)


PLANS = {
    "4 cards: NCCL, one rank a card": (("cuda", None, 4), (4, launch.NCCL, _cuda(0, 1, 2, 3))),
    "1 card: no group": (("cuda", None, 1), (1, None, (torch.device("cuda"),))),
    "no card: no group, the engine raises": (("cuda", None, 0),
                                             (1, None, (torch.device("cuda"),))),
    "2 ranks on 1 card: gloo": (("cuda", 2, 1), (2, launch.GLOO, _cuda(0, 0))),
    "3 ranks on 2 cards: gloo": (("cuda", 3, 2), (3, launch.GLOO, _cuda(0, 1, 0))),
    "2 ranks on 4 cards: NCCL": (("cuda", 2, 4), (2, launch.NCCL, _cuda(0, 1))),
    "cpu: one rank": (("cpu", None, 4), (1, None, (torch.device("cpu"),))),
    "cpu, 2 ranks: gloo": (("cpu", 2, 0), (2, launch.GLOO, (torch.device("cpu"),) * 2)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_rank_plan(case):
    args, want = PLANS[case]
    assert tuple(launch.plan_ranks(*args)) == want


def test_rank_plan_rejects():
    with pytest.raises(ValueError):
        launch.plan_ranks("cpu", 0, 0)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        launch.plan_ranks("cuda", 2, 0)


def test_backend_failure_raises_without_fallback(monkeypatch):
    """A plan whose NCCL is missing raises before any process starts; a
    group that fails to form raises, and the worker already started is
    ended; neither falls back to another backend."""
    monkeypatch.setattr(launch.dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="has no NCCL"):
        with launch.LocalRanks(launch.plan_ranks("cuda", None, 4)):
            pass

    def refuse(backend, **kwargs):
        raise RuntimeError(f"injected: {backend} refused")

    monkeypatch.setattr(launch.dist, "init_process_group", refuse)
    ranks = launch.LocalRanks(launch.plan_ranks("cpu", 2, 0))
    with pytest.raises(RuntimeError, match="injected: gloo refused"):
        with ranks:
            pass
    assert len(ranks.exit_codes) == 1 and ranks.exit_codes[0] != 0


def test_usage_exit_spawns_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the usage exit formed ranks")

    monkeypatch.setattr(launch, "local_ranks", refuse)
    assert tcli.main([], device="cpu", ranks=2) == 1


# ---- KITTI mode against the reference CLI on two devices ------------------------

def test_cli_on_two_ranks_matches_reference_sharded(tmp_path, monkeypatch, ranks_made):
    _kitti_dir(tmp_path / "ref", N_FRAMES)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    jcfg = jconfig.config_from_flags([f"--kittiPath={tmp_path}"] + CLI_FLAGS)
    made = []

    class JSel(jsel.Selflocalization):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.slam.force_sync_decisions = True
            cam = jcfg.camera
            mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("obs",))
            self.slam._pose_solver = jsp.make_sharded_pose_optimizer(
                mesh, "obs", fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf)
            made.append(self)

    class TSel(tsel.Selflocalization):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.slam.force_sync_decisions = True
            made.append(self)

    def reference_front_end(left, right, config, timestamp):
        return from_jax_numpy(_np_tree(jfront.process_stereo(
            jnp.asarray(left.numpy()), jnp.asarray(right.numpy()), jcfg, timestamp)))

    monkeypatch.setattr(jsel, "Selflocalization", JSel)
    monkeypatch.setattr(tsel, "Selflocalization", TSel)
    monkeypatch.setattr(tslam, "process_stereo", reference_front_end)
    monkeypatch.setattr(tpnp, "sample_sets", _reference_sets)
    assert jcli.main([f"--kittiPath={tmp_path / 'ref'}"] + CLI_FLAGS) == 0
    collectives.reset_stats()
    assert tcli.main([f"--kittiPath={tmp_path / 'port'}"] + CLI_FLAGS, device="cpu",
                     ranks=2) == 0
    assert collectives.STATS["all_reduce"] > 0
    jslam_, tslam_ = made[0].slam, made[1].slam
    assert isinstance(tslam_._pose_solver, serve.EnginePoseSolver)
    jslam_.finish()
    ref = jslam_.corrected_trajectory()
    est = chip_smoke.read_kitti_poses(tmp_path / "port" / "poses.txt")
    assert len(est) == len(ref) == N_FRAMES
    for i, (T, T_ref) in enumerate(zip(est, ref)):
        assert np.linalg.norm(T[:3, 3] - T_ref[:3, 3]) < 5e-3, f"frame {i}"
        cos = np.clip((np.trace(T_ref[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)
        assert np.arccos(cos) < 1e-3, f"frame {i}"
    assert tslam_.n_keyframes == jslam_.n_keyframes
    ranks = ranks_made[0]
    assert ranks.plan.world == 2 and ranks.exit_codes == [0]
    report = ranks.reports[1]
    assert report["served"] >= N_FRAMES - 1          # a pose solve each tracked frame
    assert report["collectives"]["all_reduce"] == collectives.STATS["all_reduce"]
    assert not any(report["launches"].values())


# ---- what ends the ranks ----------------------------------------------------------

def test_corrupt_png_ends_every_rank(tmp_path, ranks_made):
    _kitti_dir(tmp_path, 5)
    (tmp_path / "image_0" / "000003.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"torn" * 64)
    with pytest.raises(OSError):
        tcli.main([f"--kittiPath={tmp_path}"] + CLI_FLAGS, device="cpu", ranks=2)
    assert ranks_made[0].exit_codes == [0]      # stopped, not killed
    assert ranks_made[0].reports[1]["served"] >= 2


def test_killed_worker_makes_main_raise(tmp_path, monkeypatch, ranks_made):
    """A hook on rank 0 kills the worker after frame 2; the next frame's
    pose solve raises, well within the group's timeout."""
    monkeypatch.setattr(launch, "GROUP_TIMEOUT_S", DRILL_TIMEOUT_S)
    _kitti_dir(tmp_path, 5)
    killed_at = []

    class Killing(tsel.Selflocalization):
        def track(self, *args, **kwargs):
            if self.frame_count == 2:
                for p in multiprocessing.active_children():
                    p.kill()
                    p.join()
                killed_at.append(time.monotonic())
            return super().track(*args, **kwargs)

    monkeypatch.setattr(tsel, "Selflocalization", Killing)
    with pytest.raises(RuntimeError, match="ended during the run"):
        tcli.main([f"--kittiPath={tmp_path}"] + CLI_FLAGS, device="cpu", ranks=2)
    assert killed_at and time.monotonic() - killed_at[0] < DRILL_TIMEOUT_S
    assert ranks_made[0].exit_codes == [-signal.SIGKILL]


def _live_frames(n):
    cfg = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM))
    lefts, rights, _, _ = tsyn.render_stereo_sequence(cfg, n_frames=n, n_points=400, seed=3)
    return [(np.hstack([a, b]), 0.1 * i) for i, (a, b) in enumerate(zip(lefts, rights))]


def test_idle_live_session_outlasts_the_group_timeout(monkeypatch, ranks_made):
    monkeypatch.setattr(launch, "GROUP_TIMEOUT_S", IDLE_TIMEOUT_S)
    rec = Recorder()
    monkeypatch.setattr(tod4, "OD4Session", lambda *a, **k: rec)
    made = []

    class Kept(tsel.Selflocalization):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(tsel, "Selflocalization", Kept)
    frames = _live_frames(4)
    sent_before = []

    def paused():
        yield from frames[:2]
        sent_before.append(collectives.STATS["broadcast"])
        time.sleep(IDLE_PAUSE_S)        # the camera pauses: rank 0 sends no op
        yield from frames[2:]

    collectives.reset_stats()
    assert tcli.main(LIVE_FLAGS, device="cpu", frames=paused(), ranks=2) == 0
    slam = made[0].slam
    assert len(slam.trajectory) == len(frames)
    assert all(np.isfinite(T.numpy()).all() for T in slam.trajectory)
    assert sum(type(m).__name__ == "Geolocation" for m in rec.sent) == len(frames)
    assert rec.closed
    ranks = ranks_made[0]
    assert ranks.exit_codes == [0]
    # the worker took part in the operand broadcasts after the pause too
    assert sent_before and collectives.STATS["broadcast"] > sent_before[0]
    assert ranks.reports[1]["collectives"]["broadcast"] == collectives.STATS["broadcast"]


SIGTERM_SCRIPT = """
import multiprocessing, sys, time
import numpy as np
import torch
torch.set_num_threads(2)
from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as cli
from opendlv_perception_vision_orbslam2_tpu_torch.io import od4
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config, synthetic

od4.OD4Session = lambda *args, **kwargs: od4.NullSession()    # no socket in a test

cfg = config.SystemConfig(camera=config.CameraConfig(**{cam!r}))
lefts, rights, _, _ = synthetic.render_stereo_sequence(cfg, n_frames=2, n_points=400, seed=3)

def frames():
    for i in range(2):
        yield np.hstack([lefts[i], rights[i]]), 0.1 * i
    print("WORKERS", *[p.pid for p in multiprocessing.active_children()], flush=True)
    time.sleep(120)                     # a live camera that sends nothing more

raise SystemExit(cli.main({argv!r}, device="cpu", frames=frames(), ranks=2))
"""


def _gone(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().split(")")[-1].split()[0]
    except FileNotFoundError:
        return True
    return state == "Z"


def test_sigterm_ends_the_cli_and_its_workers():
    """``docker stop`` in live mode: SIGTERM to rank 0 while it waits for a
    frame ends it with 143, its worker first."""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    script = SIGTERM_SCRIPT.format(cam=CAM, argv=LIVE_FLAGS)
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(120, proc.kill)
    watchdog.start()
    try:
        lines, pids = [], []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("WORKERS"):
                pids = [int(x) for x in line.split()[1:]]
                break
        assert len(pids) == 1, "".join(lines)
        proc.send_signal(signal.SIGTERM)
        lines += proc.stdout.readlines()
        assert proc.wait(60) == 128 + signal.SIGTERM, "".join(lines)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    deadline = time.monotonic() + 10
    while not _gone(pids[0]) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _gone(pids[0])
