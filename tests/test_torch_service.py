"""The port's service layer against the reference package: ``Selflocalization``
(publishing, dumps, mode dispatch), the CLI's live loop and its KITTI mode.

- On a stub engine (the same poses and map in both packages) the two
  ``Selflocalization``s send the same messages and write the same dumps,
  apart from the two faults of the reference package the port does not
  carry: its ``shutdown`` settles the engine (``finish()``) before it
  writes, and its poses.txt is the re-chained ``corrected_trajectory()``.
  Those two are tested on their own, with a deferred decision in flight at
  shutdown.  Messages whose fetch has not landed go out at most two frames
  late, in frame order, and the sequence after ``shutdown`` is the
  reference's.
- The live loop (frames handed in, as the shared-memory reader hands them):
  the frames the pipeline gets equal the reference CLI's within 1e-3 grey
  levels resized; rectified, within 0.255 (the rectify maps agree within
  1e-3 px, tests/test_torch_undistort.py, here to 6.1e-5 px, and an 8-bit
  image changes by at most 255 grey levels over a pixel) and 95 % of the
  pixels within 1e-3.
- The KITTI mode with the reference's front end patched into the port and
  the reference's RANSAC sets injected, both in the synchronous schedule:
  poses.txt within 5 mm and 1e-3 rad of the reference CLI's engine
  re-chained after ``finish()`` (the SLAM slice's bound,
  tests/test_torch_slam.py).
- ``test_kitti_cli_reference_run`` (``slow``): the reference CLI over
  ``chip_smoke.py``'s phase 19 directory on the CPU, held to that phase's
  gates; it set the phase's ATE bound.
"""

import dataclasses
import shutil
import types

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu import __main__ as jcli
from opendlv_perception_vision_orbslam2_tpu.io import od4 as jod4
from opendlv_perception_vision_orbslam2_tpu.io import shared_memory as jshm
from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.models import selflocalization as jsel
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as tcli
from opendlv_perception_vision_orbslam2_tpu_torch.io import od4 as tod4
from opendlv_perception_vision_orbslam2_tpu_torch.io import shared_memory as tshm
from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as tsel
from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as tslam
from opendlv_perception_vision_orbslam2_tpu_torch.models.mono_slam import MonocularSlam
from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp as tpnp
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic as tsyn
from opendlv_perception_vision_orbslam2_tpu_torch.utils import trajectory as ttraj
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy
from test_torch_io import CAM, CLI_FLAGS, ORB, Recorder, _kitti_dir
from test_torch_slam import _np_tree, _reference_sets

torch.set_num_threads(2)

N_STUB = 41          # map messages at frames 20 and 40
P_STUB = 4096


def _stub_sequence(n=N_STUB):
    """Poses [n, 4, 4] (float32, world->camera) and map points [P, 3]."""
    rng = np.random.default_rng(6)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a = 0.01 * i
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = [0.1 * i, -0.02 * i, -0.5 * i]
    pts = rng.uniform(-40, 40, (P_STUB, 3)).astype(np.float32)
    return poses, pts


class StubEngine:
    """The engine surface ``Selflocalization`` uses, replaying a fixed
    sequence: frame i logs pose i and validates 37 * i points.  With
    ``deferred``, the last frame leaves a decision in flight that
    ``finish()`` settles by re-logging that frame's pose and adopting a
    mapping stage (25 more points), and ``corrected_trajectory()``
    re-chains every pose; without it both are the identity."""

    CHAIN = np.array([[1, 0, 0, 0.05], [0, 1, 0, 0.0], [0, 0, 1, -0.02], [0, 0, 0, 1]],
                     np.float32)

    def __init__(self, wrap, deferred=False, n=N_STUB):
        self.wrap, self.deferred, self.n = wrap, deferred, n
        self.poses, self.pts = _stub_sequence(n)
        self.trajectory = []
        self._valid = np.zeros(P_STUB, bool)
        self.map = self._map()
        self.finished = False

    def _map(self):
        return types.SimpleNamespace(pt_pos=self.wrap(self.pts), pt_valid=self.wrap(self._valid))

    def process(self, *images_and_timestamp):
        i = len(self.trajectory)
        self.trajectory.append(self.wrap(self.poses[i]))
        self._valid[: 37 * i] = True
        self.map = self._map()
        return self.trajectory[-1]

    process_rgbd = process

    def finish(self):
        self.finished = True
        if self.deferred:
            T = self.poses[-1].copy()
            T[:3, 3] += [0.3, 0.0, 0.1]
            self.trajectory[-1] = self.wrap(T)
            self._valid[: 37 * (self.n - 1) + 25] = True
            self.map = self._map()

    def raw(self):
        return [np.asarray(T) for T in self.trajectory]

    def corrected_trajectory(self):
        chain = self.CHAIN if self.deferred else np.eye(4, dtype=np.float32)
        return [np.asarray(T) @ chain for T in self.trajectory]


def _clock(monkeypatch, module):
    """A wall clock that advances 0.05 s a call: fps.txt becomes the same
    file in both packages."""
    t = iter(np.arange(0.0, 1e4, 0.05))
    monkeypatch.setattr(module, "time", types.SimpleNamespace(time=lambda: float(next(t))))


def _drive(sel, engine, out_dir):
    for i in range(engine.n):
        sel.track(np.zeros((4, 4), np.float32), np.zeros((4, 4), np.float32), i * 0.1)
    sel.shutdown(str(out_dir))


def _run_both(tmp_path, monkeypatch, deferred=False, cfg_kw=None):
    """Both packages' ``Selflocalization`` over a stub engine each; returns
    (port recorder, port engine, reference recorder, reference engine)."""
    for module in (tsel, jsel):
        _clock(monkeypatch, module)
    cfg_kw = cfg_kw or dict(ref_latitude=57.70716, ref_longitude=11.93827, start_heading=0.4)
    runs = []
    for sel_mod, cfg_mod, wrap, kw, name in (
            (tsel, tconfig, torch.from_numpy, dict(device="cpu"), "port"),
            (jsel, jconfig, np.array, {}, "ref")):
        rec = Recorder()
        sel = sel_mod.Selflocalization(cfg_mod.SystemConfig(**cfg_kw), od4=rec, **kw)
        engine = sel.slam = StubEngine(lambda a, w=wrap: w(np.array(a)), deferred)
        (tmp_path / name).mkdir()
        _drive(sel, engine, tmp_path / name)
        assert rec.closed
        runs += [rec, engine]
    return runs


def _wire(rec):
    return [(type(m).__name__, m.encode()) for m in rec.sent]


def test_same_engine_same_messages_and_dumps(tmp_path, monkeypatch):
    rec, _, jrec, _ = _run_both(tmp_path, monkeypatch)
    wire = _wire(rec)
    assert wire == _wire(jrec)
    kinds = [k for k, _ in wire]
    assert kinds.count("Geolocation") == N_STUB
    # the map with frames 20 and 40, after their pose: 703 points in one
    # chunk, 1443 in two
    assert [i for i, k in enumerate(kinds) if k == "OrbslamMap"] == [20, 41, 42]
    for name in ("poses.txt", "map.txt", "fps.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_shutdown_settles_the_engine_and_dumps_the_rechained_trajectory(tmp_path, monkeypatch):
    """A deferred decision in flight at shutdown: the port's dumps are
    ``finish()`` + ``corrected_trajectory()``; the reference package's hold
    the unsettled map and the raw poses.  The messages are the same."""
    rec, engine, jrec, jengine = _run_both(tmp_path, monkeypatch, deferred=True)
    assert _wire(rec) == _wire(jrec)
    assert engine.finished and not jengine.finished
    want = tmp_path / "want.txt"
    ttraj.write_pose_file(str(want), engine.corrected_trajectory())
    assert (tmp_path / "port" / "poses.txt").read_bytes() == want.read_bytes()
    ttraj.write_pose_file(str(want), jengine.raw())
    assert (tmp_path / "ref" / "poses.txt").read_bytes() == want.read_bytes()
    assert (tmp_path / "port" / "poses.txt").read_bytes() != want.read_bytes()
    n_port = len((tmp_path / "port" / "map.txt").read_text().splitlines())
    n_ref = len((tmp_path / "ref" / "map.txt").read_text().splitlines())
    assert (n_port, n_ref) == (37 * (N_STUB - 1) + 25, 37 * (N_STUB - 1))
    assert (tmp_path / "port" / "fps.txt").read_bytes() == (tmp_path / "ref" / "fps.txt").read_bytes()


class _SlowFetch:
    """A ``HostFetch`` whose copy never lands by itself (a busy device)."""

    fetch = tsel.HostFetch

    def __init__(self, *tensors):
        self._inner = self.fetch(*tensors)

    def done(self):
        return False

    def result(self):
        return self._inner.result()


def test_messages_go_out_at_most_two_frames_late_in_order(tmp_path, monkeypatch):
    monkeypatch.setattr(tsel, "HostFetch", _SlowFetch)
    rec = Recorder()
    sel = tsel.Selflocalization(tconfig.SystemConfig(start_heading=0.4), od4=rec, device="cpu")
    engine = sel.slam = StubEngine(lambda a: torch.from_numpy(np.array(a)))
    sent_at = []
    for i in range(engine.n):
        sel.track(None, None, i * 0.1)
        sent_at.append(sum(isinstance(m, tsel.Geolocation) for m in rec.sent))
    # frame k's pose goes out in the call of frame k + 2
    assert sent_at == [0, 0] + list(range(1, engine.n - 1))
    assert sel.publisher.lags == [2] * (engine.n - 2)
    sel.shutdown(str(tmp_path))
    assert sel.publisher.lags == [2] * (engine.n - 2) + [1, 0]
    want = [tsel.pose_to_geolocation(T, 0.0, 0.0, 0.4).encode() for T in engine.poses]
    assert [m.encode() for m in rec.sent if isinstance(m, tsel.Geolocation)] == want
    assert sel.map_sizes == [37 * i for i in range(engine.n)]


@pytest.mark.parametrize("camera_type, engine", [("stereo", tslam.StereoSlam),
                                                 ("rgbd", tslam.StereoSlam),
                                                 ("mono", MonocularSlam)])
def test_mode_dispatch_and_device(camera_type, engine, monkeypatch):
    cfg = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM), orb=tconfig.OrbConfig(**ORB),
                               camera_type=camera_type, max_keyframes=32, max_map_points=4096)
    sel = tsel.Selflocalization(cfg, device="cpu", tracking_only=camera_type != "mono")
    assert type(sel.slam) is engine and sel.slam.device.type == "cpu"
    assert sel.slam.tracking_only == (camera_type != "mono")
    calls = []
    for name in ("process", "process_rgbd"):
        monkeypatch.setattr(sel.slam, name, lambda *a, _n=name: calls.append((_n, len(a))))
    img = np.zeros((256, 512), np.float32)
    if camera_type == "mono":
        sel.track(img, timestamp=0.5)
    else:
        sel.track(img, img, timestamp=0.5)
    want = {"stereo": ("process", 3), "rgbd": ("process_rgbd", 3), "mono": ("process", 2)}
    assert calls == [want[camera_type]]
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            tsel.Selflocalization(cfg)


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _kitti_dir(tmp_path, 1)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tcli.main([f"--kittiPath={tmp_path}"] + CLI_FLAGS)


LIVE_FLAGS = ["--cid=111", "--name=cam0", "--width=1024", "--height=256", "--bpp=24",
              "--Camera.fx=320", "--Camera.fy=320", "--Camera.cx=256", "--Camera.cy=128",
              "--Camera.bf=160", "--Camera.fps=10", "--ORBextractor.nFeatures=400",
              "--ORBextractor.nLevels=3"]
RECTIFY_FLAGS = ["--rectify=1", "--Camera.baseline=0.5", "--Camera.rx=0.002",
                 "--Camera.cv=-0.001", "--Camera.rz=0.0015", "--Camera.k1=-0.05",
                 "--Camera.k2=0.01", "--Camera.p1=1e-4", "--Camera.p2=-2e-4"]


def _raw_frames(n=2):
    """Side-by-side RGB24 buffers of a rendered 512x256 pair (the camera
    proxy's layout), with unequal channels."""
    cfg = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM))
    lefts, rights, _, _ = tsyn.render_stereo_sequence(cfg, n_frames=n, n_points=400, seed=3)
    out = []
    for left, right in zip(lefts, rights):
        g = np.clip(np.round(np.hstack([left, right])), 0, 255)
        out.append(np.stack([g, 0.9 * g, 0.8 * g], -1).astype(np.uint8).reshape(-1))
    return out


def _record_live(monkeypatch, sel_mod, od4_mod):
    got = []

    class Recording(sel_mod.Selflocalization):
        def __init__(self, config, **kwargs):
            super().__init__(config, **kwargs)
            got.append(config)

        def track(self, left, right=None, timestamp=0.0):
            got.append((np.array(left), np.array(right), timestamp))

    monkeypatch.setattr(sel_mod, "Selflocalization", Recording)
    monkeypatch.setattr(od4_mod, "OD4Session", lambda *a, **k: Recorder())
    return got


@pytest.mark.parametrize("extra", [["--resize=0.5"], RECTIFY_FLAGS], ids=["resize", "rectify"])
def test_live_loop_matches_reference(extra, monkeypatch):
    raws = _raw_frames()
    argv = LIVE_FLAGS + extra
    got = _record_live(monkeypatch, tsel, tod4)
    raw_cfg = tconfig.config_from_flags(argv)
    frames = [(tshm._to_gray(raw, raw_cfg), 0.1 * i) for i, raw in enumerate(raws)]
    assert tcli.main(argv, device="cpu", frames=frames) == 0

    jgot = _record_live(monkeypatch, jsel, jod4)
    jraw_cfg = jconfig.config_from_flags(argv)
    jframes = [(jshm._to_gray(raw, jraw_cfg), 0.1 * i) for i, raw in enumerate(raws)]
    monkeypatch.setattr(jshm, "shared_memory_frames", lambda config: iter(jframes))
    assert jcli.main(argv) == 0

    for (img, _), (jimg, _) in zip(frames, jframes):
        np.testing.assert_array_equal(img, jimg)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(jgot[0])
    h, w = (128, 256) if "--resize=0.5" in extra else (256, 512)
    assert (got[0].camera.height, got[0].camera.width) == (h, w)
    assert len(got) == len(jgot) == 1 + len(raws)
    # resized: within 1e-3 grey levels; rectified: the maps agree within
    # 1e-3 px (tests/test_torch_undistort.py) and an 8-bit image changes by
    # at most 255 grey levels over a pixel, and most pixels within 1e-3
    atol = 1e-3 if "--resize=0.5" in extra else 255 * 1e-3
    for (left, right, ts), (jleft, jright, jts) in zip(got[1:], jgot[1:]):
        assert left.shape == right.shape == (h, w) and ts == jts
        for out, ref in ((left, jleft), (right, jright)):
            np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
            assert np.mean(np.abs(out - ref) <= 1e-3) > 0.95


def test_kitti_cli_matches_reference(tmp_path, monkeypatch):
    """Both CLIs over one directory, the port with the reference's front
    end and RANSAC sets, both in the synchronous schedule."""
    n = 6
    _kitti_dir(tmp_path / "ref", n)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    jcfg = jconfig.config_from_flags([f"--kittiPath={tmp_path}"] + CLI_FLAGS)
    made = []

    class JSel(jsel.Selflocalization):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.slam.force_sync_decisions = True
            self.slam._pose_solver = None    # the single-device solve the port implements
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
    assert tcli.main([f"--kittiPath={tmp_path / 'port'}"] + CLI_FLAGS, device="cpu") == 0
    jslam_ = made[0].slam
    jslam_.finish()
    ref = jslam_.corrected_trajectory()
    est = chip_smoke.read_kitti_poses(tmp_path / "port" / "poses.txt")
    assert len(est) == len(ref) == n
    for i, (T, T_ref) in enumerate(zip(est, ref)):
        assert np.linalg.norm(T[:3, 3] - T_ref[:3, 3]) < 5e-3, f"frame {i}"
        cos = np.clip((np.trace(T_ref[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)
        assert np.arccos(cos) < 1e-3, f"frame {i}"
    assert made[1].slam.n_keyframes == jslam_.n_keyframes


@pytest.mark.slow
def test_kitti_cli_reference_run(tmp_path, monkeypatch):
    """The reference package's CLI over ``chip_smoke.py``'s phase 19
    directory (phase 9's 24 frames at KITTI size, deploy/docker-compose.yml's
    flags) on the CPU, held to the phase's gates; prints the ATE of its
    poses.txt and of its re-chained trajectory after ``finish()``, which set
    the phase's bound."""
    cfg = tconfig.SystemConfig()
    lefts, rights, gt, _ = tsyn.render_stereo_sequence(cfg, **chip_smoke.SERVICE_DRIVE)
    chip_smoke.write_kitti_dir(tmp_path, lefts, rights, cfg.camera.fps)
    made, lost = [], []

    class JSel(jsel.Selflocalization):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.slam._pose_solver = None    # the single-device solve the port implements
            made.append(self)

        def track(self, *args, **kwargs):
            T = super().track(*args, **kwargs)
            lost.append(self.slam.lost)
            return T

    monkeypatch.setattr(jsel, "Selflocalization", JSel)
    assert jcli.main([f"--kittiPath={tmp_path}"] + chip_smoke.SERVICE_FLAGS) == 0
    n = len(lefts)
    est = chip_smoke.read_kitti_poses(tmp_path / "poses.txt")
    assert len(est) == n and all(np.isfinite(T).all() for T in est)
    assert (tmp_path / "map.txt").stat().st_size > 0
    assert len((tmp_path / "fps.txt").read_text().strip().splitlines()) == n
    slam = made[0].slam
    ate = ttraj.ate_rmse(est, list(gt))
    slam.finish()
    ate_corr = ttraj.ate_rmse(slam.corrected_trajectory(), list(gt))
    print(f"reference CLI over phase 19's directory: {slam.n_keyframes} keyframes, lost at "
          f"{[i for i, x in enumerate(lost) if x]}, ATE of poses.txt {ate:.4f} m, re-chained "
          f"after finish() {ate_corr:.4f} m (align=True)")
    assert not any(lost) and not slam.lost
    assert slam.n_keyframes >= 5
    assert ate < chip_smoke.SERVICE_ATE_BOUND_M and ate_corr < chip_smoke.SERVICE_ATE_BOUND_M
