"""The port's I/O layer against the reference package: the OD4 wire format,
map chunking, WGS84, the map checkpoint across packages, the PNG decoders,
the KITTI runner and the CLI's KITTI mode on the CPU.

Tolerances: envelopes, chunks and checkpoints are compared byte for byte
(descriptors bit for bit); WGS84 round trips within 1 cm (tests/test_io.py's
bar); decoded PNGs exactly.
"""

from pathlib import Path

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.io import checkpoint as jckpt
from opendlv_perception_vision_orbslam2_tpu.io import messages as jmsg
from opendlv_perception_vision_orbslam2_tpu.models import map_state as jmap
from opendlv_perception_vision_orbslam2_tpu.utils import wgs84 as jwgs84
from opendlv_perception_vision_orbslam2_tpu_torch import __main__ as tcli
from opendlv_perception_vision_orbslam2_tpu_torch.io import checkpoint as tckpt
from opendlv_perception_vision_orbslam2_tpu_torch.io import kitti as tkitti
from opendlv_perception_vision_orbslam2_tpu_torch.io import messages as tmsg
from opendlv_perception_vision_orbslam2_tpu_torch.models import map_state as tmap
from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization as tsel
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic as tsyn
from opendlv_perception_vision_orbslam2_tpu_torch.utils import wgs84 as twgs84

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256, fps=10.0)
ORB = dict(n_features=400, max_keypoints=512, n_levels=3)
# tests/test_io.py's CLI flags for the 512x256 sequence
CLI_FLAGS = ["--Camera.fx=320", "--Camera.fy=320", "--Camera.cx=256", "--Camera.cy=128",
             "--Camera.bf=160", "--Camera.fps=10", "--width=512", "--height=256",
             "--ORBextractor.nFeatures=400", "--ORBextractor.nLevels=3"]


class Recorder:
    """An OD4 session stand-in that keeps what was sent."""

    def __init__(self):
        self.sent = []
        self.closed = False

    def send(self, message, timestamp=None):
        self.sent.append(message)

    def close(self):
        self.closed = True


def _kitti_dir(path, n, seed=2, step=0.2):
    """tests/test_io.py's generated sequence as a KITTI-layout directory;
    returns the ground-truth world->camera poses."""
    cfg = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM), orb=tconfig.OrbConfig(**ORB))
    lefts, rights, gt, _ = tsyn.render_stereo_sequence(cfg, n_frames=n, n_points=400, seed=seed,
                                                       step=step)
    chip_smoke.write_kitti_dir(path, lefts, rights, fps=10.0)
    return cfg, gt


@pytest.mark.parametrize("name", ["io/messages.py", "io/od4.py", "io/shared_memory.py",
                                  "utils/wgs84.py"])
def test_jax_free_io_modules_are_verbatim_copies(name):
    assert ((ROOT / "opendlv_perception_vision_orbslam2_tpu_torch" / name).read_bytes()
            == (ROOT / "opendlv_perception_vision_orbslam2_tpu" / name).read_bytes())


@pytest.mark.parametrize("kind", ["geolocation", "map", "point_cloud"])
def test_envelopes_byte_equal(kind):
    def make(pkg):
        if kind == "geolocation":
            return pkg.Geolocation(latitude=57.70716, longitude=11.93827, altitude=-1.25,
                                   heading=2.5)
        if kind == "map":
            return pkg.OrbslamMap(camera_coordinates=b"1.000:2.000:3.000",
                                  camera_rotation=b"1.000000:0.000000", map_coordinate_index=3,
                                  map_coordinates=b"4.000:-5.500:6.125")
        return pkg.PointCloudReading(start_azimuth=0.5, end_azimuth=-0.5, entries_per_azimuth=12,
                                     distances=b"hello", number_of_bits_for_intensity=3)

    for stamp, ts in ((0, 0.0), (7, 123.5), (300, 1.7e9 + 0.123456)):
        out = tmsg.encode_envelope(make(tmsg), sender_stamp=stamp, timestamp=ts)
        assert out == jmsg.encode_envelope(make(jmsg), sender_stamp=stamp, timestamp=ts)
        assert out[:2] == b"\x0d\xa4" and len(out) == 5 + int.from_bytes(out[2:5], "little")


def test_map_chunking_matches_reference():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-50, 50, (2000, 3)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.5, -0.25, 3.0]
    out = tmsg.chunk_map_messages(T, pts.tolist())
    ref = jmsg.chunk_map_messages(T, pts.tolist())
    # 2000 points = 6000 coords -> ceil(6000/2500) = 3 chunks (tests/test_io.py)
    assert [m.map_coordinate_index for m in out] == [0, 1, 2]
    assert len(out[0].map_coordinates.decode().split(":")) == (tmsg.CHUNK_COORDS // 3) * 3
    assert [m.encode() for m in out] == [m.encode() for m in ref]


def test_wgs84_roundtrip_matches_reference():
    ref = (57.70716, 11.93827)
    for xy in [(100.0, 50.0), (-250.0, 400.0), (0.0, 0.0)]:
        latlon = twgs84.from_cartesian(ref, xy)
        assert latlon == jwgs84.from_cartesian(ref, xy)
        back = twgs84.to_cartesian(ref, latlon)
        assert abs(back[0] - xy[0]) < 0.01 and abs(back[1] - xy[1]) < 0.01


def _random_jax_map():
    """A reference-package map with every field filled from a seed;
    descriptors use all 32 bits."""
    rng = np.random.default_rng(4)
    m = jmap.empty_map(8, 128, 64)
    out = {}
    for name in jmap.MapState._fields:
        a = np.asarray(getattr(m, name))
        if a.dtype == np.bool_:
            out[name] = rng.random(a.shape) < 0.5
        elif a.dtype == np.uint32:
            out[name] = rng.integers(0, 2**32, a.shape, dtype=np.uint32)
        elif np.issubdtype(a.dtype, np.integer):
            out[name] = rng.integers(-5, 1000, a.shape).astype(a.dtype)
        else:
            out[name] = rng.standard_normal(a.shape).astype(a.dtype)
    return jmap.MapState(**{k: jnp.asarray(v) for k, v in out.items()}), out


def _fields_equal(port_map, ref_arrays):
    for name in tmap.MapState._fields:
        a = getattr(port_map, name).numpy()
        b = np.asarray(ref_arrays[name])
        if b.dtype == np.uint32:
            assert a.dtype == np.int32
            a = a.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_checkpoint_roundtrip_across_packages(tmp_path):
    """JAX save -> port load, and port save -> JAX load, bit for bit."""
    m, arrays = _random_jax_map()
    jckpt.save_map(str(tmp_path / "j.npz"), m)
    tm = tckpt.load_map(str(tmp_path / "j.npz"), device="cpu")
    _fields_equal(tm, arrays)
    # port -> reference, after a change on the port's side
    tm = tm._replace(pt_pos=tm.pt_pos + 1.0, next_kf_id=tm.next_kf_id + 3)
    tckpt.save_map(str(tmp_path / "t.npz"), tm)
    back = jckpt.load_map(str(tmp_path / "t.npz"))
    _fields_equal(tm, {k: np.asarray(v) for k, v in back._asdict().items()})
    # tests/test_io.py's bar on the port alone
    assert int(tckpt.load_map(str(tmp_path / "t.npz"), device="cpu").next_kf_id) == \
        int(arrays["next_kf_id"]) + 3


def test_checkpoint_without_loop_edges_loads_empty_ones(tmp_path):
    m, arrays = _random_jax_map()
    old = {k: v for k, v in arrays.items() if not k.startswith("loop_")}
    np.savez_compressed(tmp_path / "old.npz", **old)
    tm = tckpt.load_map(str(tmp_path / "old.npz"), device="cpu")
    empty = tmap.empty_map(8, 128, 64, device="cpu")
    for name in ("loop_i", "loop_j", "loop_T", "loop_s", "loop_valid"):
        assert torch.equal(getattr(tm, name), getattr(empty, name)), name
    _fields_equal(tm._replace(**{k: torch.from_numpy(np.asarray(arrays[k]))
                                 for k in arrays if k.startswith("loop_")}), arrays)


def test_load_map_defaults_to_the_card(tmp_path):
    m, _ = _random_jax_map()
    jckpt.save_map(str(tmp_path / "j.npz"), m)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tckpt.load_map(str(tmp_path / "j.npz"))


def test_png_decoders_agree(tmp_path):
    """The native decoder (built here at first use) equals PIL; PIL reads
    the writer of chip_smoke.py's phase 19."""
    from PIL import Image

    from opendlv_perception_vision_orbslam2_tpu_torch.native import png_native

    arr = np.arange(64 * 48, dtype=np.uint8).reshape(48, 64) % 251
    chip_smoke.write_png_gray(tmp_path / "a.png", arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), arr)
    out = png_native.decode_gray(str(tmp_path / "a.png"))
    if out is None:
        pytest.skip("native library not built (no compiler or libpng headers)")
    np.testing.assert_array_equal(out, arr.astype(np.float32))
    dec, name = tkitti.decode_png(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(dec, out)
    assert name == "native"


def test_kitti_runner_on_generated_sequence(tmp_path):
    """tests/test_io.py's runner bars on the port's VO (a bare engine), with
    the runner publishing a pose per frame, each equal to the logged one."""
    from opendlv_perception_vision_orbslam2_tpu_torch.models.tracking import (
        StereoVisualOdometry,
    )

    n = 4
    cfg, _ = _kitti_dir(tmp_path, n)
    assert tkitti.load_times(str(tmp_path)) == [i / 10.0 for i in range(n)]
    vo = StereoVisualOdometry(cfg, device="cpu")
    rec = Recorder()
    runner = tkitti.KittiRunner(str(tmp_path), vo, publisher=rec)
    traj = runner.run()
    assert len(traj) == n
    assert runner.shutdown_stats()["fps"] > 0
    assert runner._frames.lags == [0] * n          # on the CPU a fetch lands at once
    assert runner.decoder in ("native", "PIL")
    assert [m.encode() for m in rec.sent] == [
        tsel.pose_to_geolocation(T.numpy(), 0.0, 0.0, 0.0).encode() for T in vo.trajectory]


def _recording(monkeypatch, made):
    class Recording(tsel.Selflocalization):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(tsel, "Selflocalization", Recording)


def test_cli_usage_exit():
    assert tcli.main([], device="cpu") == 1
    assert tcli.main(["--cid=111", "--name=cam0"], device="cpu") == 1


def test_cli_kitti_mode_end_to_end(tmp_path, monkeypatch):
    """``main([... --kittiPath], device="cpu")`` with tests/test_io.py's bars;
    the dumps are written after ``finish()``: poses.txt is the re-chained
    trajectory, map.txt the settled map, fps.txt one line per frame with the
    map-point count each frame's message carried."""
    n = 6
    _, gt = _kitti_dir(tmp_path, n)
    made = []
    _recording(monkeypatch, made)
    assert tcli.main([f"--kittiPath={tmp_path}"] + CLI_FLAGS, device="cpu") == 0
    poses = (tmp_path / "poses.txt").read_text().strip().splitlines()
    assert len(poses) == n and len(poses[0].split()) == 12
    assert (tmp_path / "map.txt").stat().st_size > 0
    fps_lines = (tmp_path / "fps.txt").read_text().strip().splitlines()
    assert len(fps_lines) == n
    sel = made[0]
    slam = sel.slam
    assert slam.device.type == "cpu" and slam._decision_pending is None
    assert not slam.lost
    est = chip_smoke.read_kitti_poses(tmp_path / "poses.txt")
    for T, T_ref in zip(est, slam.corrected_trajectory()):
        np.testing.assert_allclose(T, T_ref, rtol=0, atol=1e-5)
    n_map = int(slam.map.pt_valid.sum())
    assert len((tmp_path / "map.txt").read_text().splitlines()) == n_map
    assert [int(line.split()[1]) for line in fps_lines] == sel.map_sizes
    from opendlv_perception_vision_orbslam2_tpu_torch.utils import trajectory as ttraj

    assert ttraj.ate_rmse(est, list(gt)) < 0.1
