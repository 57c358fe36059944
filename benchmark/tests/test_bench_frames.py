"""The traffic generator: the same seed gives the same frames, another seed
another world, and frames are quantised as the datasets' PNGs are."""

import json

import numpy as np

import _tiny  # noqa: F401
from harness import frames, spec


# the road traffic and the KITTI configuration wait for a cell (PERF.md, section 7)
MIXES = {"road": ("kitti00-stereo", "road-explore"), "desk": ("tum1-rgbd", "desk-explore")}


def _sequence(mix, seed):
    config, traffic = MIXES[mix]
    cfg = json.loads((spec.BENCH_DIR / "configs" / f"{config}.json").read_text())
    return frames.Sequence(spec.traffic(traffic), frames.camera_from_flags(cfg["flags"]), seed)


def test_stereo_frames_are_uint8_and_repeat_per_seed():
    a = _sequence("road", 2**31 + 7)
    b = _sequence("road", 2**31 + 7)
    c = _sequence("road", 3)
    fa, fb, fc = a.frame(5), b.frame(5), c.frame(5)
    assert all(x.dtype == np.uint8 and x.shape == (376, 1241) for x in fa)
    assert all(np.array_equal(x, y) for x, y in zip(fa, fb))
    assert not np.array_equal(fa[0], fc[0])
    assert not np.array_equal(fa[0], fa[1])       # the two eyes differ
    assert np.allclose(a.pose(0), np.eye(4))


def test_rgbd_frames_hold_gray_uint8_and_depth_uint16():
    a = _sequence("desk", 11)
    gray, depth = a.frame(30)
    assert gray.dtype == np.uint8 and gray.shape == (480, 640)
    assert depth.dtype == np.uint16
    z = depth[depth > 0] / 5000.0
    assert 0.5 <= z.min() and z.max() <= 6.0
    assert np.array_equal(depth, _sequence("desk", 11).frame(30)[1])


def test_the_paths_step_as_their_traffic_says():
    for cell, step in (("road", 1.06), ("desk", 0.0137)):
        s = _sequence(cell, 0)
        c = [-s.pose(i)[:3, :3].T @ s.pose(i)[:3, 3] for i in range(40)]
        d = np.linalg.norm(np.diff(c, axis=0), axis=1)
        assert np.allclose(d, step, rtol=1e-3)
