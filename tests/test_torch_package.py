"""The port as a package: no jax, the same constant tables, config and
synthetic fixture as the reference package."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import extractor as jext
from opendlv_perception_vision_orbslam2_tpu.ops import image as jimage
from opendlv_perception_vision_orbslam2_tpu.ops import orb as jorb
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu.utils import synthetic as jsyn
from opendlv_perception_vision_orbslam2_tpu_torch.models import extractor as text
from opendlv_perception_vision_orbslam2_tpu_torch.ops import image as timage
from opendlv_perception_vision_orbslam2_tpu_torch.ops import orb as torb
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "opendlv_perception_vision_orbslam2_tpu"
PORT = ROOT / "opendlv_perception_vision_orbslam2_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import opendlv_perception_vision_orbslam2_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not any(m.startswith("opendlv_perception_vision_orbslam2_tpu.") for m in sys.modules)
print(len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20   # every module of the port was imported


@pytest.mark.parametrize("name", ["config.py", "trajectory.py"])
def test_jax_free_utils_are_verbatim_copies(name):
    assert (PORT / "utils" / name).read_bytes() == (JAX_PKG / "utils" / name).read_bytes()


def test_system_config_fields_equal():
    assert dataclasses.asdict(tconfig.SystemConfig()) == dataclasses.asdict(jconfig.SystemConfig())
    argv = ["--Camera.fx=500", "--ORBextractor.nFeatures=1000", "--ThDepth=40", "--verbose=1"]
    assert (dataclasses.asdict(tconfig.config_from_flags(argv))
            == dataclasses.asdict(jconfig.config_from_flags(argv)))


def test_constant_tables_equal():
    for name in ("brief_pattern", "_moment_matrix", "_patch_blur_matrix",
                 "_binned_sample_indices"):
        np.testing.assert_array_equal(getattr(torb, name)(), getattr(jorb, name)())
    for args in ((376, 1241, 8, 1.2), (256, 512, 4, 1.2)):
        ref = jimage._pyramid_matrices(*args)
        out = timage._pyramid_matrices(*args)
        assert len(out) == len(ref)
        for (mh_o, mw_o), (mh_r, mw_r) in zip(out, ref):
            np.testing.assert_array_equal(mh_o, mh_r)
            np.testing.assert_array_equal(mw_o, mw_r)
        assert timage.pyramid_shapes(*args[:4]) == jimage.pyramid_shapes(*args[:4])
    for args in ((2000, 1.2, 8), (600, 1.2, 4)):
        assert text.per_level_budgets(*args) == jext.per_level_budgets(*args)


def test_renderer_matches_reference():
    """Within 1e-3 intensity: overlapping sprites accumulate in another order."""
    cfg_j = jconfig.SystemConfig(camera=jconfig.CameraConfig(
        fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256))
    cfg_t = tconfig.SystemConfig(camera=tconfig.CameraConfig(
        fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256))
    lj, rj, pj, wj = jsyn.render_stereo_sequence(cfg_j, n_frames=4, n_points=500, seed=5,
                                                 step=0.25)
    lt, rt, pt, wt = tsyn.render_stereo_sequence(cfg_t, n_frames=4, n_points=500, seed=5,
                                                 step=0.25)
    np.testing.assert_array_equal(wt.points, np.asarray(wj.points))
    np.testing.assert_array_equal(wt.patterns, np.asarray(wj.patterns))
    np.testing.assert_array_equal(pt, np.asarray(pj))
    np.testing.assert_allclose(lt, np.asarray(lj), rtol=0, atol=1e-3)
    np.testing.assert_allclose(rt, np.asarray(rj), rtol=0, atol=1e-3)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.3, -0.2, 1.5]
    one_j = jsyn.render_view(jnp.asarray(T), wj, 256, 512, 320.0, 320.0, 256.0, 128.0)
    one_t = tsyn.render_view(T, wt, 256, 512, 320.0, 320.0, 256.0, 128.0)
    np.testing.assert_allclose(one_t, np.asarray(one_j), rtol=0, atol=1e-3)
