"""What the benchmark loads: never JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
in its reference nothing of the program either.  Without a card it prints
no result and exits non-zero, and so it does without the program."""

import ast
import os
import shutil
import subprocess
import sys

import _tiny
from harness import cell

JAX_SIDE = {"jax", "jaxlib", "flax", "opendlv_perception_vision_orbslam2_tpu"}
PORT = "opendlv_perception_vision_orbslam2_tpu_torch"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = [p for p in _tiny.BENCH.rglob("*.py")]
    assert files
    for p in files:
        assert not _imports(p) & JAX_SIDE, p
    assert set(cell.FORBIDDEN) == JAX_SIDE
    assert PORT not in cell.FORBIDDEN and PORT.split(".")[0] != "opendlv_perception_vision_orbslam2_tpu"


def test_the_reference_imports_nothing_of_the_program():
    for p in (_tiny.BENCH / "reference").rglob("*.py"):
        assert _imports(p) <= {"__future__", "math", "numpy"}, p


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "tum1-rgbd.explore", "--seed", "1", "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_no_result_and_a_nonzero_exit():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(_tiny.BENCH.parent, env)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA device" in out.stderr


def test_without_the_program_no_result_and_a_nonzero_exit(tmp_path):
    shutil.copy(_tiny.BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(_tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
