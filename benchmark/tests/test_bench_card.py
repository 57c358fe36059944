"""The benchmark on the card: one short run of each cell is correct, and the
controls of the first are not.  Run there with
``python -m pytest benchmark/tests/test_bench_card.py -m cuda -q``."""

import json
import subprocess
import sys

import pytest

import _tiny
from harness import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(cell_name, *extra):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell_name,
                          "--seed", "424242", "--seconds", "8", "--trace", "0", *extra],
                         cwd=_tiny.BENCH.parent, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", [w["name"] for w in spec.load()["workloads"]])
def test_a_short_run_is_correct(card, cell_name):
    r = _run(cell_name)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_the_stale_control_is_not_correct_on_the_card(card):
    r = _run("tum1-rgbd.explore", "--control", "stale")
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["scale", "bf16"])
def test_each_control_is_not_correct_on_the_card(card, control):
    r = _run("tum1-rgbd.explore", "--control", control)
    assert not r["correct"], r["checks"]
