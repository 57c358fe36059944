"""The benchmark's copy of the kernels' byte and operation counts equals the
arithmetic of ``chip_smoke.py`` at PERF.md's kernel-table shapes: FAST+NMS
over KITTI's 8-level pyramid of both eyes, the ORB gather of 4000 45x45
windows and the SAD pair of the stereo match."""

import importlib.util

import pytest
import torch

import _tiny
from harness import trace

spec_ = importlib.util.spec_from_file_location("chip_smoke", _tiny.BENCH.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(spec_)
spec_.loader.exec_module(chip_smoke)


def _pyramid(gen):
    out, (h, w) = [], (376, 1241)
    for lv in range(8):
        s = 1.2 ** lv
        out.append(torch.rand((2, round(h / s), round(w / s)), generator=gen) * 255)
    return out


def test_fast_counts_match_the_card_script():
    levels = _pyramid(torch.Generator().manual_seed(0))
    for th in (7.0, 20.0):
        b, ops, _ = chip_smoke.fast_work(levels, th)
        assert trace.fast_work(levels, th) == (b, ops)
    work = trace.fast_work(levels, 7.0)
    assert trace.bound_s(*work) == pytest.approx(chip_smoke.bound_ms(*work)[0] / 1e3, rel=1e-12)


def test_gather_bytes_match_the_card_script():
    g = torch.Generator().manual_seed(1)
    img = torch.rand((376, 1241), generator=g)
    jobs = [(img, torch.randint(-10, 380, (4000,), generator=g, dtype=torch.int32),
             torch.randint(-10, 1250, (4000,), generator=g, dtype=torch.int32), 45, 45),
            (img, torch.randint(0, 370, (2000,), generator=g, dtype=torch.int32),
             torch.randint(0, 1230, (2000,), generator=g, dtype=torch.int32), 11, 11),
            (img, torch.randint(0, 370, (2000,), generator=g, dtype=torch.int32),
             torch.randint(0, 1220, (2000,), generator=g, dtype=torch.int32), 11, 21)]
    assert trace.gather_bytes(jobs) == chip_smoke.gather_bytes(jobs)
