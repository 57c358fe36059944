"""The benchmark with one more cell, ``tiny.desk``: the desk traffic on
TUM1's RGB-D camera at half size (``tiny-rgbd.json``), small enough for the
CPU."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402

TINY = "tiny.desk"


def bench_with_tiny() -> dict:
    bench = spec.load()
    bench["configs"].append({"name": "tiny-rgbd", "file": "benchmark/tests/tiny-rgbd.json"})
    bench["workloads"].append({"name": TINY, "config": "tiny-rgbd",
                               "traffic": "desk-explore", "chips": 1})
    return bench
