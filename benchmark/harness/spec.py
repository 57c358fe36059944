"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration ``<config>``: ``benchmark/configs/<config>.json``;
- a traffic mix ``<traffic>``: ``benchmark/traffic/<traffic>.json``;
- a per-layer metric ``<name>``: ``benchmark/metrics/<name>.py``, whose
  ``read(record)`` returns the metric's value or None.

A later cell or metric is added with files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    return json.loads(config_file(bench, name).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def metric_reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
