"""BENCHMARK.json keeps the contract's names, and every file it names is
found by name."""

import json

import _tiny  # noqa: F401
from harness import frames, spec

BENCH = spec.load()


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    assert all(spec.NAME.match(n) for n in names), [n for n in names if not spec.NAME.match(n)]
    units = [m["unit"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    assert all(spec.UNIT.match(u) for u in units)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got)), kind


def test_every_file_is_found_by_name():
    for c in BENCH["configs"]:
        cfg = spec.config(BENCH, c["name"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) and cfg["warmup"]["frames"] > 0
        frames.camera_from_flags(cfg["flags"])
    for w in BENCH["workloads"]:
        assert spec.traffic(w["traffic"])["frames"] in ("stereo", "rgbd")
        assert spec.config(BENCH, w["config"])["chips"] == w["chips"]
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert m["moves"] in {x["name"] for x in spec.metrics_of(BENCH, cell, "end_to_end")}


def test_the_file_is_within_the_contract_limits():
    text = (spec.ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    assert set(json.loads(text)) == {"command", "paths", "run_seconds", "configs", "workloads",
                                     "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
