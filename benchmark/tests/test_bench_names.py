"""BENCHMARK.json against the contract's characters and keys, and every
file it names found where the harness looks for it."""
import re

import pytest

from benchmark import harness

BENCH = harness.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert all(PATH.fullmatch(p) and ".." not in p for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == KEYS["config"]
    assert NAME.fullmatch(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert (harness.ROOT / entry["file"]).is_file()
    assert all(NAME.fullmatch(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
    assert entry["reduced"] == harness.load_json(harness.ROOT / entry["file"])["reduced"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workloads(entry):
    assert set(entry) == KEYS["workload"]
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    assert NAME.fullmatch(entry["name"]) and NAME.fullmatch(entry["traffic"])
    assert entry["chips"] == 1 and _line(entry["why"])
    cell = harness.find_cell(entry["name"])
    assert (harness.HERE / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert {m["moves"] for m in cell.per_layer} <= names


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[kind]:
        assert set(m) - {"workloads"} == KEYS[kind], m["name"]
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert _line(m["layer"])
            assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_unique_names():
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_limits_files():
    for w in BENCH["workloads"]:
        limits = harness.find_cell(w["name"]).limits
        assert limits and all(v >= 0 for v in limits.values())
