"""BENCHMARK.json against the contract's shape rules, and every file a cell
names found by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(_text(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check at 24 cells must fit: (2 + 14·24) runs, 2·90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_texts():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        group = [e["name"] for e in SPEC[key]]
        assert len(group) == len(set(group))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert _text(m["layer"])
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert _text(e["why"])
    for c in SPEC["configs"]:
        assert _text(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    setup = {m["name"]: m for m in SPEC["end_to_end"]}["setup_s"]
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def _reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_and_finds_its_files(cell):
    w = {x["name"]: x for x in SPEC["workloads"]}[cell]
    conf = {c["name"]: c for c in SPEC["configs"]}[w["config"]]
    assert conf["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    assert (ROOT / conf["file"]).is_file()
    assert (BENCH / "reference" / f"{w['config']}.py").is_file()
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    e2e = [m for m in SPEC["end_to_end"] if _reported(m, cell)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"] if _reported(m, cell)]
    assert layer
    for m in layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in [x["name"] for x in e2e]


def test_each_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_each_per_layer_metric_has_one_line_layer_and_a_reported_moves():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert _text(m["layer"]) and m["moves"] in e2e
