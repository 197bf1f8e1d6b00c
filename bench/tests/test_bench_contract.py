"""BENCHMARK.json has the shape the harness and its checker expect, and
every configuration, traffic mix and metric it names has its file."""
from __future__ import annotations

import json
import re

import pytest

from bench import check, harness
from bench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and BENCH["command"][1] == "bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]
    assert all(k in data for k in conf["reduced"])
    assert 0 < len(conf["source"]) <= 200 and 0 < len(conf["why"]) <= 200
    assert set(data["limits"]) == set(check.NAMES)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert (ROOT / "bench" / "traffic" / f"{cell['traffic']}.json").exists()
    assert cell["chips"] == 1 and 0 < len(cell["why"]) <= 200
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    per_layer = m in BENCH["per_layer"]
    extra = {"layer", "moves"} if per_layer else {"bound"}
    assert METRIC_KEYS | extra <= set(m) <= METRIC_KEYS | extra | {"workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    assert callable(harness.reader(ROOT, m["name"]))
    if per_layer:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
