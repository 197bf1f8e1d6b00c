"""The runner end to end on the CPU at a tiny size, with the port on the
CPU: one well-formed result line for each cell, traced and not."""
from __future__ import annotations

import json
import time

import pytest

from bench import harness
from bench import run as cli
from bench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _line(capsys, out):
    cli.emit(out)
    cap = capsys.readouterr()
    return json.loads(cap.out.strip().splitlines()[-1]), cap.err


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload, traced, tiny_cell, cache_base, capsys,
                     loaded_before):
    cell = tiny_cell(workload)
    out = harness.run(ROOT, cell, 2 ** 33 + 17, 1.0, bool(traced), "cpu",
                      time.perf_counter(), lambda m: None, cache_base)
    line, err = _line(capsys, out)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = cell.per_layer if traced else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    # the CPU has no device trace: only the device metrics are missing
    missing = set(units) - set(line["metrics"])
    assert all(m.startswith("device_idle_share") for m in missing)
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for name, text in zip(line["checks"], tail):
        assert text.startswith(f"check {name} = ")


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "")     # restored after the test
    rc = cli.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    cap = capsys.readouterr()
    assert rc != 0 and cap.out == ""


def test_jax_loaded_means_no_result(tiny_cell, cache_base, monkeypatch):
    monkeypatch.setattr(harness, "forbidden_modules", lambda: ["repro"])
    out = harness.run(ROOT, tiny_cell(CELLS[0]), 3, 0.5, False, "cpu",
                      time.perf_counter(), lambda m: None, cache_base)
    assert out is None
