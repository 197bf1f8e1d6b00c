"""`correct` has to come out false for the control and for each fault the
query cells can have, and true for the program as it is.

The control is the reference put in the program's place and computed in
bfloat16. The faults are planted under the timed path, in the search loop
the window drives: a search whose hops leave its state unchanged, half of
each call's queries left out (their answers copied from the rest), and one
answer of every call altered where it is produced. (The cells run on one
chip: there is no exchange between chips to leave out.)"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest

from bench import check, control, harness
from bench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _limits_hold(r: dict, limits: dict) -> bool:
    return all(r[k] <= limits[k] for k in check.NAMES if k in r)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload, tiny_cell, cache_base,
                                          capsys):
    cell = tiny_cell(workload)
    lines = control.report(cell, "1,2", "3,4,5", "cpu", cache_base)
    limits = cell.config["limits"]
    for r in lines:
        assert _limits_hold(r, limits) == (r["kind"] == "program"), r


@pytest.mark.parametrize("config", ["deep1m-octopusann", "sift1m-diskann"])
def test_codebook_control_fails_and_program_passes(config, capsys):
    from bench import harness
    cell = next(harness.load_cell(ROOT, w) for w in CELLS
                if harness.load_cell(ROOT, w).config_name == config)
    cell.config["n"] = 4096
    limit = cell.config["limits"]["codebook_gap"]
    lines = {r["kind"]: r["codebook_gap"]
             for r in control.codebook_report(cell.config, "cpu")}
    assert lines["program"] <= limit < lines["control"]


def test_codebook_gap_reads_a_moved_centroid():
    from bench.reference import codebook
    ref = np.random.default_rng(0).normal(size=(2, 256, 4)).astype(np.float32)
    mine = ref.copy()
    assert codebook.gap(mine, ref) == 0.0
    mine[1, 7] += 0.5 * np.linalg.norm(ref[1, 7])
    assert codebook.gap(mine, ref) >= 0.5 * np.linalg.norm(ref[1, 7]) / max(
        np.linalg.norm(ref[1, 7]), np.median(np.linalg.norm(ref, axis=-1)))
    assert codebook.gap(mine[:1], ref) == float("inf")


def _stuck(inner):
    def f(*a, **kw):
        return inner(*a, **dict(kw, max_iters=0))
    return f


def _half(inner):
    def f(page_vids, page_vecs, page_nbrs, v2p, v2s, cent, codes, cached, q,
          entries, valid, **kw):
        h = max(1, q.shape[0] // 2)
        out = inner(page_vids, page_vecs, page_nbrs, v2p, v2s, cent, codes,
                    cached, q[:h], entries[:h], valid[:h], **kw)
        take = np.arange(q.shape[0]) % h
        return {k: v[take] for k, v in out.items()}
    return f


def _altered(inner):
    def f(*a, **kw):
        out = inner(*a, **kw)
        ids = out["ids"].clone()
        ids[0, 0] = (ids[0, 1] + 1) % a[3].shape[0]
        out["ids"] = ids
        return out
    return f


@pytest.mark.parametrize("fault", [_stuck, _half, _altered])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, tiny_cell, cache_base,
                              monkeypatch, loaded_before):
    from repro_torch.core import search_kernel
    monkeypatch.setattr(search_kernel, "_search_batch",
                        fault(search_kernel._search_batch))
    out = harness.run(ROOT, tiny_cell(workload), 77, 1.0, False, "cpu",
                      time.perf_counter(), lambda m: None, cache_base)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_comparison_names_every_number():
    assert set(check.NAMES) == set(json.loads(
        (ROOT / "bench/configs/deep1m-octopusann.json").read_text())["limits"])
