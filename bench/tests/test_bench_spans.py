"""The split of a call by the program's host-clock spans and its reading
over a profiler trace (bench/spans.py), on hand-made records, with nothing
to read, and end to end on a tiny cell on the CPU."""
from __future__ import annotations

import pytest

from bench import spans
from bench.tests.conftest import ROOT
from repro_torch.obs import Span


def _span(name, t0, dur, parent=None, qid=0, args=None):
    return Span(name=name, cat="search", t0_us=float(t0), dur_us=float(dur),
                track="search", qid=qid, args=args, parent=parent)


def _call(qid, t0):
    """One call of 100 us: memgraph 20 (one mem.hop with its sync), upload
    5, hops 60 (two search.hop, each ending in a sync of 10), readback 10,
    stats 3; the first check of each loop is a sync of 2."""
    a = {"queries": 4, "batches": 1, "hop_iters": 2, "mem_iters": 1,
         "syncs": 5}
    return [
        _span("search.call", t0, 100, None, qid, a),               # 0
        _span("search.memgraph", t0 + 1, 20, 0, qid),              # 1
        _span("search.sync", t0 + 2, 2, 1, qid),                   # 2
        _span("mem.hop", t0 + 5, 15, 1, qid),                      # 3
        _span("search.sync", t0 + 15, 4, 3, qid),                  # 4
        _span("search.upload", t0 + 21, 5, 0, qid),                # 5
        _span("search.hops", t0 + 26, 60, 0, qid),                 # 6
        _span("search.sync", t0 + 27, 2, 6, qid),                  # 7
        _span("search.hop", t0 + 30, 25, 6, qid),                  # 8
        _span("search.sync", t0 + 45, 10, 8, qid),                 # 9
        _span("search.hop", t0 + 55, 30, 6, qid),                  # 10
        _span("search.sync", t0 + 75, 10, 10, qid),                # 11
        _span("search.readback", t0 + 86, 10, 0, qid),             # 12
        _span("search.stats", t0 + 96, 3, 0, qid),                 # 13
    ]


def _fix(spans_, base):
    """Re-point parents after concatenating calls."""
    for s in spans_:
        if s.parent is not None:
            s.parent += base
    return spans_


def test_split_on_hand_made_spans():
    rec = _call(0, 0.0) + _fix(_call(1, 1000.0), 14)
    got = spans.split(rec, first=1)
    assert got["calls"] == 1
    assert got["call_ms"] == pytest.approx(0.1)
    assert got["stage_ms"] == pytest.approx({
        "search.memgraph": 0.020, "search.upload": 0.005,
        "search.hops": 0.060, "search.readback": 0.010,
        "search.stats": 0.003})
    assert got["stage_cover"] == pytest.approx(0.98)
    # syncs 2 + 4 + 2 + 10 + 10, readback 10
    assert got["sync_wait_share"] == pytest.approx(38.0)
    assert got["hop_iters_per_call"] == 2 and got["mem_iters_per_call"] == 1
    assert got["syncs_per_call"] == 5 and got["queries_per_call"] == 4
    both = spans.split(rec)
    assert both["calls"] == 2 and both["stage_cover"] == pytest.approx(0.98)


def test_split_with_nothing_to_read():
    assert spans.split([]) is None
    assert spans.split(_call(0, 0.0), first=1) is None


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_over_profile_on_a_hand_made_trace():
    program = [{"ph": "X", "name": s.name, "ts": s.t0_us, "dur": s.dur_us}
               for s in _call(0, 10.0)]
    events = [
        _ev("user_annotation", "bench.call", 0, 120),
        # launches: 2 inside the first hop (40-65), 3 inside the second
        # (65-95), one in the upload, one after the profiled call
        _ev("cuda_runtime", "cudaLaunchKernel", 41, 1),
        _ev("cuda_runtime", "cuLaunchKernel", 50, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 66, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 70, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 80, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 32, 1),
        _ev("cuda_runtime", "cudaMemcpyAsync", 33, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 300, 1),
        _ev("user_annotation", "bench.call", 200, 120),
        # the device: busy 0-12, 45-60 and 85-100
        _ev("kernel", "k", 0, 12),
        _ev("gpu_memcpy", "c", 45, 15),
        _ev("kernel", "k", 85, 15),
    ]
    got = spans.over_profile(events, program, calls=1)
    assert got["calls"] == 1 and got["call_s"] == pytest.approx(120e-6)
    assert got["hop_spans"] == 2 and got["launches_in_hops"] == 5
    assert got["launches_per_hop"] == pytest.approx(2.5)
    # the call's pieces (us) under their innermost span, less busy time:
    # 0-10 outside (busy), 10-12 call and memgraph (busy), 12-14 sync 2,
    # 14-15 memgraph 1, 15-25 mem.hop 10, 25-29 sync 4, 29-30 mem.hop 1,
    # 30-31 memgraph 1, 31-36 upload 5, 36-37 hops 1, 37-39 sync 2, 39-40
    # hops 1, 40-55 hop 5, 55-65 sync 5, 65-85 hop 20, 85-96 busy, 96-106
    # readback 6, 106-109 stats 3, 109-110 call 1, 110-120 outside 10
    assert got["idle_by_span"] == pytest.approx({
        "search.sync": 13e-6, "search.memgraph": 2e-6, "mem.hop": 11e-6,
        "search.upload": 5e-6, "search.hops": 2e-6, "search.hop": 25e-6,
        "search.readback": 6e-6, "search.stats": 3e-6, "search.call": 1e-6,
        spans.OUTSIDE: 10e-6}, abs=1e-12)
    assert got["device_idle_share"] == pytest.approx(100 * 78 / 120)
    assert got["dispatch_idle_share"] == pytest.approx(100 * 36 / 120)
    assert got["call_start_lag_us"] == pytest.approx([10.0])
    assert got["call_end_margin_us"] == pytest.approx([10.0])


def test_over_profile_with_nothing_to_read():
    call = [_ev("user_annotation", "bench.call", 0, 10)]
    assert spans.over_profile(call, []) is None
    assert spans.over_profile([_ev("kernel", "k", 0, 5)], []) is None


@pytest.mark.parametrize("workload", ["deep1m-octopusann.batch256",
                                      "sift1m-diskann.online"])
def test_measure_on_a_tiny_cell(workload, tiny_cell, cache_base):
    cell = tiny_cell(workload)
    # profile one call (or half a second), then leave calls after it
    if cell.mix["loop"] == "closed":
        cell.mix.update(batch=8, profile_calls=1)
    else:
        cell.mix["profile_seconds"] = 0.5
    out = spans.measure(ROOT, cell, 2 ** 33 + 5, 3.0, 1, "cpu",
                        lambda m: None, cache_base)
    assert out["profile"] is None        # the CPU has no device trace
    # the harness's traced run profiles the same first calls
    if cell.mix["loop"] == "closed":
        assert out["profiled_calls"] == 1
    assert 1 <= out["profiled_calls"] < out["window_calls"]
    s = out["split"]
    assert s["calls"] > 0 and s["batches_per_call"] == 1
    assert 0.9 < s["stage_cover"] <= 1.0
    assert s["hop_iters_per_call"] >= out["hops_per_query"]
    assert (s["mem_iters_per_call"] > 0) == workload.startswith("deep")
    assert s["syncs_per_call"] == pytest.approx(
        s["hop_iters_per_call"] + s["mem_iters_per_call"]
        + (2 if workload.startswith("deep") else 1))
    c = out["cost"]
    assert c["pairs"] == 1 and c["spans_per_call"] > 0
    assert c["us_per_span"] > 0
