"""The host-clock spans of the port's search path (`DiskIndex.search(...,
tracer=Tracer(clock="host"))`), on a small seeded index built by the port
on the CPU, for the baseline, DiskANN (vertex cache) and OctopusANN
(MemGraph, page search, dynamic width) presets: spans nest, the call's
counts equal what the search did (no hop replayed from a CUDA graph off
the card), results are the same with the tracer on
and off, the path builds nothing without one, and the stamps sit on
torch.profiler's clock."""
from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from repro_torch.core.builder import build_index
from repro_torch.core.dataset import make_dataset
from repro_torch.core.presets import get_preset
from repro_torch.core.stats import QueryStats
from repro_torch.core.vamana import build_vamana
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.obs import tracer as tracer_mod
from repro_torch.obs.export import on_profiler_clock

PRESETS = ["baseline", "diskann", "octopusann"]
BATCH = 12                      # 32 queries: batches of 12, 12 and 8
STAGES = ("search.memgraph", "search.upload", "search.hops",
          "search.readback", "search.stats")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def indexes():
    ds = make_dataset("deep-like", n=1024, nq=32, seed=1, device="cpu")
    graph, med, _ = build_vamana(ds.vectors, R=16, L=32, batch=512, seed=1,
                                 device="cpu")
    out = {}
    for name in PRESETS:
        cfg = get_preset(name)
        out[name] = (build_index(ds, cfg, R=16, L_build=32, graph=graph,
                                 medoid_id=med, device="cpu"), cfg)
    return ds.queries, out


@pytest.fixture(scope="module")
def traced(indexes):
    """preset -> (untraced stats, traced stats, tracer)."""
    queries, idx = indexes
    out = {}
    for name, (index, cfg) in idx.items():
        plain = index.search(queries, cfg, batch=BATCH)
        tracer = Tracer(clock="host")
        out[name] = (plain, index.search(queries, cfg, batch=BATCH,
                                         tracer=tracer), tracer)
    return out


def _children(tracer, i, name):
    return [j for j, s in enumerate(tracer.spans)
            if s.parent == i and s.name == name]


def _batches(stats, field):
    v = getattr(stats, field)
    return [v[s:s + BATCH] for s in range(0, len(v), BATCH)]


@pytest.mark.parametrize("preset", PRESETS)
def test_every_span_lies_inside_its_parent(traced, preset):
    _, _, tr = traced[preset]
    call = tr.spans[0]
    assert call.name == "search.call" and call.parent is None
    assert tr.spans[0].qid == 0
    for s in tr.spans[1:]:
        p = tr.spans[s.parent]
        assert s.qid == call.qid
        assert p.t0_us <= s.t0_us
        assert s.t0_us + s.dur_us <= p.t0_us + p.dur_us
    # the call's direct children are its stages, one set per batch
    stages = [s.name for s in tr.spans if s.parent == 0]
    assert set(stages) <= set(STAGES)
    assert stages.count("search.hops") == 3
    assert stages.count("search.stats") == 3 + 1     # + the concatenation


@pytest.mark.parametrize("preset", PRESETS)
def test_hop_iters_equal_the_slowest_query_of_each_batch(traced, preset):
    plain, _, tr = traced[preset]
    loops = [i for i, s in enumerate(tr.spans) if s.name == "search.hops"]
    iters = [len(_children(tr, i, "search.hop")) for i in loops]
    assert iters == [int(h.max()) for h in _batches(plain, "hops")]
    assert tr.spans[0].args["hop_iters"] == sum(iters)
    assert tr.spans[0].args["batches"] == 3
    assert tr.spans[0].args["queries"] == 32
    assert set(tr.spans[0].args) == {
        "queries", "batches", "hop_iters", "mem_iters", "syncs",
        "graph_hops", "graph_captures", "mem_graph_iters",
        "mem_graph_captures", "page_bytes", "sectors_per_page",
        "sectors_read"}
    # one 4 KB sector a page here (tests/test_torch_multisector.py: two)
    assert tr.spans[0].args["page_bytes"] == 4096
    assert tr.spans[0].args["sectors_per_page"] == 1
    assert tr.spans[0].args["sectors_read"] == int(plain.page_reads.sum())


@pytest.mark.parametrize("preset", PRESETS)
def test_the_cpu_loop_replays_no_graph(traced, preset):
    """Off the card every hop of both loops runs op by op: no graph is
    captured or replayed, and the results are the tracer-off ones."""
    plain, got, tr = traced[preset]
    assert tr.spans[0].args["hop_iters"] > 0
    assert tr.spans[0].args["graph_hops"] == 0
    assert tr.spans[0].args["graph_captures"] == 0
    assert tr.spans[0].args["mem_graph_iters"] == 0
    assert tr.spans[0].args["mem_graph_captures"] == 0
    np.testing.assert_array_equal(got.ids, plain.ids)
    np.testing.assert_array_equal(got.dists, plain.dists)
    np.testing.assert_array_equal(got.hops, plain.hops)


@pytest.mark.parametrize("preset", PRESETS)
def test_mem_iters_equal_the_slowest_memgraph_search(traced, preset):
    plain, _, tr = traced[preset]
    loops = [i for i, s in enumerate(tr.spans) if s.name == "search.memgraph"]
    iters = [len(_children(tr, i, "mem.hop")) for i in loops]
    want = ([int(h.max()) for h in _batches(plain, "mem_hops")]
            if preset == "octopusann" else [])
    assert iters == want and (preset != "octopusann" or min(want) > 0)
    assert tr.spans[0].args["mem_iters"] == sum(want)


@pytest.mark.parametrize("preset", PRESETS)
def test_syncs_are_every_loop_check(traced, preset):
    _, _, tr = traced[preset]
    a = tr.spans[0].args
    loops = a["batches"] * (2 if preset == "octopusann" else 1)
    assert a["syncs"] == a["hop_iters"] + a["mem_iters"] + loops
    assert a["syncs"] == sum(s.name == "search.sync" for s in tr.spans)
    # each iteration holds exactly one check: the next one
    for i, s in enumerate(tr.spans):
        if s.name in ("search.hop", "mem.hop"):
            assert len(_children(tr, i, "search.sync")) == 1


@pytest.mark.parametrize("preset", PRESETS)
def test_results_are_the_same_with_the_tracer_on_and_off(traced, preset):
    plain, got, _ = traced[preset]
    for f in QueryStats._KERNEL_KEYS:
        a, b = getattr(plain, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("preset", PRESETS)
def test_without_a_tracer_no_span_is_built(indexes, traced, preset,
                                           monkeypatch):
    queries, idx = indexes
    index, cfg = idx[preset]

    def refuse(*a, **kw):
        raise AssertionError("a span or a clock read on the untraced path")
    monkeypatch.setattr(tracer_mod, "Span", refuse)
    monkeypatch.setattr(tracer_mod, "time", types.SimpleNamespace(
        perf_counter_ns=refuse, time_ns=refuse))
    got = index.search(queries, cfg, batch=BATCH)
    np.testing.assert_array_equal(got.ids, traced[preset][0].ids)


@pytest.mark.parametrize("preset", PRESETS)
def test_a_virtual_tracer_is_refused(indexes, preset):
    queries, idx = indexes
    index, cfg = idx[preset]
    for tracer in (Tracer(), Tracer(enabled=False)):
        with pytest.raises(ValueError, match="host"):
            index.search(queries[:4], cfg, batch=BATCH, tracer=tracer)
        assert tracer.spans == []


@pytest.mark.parametrize("preset", PRESETS)
def test_the_export_is_a_valid_host_clock_trace(traced, preset):
    _, _, tr = traced[preset]
    doc = tr.to_chrome()
    assert doc["otherData"]["clock"] == "unix_us"
    assert validate_chrome_trace(doc) == []
    timed = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(timed) == len(tr.spans)
    assert {e["args"]["qid"] for e in timed} == {0}
    assert sum("parent" not in e["args"] for e in timed) == 1


@pytest.mark.parametrize("preset", PRESETS)
def test_call_spans_sit_on_the_profiler_clock(indexes, preset, tmp_path):
    """Each profiler stamp of an annotation lies between two tracer stamps
    taken just before it opens and just after it closes, and the call's
    span lies inside the annotation, once the profiler's `ts` is moved by
    its `baseTimeNanoseconds`. The bracket, and not a gap between the two
    starts, tests the clocks: opening an annotation has a cost of its own."""
    from torch.profiler import ProfilerActivity, profile, record_function
    queries, idx = indexes
    index, cfg = idx[preset]
    tracer = Tracer(clock="host")
    brackets = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            before = tracer._now_us()
            with record_function("probe.call"):
                index.search(queries, cfg, batch=BATCH, tracer=tracer)
            brackets.append((before, tracer._now_us()))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    doc = json.loads((tmp_path / "trace.json").read_text())
    base_us = int(doc["baseTimeNanoseconds"]) / 1e3
    probes = sorted((float(e["ts"]) + base_us, float(e["dur"]))
                    for e in doc["traceEvents"]
                    if e.get("name") == "probe.call" and e.get("ph") == "X")
    ours = [e for e in on_profiler_clock(tracer.to_chrome(),
                                         int(doc["baseTimeNanoseconds"]))
            if e["name"] == "search.call"]
    assert len(probes) == len(ours) == 3
    slack = 10.0                                  # us
    for (before, after), (ts, dur), ev in zip(brackets, probes, ours):
        assert before - slack <= ts, (ts - before)
        assert ts + dur <= after + slack, (after - ts - dur)
        call = float(ev["ts"]) + base_us
        assert ts - slack <= call, (call - ts)
        assert call + ev["dur"] <= ts + dur + slack, (ts + dur - call)


def test_host_spans_close_innermost_first_and_clocks_are_named():
    with pytest.raises(ValueError, match="clock"):
        Tracer(clock="wall")
    tr = Tracer(clock="host")
    a = tr.begin("a", "search")
    b = tr.begin("b", "search")
    with pytest.raises(ValueError, match="innermost"):
        tr.end(a)
    tr.end(b, args={"n": 1})
    tr.end(a)
    c = tr.begin("c", "search")
    tr.end(c)
    assert [s.parent for s in tr.spans] == [None, 0, None]
    assert [s.qid for s in tr.spans] == [0, 0, 1]
    assert tr.spans[1].args == {"n": 1}
    with pytest.raises(ValueError, match="host-clock"):
        on_profiler_clock(Tracer().to_chrome(), 0)
