"""The port's `AnnServer` held against the live JAX package's.

On the tie-free fixture of tests/test_torch_search.py (every distance exact
in float32), the same serving run goes through the reference's AnnServer
over the JAX DiskIndex and through the port's over the same index carried
across, with the same seed: the report rows must be equal column for
column (the measured `measured_step_us` aside), and so must the per-tenant
and per-shard rows, every per-query search counter, the query order and
the per-query latency attribution. The runs cover the closed loop, the
open loop under each admission policy, LRU and 2Q caches with prefetch,
two tenants, two shards in each placement, a streaming mutation mix with
compaction and a journal, and a traced run's Chrome JSON.

The reference's own sharding test asserts that mean latency falls
strictly from 1 to 2 to 4 shards, which fails on the reference; the port
is held to the reference's latencies instead.
"""
import numpy as np
import pytest
import torch
from test_torch_search import COUNTERS, _reference_index, tie_free  # noqa: F401

import repro.mutation as rm
import repro.obs as ro
import repro.serving as rsv
import repro_torch.mutation as pm
import repro_torch.obs as po
import repro_torch.serving as psv
from repro import sanitize as rs
from repro.core import PRESETS, get_preset
from repro.core.search_kernel import search_batched
from repro.io import build_store, profile_from_trace
from repro_torch import sanitize as ps
from repro_torch.convert import config_from_reference, index_from_reference

PKGS = {"ref": (rsv, rm, ro, rs), "port": (psv, pm, po, ps)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def indexes(tie_free):
    ref = _reference_index(tie_free, PRESETS["baseline"])
    cfg = get_preset("baseline", L=32)
    # the replicated placement's hot set, from one traced search
    st = search_batched(build_store(ref.layout, batched=True), ref.pq, cfg,
                        tie_free[0].queries, medoid=ref.medoid,
                        collect_trace=True, account_kernel_io=False)
    profile = profile_from_trace(st.page_trace, ref.layout.num_pages)
    return {"ref": ref, "port": index_from_reference(ref, "cpu"),
            "cfg": cfg, "queries": tie_free[0].queries, "profile": profile}


def _pages(idx, n):
    return n * idx.layout.page_bytes


# name -> (ServerConfig kwargs (or a function of the index), loop, kwargs)
RUNS = {
    "closed": (dict(max_batch=8), "closed", dict(workers=5, rounds=2)),
    "closed-lru-prefetch": (
        lambda i: dict(max_batch=8, cache_policy="lru",
                       cache_bytes=_pages(i, 48), prefetch=2),
        "closed", dict(workers=8, rounds=3)),
    "open": (dict(max_batch=8), "open",
             dict(rate_qps=4000.0, duration_us=20_000.0, seed=7)),
    "open-2q-prefetch": (
        lambda i: dict(max_batch=8, cache_policy="2q",
                       cache_bytes=_pages(i, 48), prefetch=1),
        "open", dict(rate_qps=6000.0, duration_us=15_000.0, seed=3)),
    "open-reject": ("reject", "open",
                    dict(rate_qps=60_000.0, duration_us=4000.0, seed=1)),
    "open-shed-oldest": ("shed-oldest", "open",
                         dict(rate_qps=60_000.0, duration_us=4000.0,
                              seed=1)),
    "open-degrade": ("degrade", "open",
                     dict(rate_qps=60_000.0, duration_us=4000.0, seed=1)),
    "tenants2-closed": (
        lambda i: dict(max_batch=8, cache_policy="lru",
                       cache_bytes=_pages(i, 48), tenants=2,
                       tenant_shares=(0.75, 0.25)),
        "closed", dict(workers=8, rounds=2, tenants=True)),
    "tenants2-open": (
        lambda i: dict(max_batch=8, cache_policy="2q",
                       cache_bytes=_pages(i, 48), tenants=2,
                       cache_rebalance_every=4),
        "open", dict(rate_qps=6000.0, duration_us=15_000.0, seed=5,
                     tenants=True)),
    "shards2-round-robin": (dict(max_batch=8, shards=2), "closed",
                            dict(workers=8, rounds=2)),
    "shards2-contiguous": (
        lambda i: dict(max_batch=8, shards=2, placement="contiguous",
                       cache_policy="lru", cache_bytes=_pages(i, 48)),
        "open", dict(rate_qps=6000.0, duration_us=15_000.0, seed=2)),
    "shards2-replicated": (dict(max_batch=8, shards=2,
                                placement="replicated"), "open",
                           dict(rate_qps=6000.0, duration_us=15_000.0,
                                seed=4, profile=True)),
}


def _server_cfg(pkg, spec, idx):
    sv = PKGS[pkg][0]
    if isinstance(spec, str):
        return sv.ServerConfig(max_batch=8, admission=sv.AdmissionConfig(
            policy=spec, queue_cap=6, rate_qps=40_000.0, burst=12))
    return sv.ServerConfig(**(spec(idx) if callable(spec) else spec))


# the traced run: two shards, so device spans land on two tracks
TRACED = (dict(max_batch=8, shards=2), "open",
          dict(rate_qps=4000.0, duration_us=20_000.0, seed=7))


def _serve(pkg, indexes, run, tracer=None):
    spec, loop, kw = RUNS[run] if isinstance(run, str) else run
    kw = dict(kw)
    idx = indexes[pkg]
    cfg = indexes["cfg"]
    if pkg == "port":
        cfg = config_from_reference(cfg)
    q = indexes["queries"]
    profile = indexes["profile"] if kw.pop("profile", False) else None
    srv = PKGS[pkg][0].AnnServer(idx, cfg,
                                 server_cfg=_server_cfg(pkg, spec, idx),
                                 page_profile=profile)
    if kw.pop("tenants", False):
        kw["tenants"] = np.arange(len(q)) % 2
    if loop == "closed":
        return srv.serve_closed_loop(q, **kw)
    return srv.serve_open_loop(q, tracer=tracer, **kw)


def _without_measured(row):
    return {k: v for k, v in row.items() if k != "measured_step_us"}


def _assert_same_report(got, want):
    assert _without_measured(got.row()) == _without_measured(want.row())
    assert got.per_tenant == want.per_tenant
    assert got.per_shard == want.per_shard
    np.testing.assert_array_equal(got.query_indices, want.query_indices)
    for f in COUNTERS:
        a, b = getattr(got.stats, f), getattr(want.stats, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("tenants", "page_trace"):
        a, b = getattr(got.stats, f), getattr(want.stats, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    att_g = getattr(got, "attribution", None)
    att_w = getattr(want, "attribution", None)
    assert (att_g is None) == (att_w is None)
    if att_w is not None:
        assert att_g.keys() == att_w.keys()
        for k in att_w:
            np.testing.assert_array_equal(att_g[k], att_w[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_rows_equal_the_reference(indexes, name):
    want = _serve("ref", indexes, name)
    got = _serve("port", indexes, name)
    _assert_same_report(got, want)
    assert want.row()["qps"] > 0
    if name.startswith("open-") and name.split("-", 1)[1] in (
            "reject", "shed-oldest", "degrade"):
        assert want.shed + want.degraded > 0, "the run did not overload"
        assert got.offered == got.admitted + got.shed


def test_closed_loop_ids_equal_the_facade(indexes):
    """The server's results are the facade's, as tests/test_serving.py:20
    holds the reference's."""
    rep = _serve("port", indexes, "closed")
    want = indexes["port"].search(indexes["queries"],
                                  config_from_reference(indexes["cfg"]))
    np.testing.assert_array_equal(rep.stats.ids, want.ids[rep.query_indices])


def _mutable(pkg, indexes, journal):
    _, mut, _, _ = PKGS[pkg]
    mcfg = mut.MutationConfig(flush_threshold=8, growth_chunk=64,
                              insert_L=8)
    return mut.MutableIndex(indexes[pkg], mcfg, journal=journal)


def test_mutating_journaled_run_equals_the_reference(indexes):
    """A streaming mix with threshold compaction over a journaled
    MutableIndex: same rows, same journal bytes, same final index, and the
    sanitizer armed on both."""
    pool = np.random.default_rng(8).integers(0, 8, (96, 32)).astype(
        np.float32)
    out = {}
    for pkg in ("ref", "port"):
        sv, mut, _, san = PKGS[pkg]
        j = mut.MutationJournal(mut.JournalConfig(group_commit=4))
        idx = _mutable(pkg, indexes, j)
        cfg = indexes["cfg"]
        if pkg == "port":
            cfg = config_from_reference(cfg)
        srv = sv.AnnServer(idx, cfg, server_cfg=sv.ServerConfig(
            max_batch=8, cache_policy="lru",
            cache_bytes=_pages(idx, 48)))
        mix = mut.MutationMix(insert_frac=0.3, delete_frac=0.2,
                              compaction="threshold", threshold=0.05,
                              max_pages=8)
        prev = san.set_enabled(True)
        try:
            reps = [srv.serve_open_loop(indexes["queries"], rate_qps=8000.0,
                                        duration_us=20_000.0, seed=s,
                                        mutation_mix=mix, insert_pool=pool)
                    for s in (11, 12)]
        finally:
            san.set_enabled(prev)
        out[pkg] = (reps, idx, j, srv.store.counters.as_dict())
    (r_reps, r_idx, r_j, r_c), (p_reps, p_idx, p_j, p_c) = (out["ref"],
                                                            out["port"])
    for got, want in zip(p_reps, r_reps):
        _assert_same_report(got, want)
    assert r_reps[0].flushes > 0 and r_reps[0].compactions > 0
    assert r_reps[0].journal_writes > 0
    assert bytes(p_j._log) == bytes(r_j._log)
    assert p_c == r_c
    for f in ("graph", "deleted", "vectors"):
        np.testing.assert_array_equal(getattr(p_idx, f), getattr(r_idx, f))
    np.testing.assert_array_equal(p_idx.layout.page_vids,
                                  r_idx.layout.page_vids)
    assert p_idx.free_pages == r_idx.free_pages
    assert p_idx.dirty_pages == r_idx.dirty_pages
    # the recovered rng cursor resumes both alike
    assert p_idx.recovered_rng().integers(1 << 30) == \
        r_idx.recovered_rng().integers(1 << 30)


def _strip(doc):
    """A Chrome trace without what differs by design: the exporter's name
    in otherData."""
    doc = dict(doc)
    doc["otherData"] = {k: v for k, v in doc["otherData"].items()
                        if k != "source"}
    return doc


def test_traced_run_chrome_json_equals_the_reference(indexes):
    docs, reps = {}, {}
    for pkg in ("ref", "port"):
        tracer = PKGS[pkg][2].Tracer()
        reps[pkg] = _serve(pkg, indexes, TRACED, tracer=tracer)
        docs[pkg] = tracer.to_chrome()
    _assert_same_report(reps["port"], reps["ref"])
    assert po.validate_chrome_trace(docs["port"]) == []
    assert docs["port"]["otherData"]["source"] == "repro_torch.obs"
    assert _strip(docs["port"]) == _strip(docs["ref"])
    assert any(e.get("cat") == "hop" for e in docs["port"]["traceEvents"])
