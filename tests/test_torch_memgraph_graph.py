"""The MemGraph loop's captured hop (core/vamana.py `_mem_hop`, replayed
through core/search_kernel.py `_HopGraph` from the MemGraph's own cache):
its cache key and bound; on the CPU, the graph's bookkeeping with a capture
that replays the hop op by op; that only `MemGraph.entry_points`, whose
vectors and graph stay on the device, takes the graph path; and on the card,
the captured graph against the eager loop, bit for bit. The tests marked
`cuda` skip without a card; this file imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_memgraph_graph.py
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch.core import search_kernel as sk
from repro_torch.core import vamana
from repro_torch.core.builder import build_index
from repro_torch.core.cache import frequency_cache
from repro_torch.core.dataset import make_dataset
from repro_torch.core.presets import get_preset
from repro_torch.core.stats import QueryStats
from repro_torch.obs import Tracer

PRESETS = ["memgraph", "octopusann"]
CPU_SIZES = [1, 5, 16, 40]
CARD_SIZES = [1, 5, 16, 256]
STATIC = dict(L=32, width=2, max_iters=128, visited_cap=256)


# -- the cache key and its bound ----------------------------------------------

def _arrays():
    return [torch.zeros(64, 8), torch.zeros(64, 6, dtype=torch.int64)]


def test_graph_key_is_equal_for_equal_inputs():
    X, G = _arrays()
    a = vamana._mem_graph_key(X, G, 16, **STATIC)
    assert a == vamana._mem_graph_key(X, G, 16, **dict(STATIC))
    assert hash(a) == hash(vamana._mem_graph_key(X, G, 16, **STATIC))
    assert a[0] == str(X.device)


SAME_SIZE = {torch.int64: torch.float64, torch.float32: torch.int32}


@pytest.mark.parametrize("i", range(2), ids=["X", "G"])
@pytest.mark.parametrize("change", ["data_ptr", "shape", "dtype", "stride"])
def test_graph_key_changes_with_any_tensor_it_reads(i, change):
    """Each change alone (a new shape has new strides too)."""
    ts = _arrays()
    before = vamana._mem_graph_key(*ts, 16, **STATIC)
    x = ts[i]
    ts[i] = {"data_ptr": lambda: x.clone(),
             "shape": lambda: x.reshape(-1, 2, x.shape[1]),
             "dtype": lambda: x.view(SAME_SIZE[x.dtype]),
             "stride": lambda: torch.as_strided(x, x.shape,
                                                (0,) * x.dim())}[change]()
    y = ts[i]
    diff = {f for f in ("data_ptr", "stride") if getattr(y, f)()
            != getattr(x, f)()} | {f for f in ("shape", "dtype")
                                   if getattr(y, f) != getattr(x, f)}
    assert change in diff and diff <= {change, "stride"}
    assert vamana._mem_graph_key(*ts, 16, **STATIC) != before


@pytest.mark.parametrize("name", list(STATIC) + ["batch"])
def test_graph_key_changes_with_any_static_argument(name):
    X, G = _arrays()
    before = vamana._mem_graph_key(X, G, 16, **STATIC)
    static, batch = dict(STATIC), 16
    if name == "batch":
        batch = 17
    else:
        static[name] += 1
    assert vamana._mem_graph_key(X, G, batch, **static) != before


# -- indexes, and searching them on either path -------------------------------

def _indexes(device):
    ds = make_dataset("deep-like", n=1024, nq=2 * max(CARD_SIZES), seed=1,
                      device=device)
    graph, med, _ = vamana.build_vamana(ds.vectors, R=16, L=32, batch=512,
                                        seed=1, device=device)
    out = {}
    for name in PRESETS:
        cfg = get_preset(name)
        out[name] = (build_index(ds, cfg, R=16, L_build=32, graph=graph,
                                 medoid_id=med, device=device), cfg)
    return ds, out


@pytest.fixture(scope="module")
def cpu_indexes():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _indexes("cpu")
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def card_indexes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MemGraph loop captures CUDA "
                    "graphs only on the card")
    return _indexes("cuda")


def _fresh_graphs(monkeypatch, mg, capacity=64):
    graphs = sk._HopGraphs(capacity)
    monkeypatch.setattr(mg, "_graphs", graphs)
    return graphs


def _eager(monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(vamana, "_graphs_on", lambda device: False)
        return fn()


def _entry_points(index, cfg, q):
    return index.memgraph.entry_points(q, n_entries=cfg.memgraph_entries,
                                       L=cfg.memgraph_L)


def _search(index, cfg, q, batch):
    store = index.page_store(use_cache=cfg.cache_frac > 0)
    return sk.search_batched(store, index.pq, cfg, q, medoid=index.medoid,
                             memgraph=index.memgraph, batch=batch,
                             collect_visited=True, account_kernel_io=False)


def _assert_same_entries(a, b):
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _assert_same(a, b):
    for f in QueryStats._KERNEL_KEYS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _check_size(index, cfg, queries, size, graphs, monkeypatch):
    """The first call of a size captures its graph, a second call of that
    size, on other queries, replays it; each takes as many iterations as
    its slowest query (capture advanced no query) and gives the eager
    loop's entry points and search, bit for bit."""
    for q, captures in ((queries[:size], 1), (queries[size:2 * size], 0)):
        want_mg = _eager(monkeypatch, lambda: _entry_points(index, cfg, q))
        want = _eager(monkeypatch, lambda: _search(index, cfg, q, size))
        before, hops = graphs.captures, graphs.hops
        _assert_same_entries(_entry_points(index, cfg, q), want_mg)
        assert graphs.captures - before == captures
        assert graphs.hops - hops == int(want_mg["hops"].max()) > 0
        _assert_same(_search(index, cfg, q, size), want)
        assert graphs.captures - before == captures


def _check_call_counts(index, cfg, queries, graphs, monkeypatch):
    """Two traced facade calls in batches of 16, 16 and 8: the first
    captures a MemGraph graph for each size, the second none; every
    MemGraph iteration of both is replayed, both give the eager results,
    and the disk loop's own counts are those of an eager MemGraph loop."""
    def counts():
        tracer = Tracer(clock="host")
        st = index.search(queries, cfg, batch=16, tracer=tracer)
        return st, tracer.spans[0].args

    monkeypatch.setattr(sk, "_GRAPHS", sk._HopGraphs())
    want, eager = _eager(monkeypatch, counts)
    assert eager["mem_graph_iters"] == eager["mem_graph_captures"] == 0
    for captures in (2, 0):
        monkeypatch.setattr(sk, "_GRAPHS", sk._HopGraphs())
        got, args = counts()
        _assert_same(got, want)
        assert args["mem_graph_iters"] == args["mem_iters"] > 0
        assert args["mem_graph_captures"] == captures
        for k in ("graph_hops", "graph_captures", "hop_iters", "mem_iters",
                  "syncs"):
            assert args[k] == eager[k], k
    assert graphs.captures == 2


# -- the graph's bookkeeping, on the CPU --------------------------------------

@pytest.fixture
def replayed_on_cpu(monkeypatch):
    """The MemGraph loop's graph path on the CPU: a `capture` that runs the
    warm-up on the buffers, then replays `_mem_hop` op by op."""
    def capture(step, device, pool):
        for _ in range(sk._HopGraph.WARMUP):
            step()
        return types.SimpleNamespace(replay=step)
    monkeypatch.setattr(sk._HopGraphs, "pool", lambda self: None)
    monkeypatch.setattr(sk._HopGraph, "_capture", staticmethod(capture))
    monkeypatch.setattr(vamana, "_graphs_on", lambda device: True)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("size", CPU_SIZES)
def test_graph_buffers_give_the_eager_results(cpu_indexes, preset, size,
                                              replayed_on_cpu, monkeypatch):
    """Capture on the buffers advances no query: the capturing call and a
    replay of its graph give the eager entry points, MemGraph hops and
    evaluations, and the eager search."""
    ds, idx = cpu_indexes
    index, cfg = idx[preset]
    graphs = _fresh_graphs(monkeypatch, index.memgraph)
    _check_size(index, cfg, ds.queries, size, graphs, monkeypatch)


@pytest.mark.parametrize("preset", PRESETS)
def test_search_call_counts_replayed_memgraph_iterations(
        cpu_indexes, preset, replayed_on_cpu, monkeypatch):
    ds, idx = cpu_indexes
    index, cfg = idx[preset]
    graphs = _fresh_graphs(monkeypatch, index.memgraph)
    _check_call_counts(index, cfg, ds.queries[:40], graphs, monkeypatch)


def test_graph_cache_drops_the_least_recently_used(cpu_indexes,
                                                   replayed_on_cpu,
                                                   monkeypatch):
    ds, idx = cpu_indexes
    index, cfg = idx["memgraph"]
    graphs = _fresh_graphs(monkeypatch, index.memgraph, capacity=2)
    for size in (1, 2, 1, 3, 2):
        _entry_points(index, cfg, ds.queries[:size])
    # 1 and 2 captured, 1 a hit, 3 drops 2, and 2 is captured anew
    assert graphs.captures == 4
    assert [k[1] for k in graphs.graphs] == [3, 2]


def _insert_wiring(index, ds):
    from repro_torch.mutation.mutable_index import MutableIndex
    mi = MutableIndex(index)
    for v in ds.vectors[:8] + 0.01:
        mi.insert(v.astype(np.float32))
    mi.flush()


OTHER_CALLERS = {
    "build_vamana": lambda index, ds: vamana.build_vamana(
        ds.vectors[:256], R=8, L=16, batch=128, seed=2, device="cpu"),
    "frequency_cache": lambda index, ds: frequency_cache(
        index.graph, ds.vectors, index.medoid, ds.queries[:16], 0.01,
        device="cpu"),
    "insert_wiring": _insert_wiring,
}


@pytest.mark.parametrize("caller", list(OTHER_CALLERS))
def test_other_callers_keep_the_eager_loop(cpu_indexes, caller,
                                           replayed_on_cpu, monkeypatch):
    """The builder, the frequency cache and MutableIndex's insert wiring
    pass tensors that do not stay at one address from call to call, so
    they run the MemGraph loop op by op even where graphs are on; the
    MemGraph's own entry points take the graph path."""
    ds, idx = cpu_indexes
    index, cfg = idx["memgraph"]
    gets = []
    real_get = sk._HopGraphs.get
    monkeypatch.setattr(sk._HopGraphs, "get", lambda self, key, capture:
                        gets.append(key) or real_get(self, key, capture))
    OTHER_CALLERS[caller](index, ds)
    assert gets == []
    _fresh_graphs(monkeypatch, index.memgraph)
    _entry_points(index, cfg, ds.queries[:4])
    assert len(gets) == 1


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("size", CARD_SIZES)
def test_graph_equals_eager_on_the_card(card_indexes, preset, size,
                                        monkeypatch):
    ds, idx = card_indexes
    index, cfg = idx[preset]
    graphs = _fresh_graphs(monkeypatch, index.memgraph)
    _check_size(index, cfg, ds.queries, size, graphs, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", PRESETS)
def test_every_memgraph_iteration_of_a_call_is_replayed_on_the_card(
        card_indexes, preset, monkeypatch):
    ds, idx = card_indexes
    index, cfg = idx[preset]
    graphs = _fresh_graphs(monkeypatch, index.memgraph)
    _check_call_counts(index, cfg, ds.queries[:40], graphs, monkeypatch)


@pytest.mark.cuda
def test_arrays_uploaded_anew_capture_anew(card_indexes, monkeypatch):
    """A MemGraph whose vectors and graph are uploaded again (the old ones
    still held, so the addresses differ) captures a graph for the new
    addresses and gives the eager results."""
    ds, idx = card_indexes
    index, cfg = idx["memgraph"]
    mg = index.memgraph
    graphs = _fresh_graphs(monkeypatch, mg)
    q = ds.queries[:16]
    want = _eager(monkeypatch, lambda: _entry_points(index, cfg, q))
    _assert_same_entries(_entry_points(index, cfg, q), want)
    old = mg._device_arrays()
    monkeypatch.setattr(mg, "_dev", None)
    new = mg._device_arrays()
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(old, new))
    _assert_same_entries(_entry_points(index, cfg, q), want)
    assert graphs.captures == 2
    _assert_same_entries(_entry_points(index, cfg, q), want)
    assert graphs.captures == 2
