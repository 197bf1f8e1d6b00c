"""The disk loop's captured hop (core/search_kernel.py `_HopGraph`): its
cache key and bound on the CPU; the graph's bookkeeping on the CPU with a
capture that replays the hop op by op; and on the card, the captured graph
against the eager loop, bit for bit, for every key of the result. The
tests marked `cuda` skip without a card; this file imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_search_graph.py
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch.core import search_kernel as sk
from repro_torch.core.builder import build_index
from repro_torch.core.dataset import make_dataset
from repro_torch.core.presets import get_preset
from repro_torch.core.stats import QueryStats
from repro_torch.core.vamana import build_vamana
from repro_torch.obs import Tracer

PRESETS = ["baseline", "diskann", "pipeline", "octopusann"]
SIZES = [1, 5, 16, 256]
STATIC = dict(k=10, L=64, width=8, max_iters=96, n_p=6, page_search=False,
              dynamic_width=False, dw_min=2, dw_max=32, pipeline=False,
              spec=2, track_visited=False, track_trace=False)


# -- the cache key and its bound ----------------------------------------------

def _tensors():
    return [torch.zeros(4, 6, dtype=torch.int64),
            torch.zeros(4, 6, 8), torch.zeros(3, 5, dtype=torch.uint8)]


def test_graph_key_is_equal_for_equal_inputs():
    ts = _tensors()
    dev = torch.device("cuda", 0)
    a = sk._graph_key(dev, 16, ts, dict(STATIC))
    assert a == sk._graph_key(dev, 16, list(ts), dict(STATIC))
    assert hash(a) == hash(sk._graph_key(dev, 16, ts, dict(STATIC)))


SAME_SIZE = {torch.int64: torch.float64, torch.float32: torch.int32,
             torch.uint8: torch.int8}


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("change", ["data_ptr", "shape", "dtype", "stride"])
def test_graph_key_changes_with_any_tensor_it_reads(i, change):
    """Each change alone (a new shape has new strides too)."""
    ts = _tensors()
    before = sk._graph_key("cuda:0", 16, ts, STATIC)
    x = ts[i]
    ts[i] = {"data_ptr": lambda: x.clone(),
             "shape": lambda: x.reshape(-1),
             "dtype": lambda: x.view(SAME_SIZE[x.dtype]),
             "stride": lambda: torch.as_strided(x, x.shape,
                                                (0,) * x.dim())}[change]()
    y = ts[i]
    diff = {f for f in ("data_ptr", "stride") if getattr(y, f)()
            != getattr(x, f)()} | {f for f in ("shape", "dtype")
                                   if getattr(y, f) != getattr(x, f)}
    assert change in diff and diff <= {change, "stride"}
    assert sk._graph_key("cuda:0", 16, ts, STATIC) != before


@pytest.mark.parametrize("name", list(STATIC) + ["batch", "device"])
def test_graph_key_changes_with_any_static_argument(name):
    ts = _tensors()
    before = sk._graph_key("cuda:0", 16, ts, STATIC)
    static, batch, dev = dict(STATIC), 16, "cuda:0"
    if name == "batch":
        batch = 17
    elif name == "device":
        dev = "cuda:1"
    elif isinstance(static[name], bool):
        static[name] = not static[name]
    else:
        static[name] += 1
    assert sk._graph_key(dev, batch, ts, static) != before


def test_graph_cache_drops_the_least_recently_used():
    graphs = sk._HopGraphs(capacity=3)
    made = []

    def capture(key):
        return lambda: made.append(key) or ("graph", key)
    for key in "abc":
        assert graphs.get(key, capture(key)) == ("graph", key)
    assert graphs.get("a", capture("a")) == ("graph", "a")   # a hit
    graphs.get("d", capture("d"))                            # drops b
    assert made == list("abcd") and graphs.captures == 4
    assert list(graphs.graphs) == ["c", "a", "d"]
    graphs.get("b", capture("b"))                            # drops c
    assert list(graphs.graphs) == ["a", "d", "b"]
    assert len(graphs.graphs) <= graphs.capacity and graphs.captures == 5


# -- indexes, and searching them on either path -------------------------------

def _indexes(device):
    ds = make_dataset("deep-like", n=1024, nq=256, seed=1, device=device)
    graph, med, _ = build_vamana(ds.vectors, R=16, L=32, batch=512, seed=1,
                                 device=device)
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
        pytest.skip("needs a CUDA device: the disk loop captures CUDA "
                    "graphs only on the card")
    return _indexes("cuda")


def _search(index, cfg, queries, batch, track):
    store = index.page_store(use_cache=cfg.cache_frac > 0)
    return sk.search_batched(store, index.pq, cfg, queries,
                             medoid=index.medoid, memgraph=index.memgraph,
                             batch=batch, collect_visited=track,
                             collect_trace=track, account_kernel_io=False)


def _eager(monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(sk, "_graphs_on", lambda device: False)
        return fn()


def _assert_same(a, b):
    for f in QueryStats._KERNEL_KEYS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _fresh_graphs(monkeypatch):
    graphs = sk._HopGraphs()
    monkeypatch.setattr(sk, "_GRAPHS", graphs)
    return graphs


def _check_call_counts(index, cfg, queries, monkeypatch):
    """Two traced facade calls in batches of 16, 16 and 8: the first
    captures a graph for each size, the second none; every hop of both is
    replayed, and both give the eager results."""
    want = _eager(monkeypatch, lambda: index.search(queries, cfg, batch=16))
    for captures in (2, 0):
        tracer = Tracer(clock="host")
        _assert_same(index.search(queries, cfg, batch=16, tracer=tracer),
                     want)
        args = tracer.spans[0].args
        assert args["graph_hops"] == args["hop_iters"] > 0
        assert args["graph_captures"] == captures


# -- the graph's bookkeeping, on the CPU --------------------------------------

@pytest.fixture
def replayed_on_cpu(monkeypatch):
    """The graph path on the CPU: a `capture` that runs the warm-up on the
    buffers, then replays the hop op by op."""
    def capture(step, device, pool):
        for _ in range(sk._HopGraph.WARMUP):
            step()
        return types.SimpleNamespace(replay=step)
    graphs = _fresh_graphs(monkeypatch)
    monkeypatch.setattr(graphs, "pool", lambda: None)
    monkeypatch.setattr(sk._HopGraph, "_capture", staticmethod(capture))
    monkeypatch.setattr(sk, "_graphs_on", lambda device: True)
    return graphs


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("track", [False, True], ids=["untracked", "tracked"])
def test_graph_buffers_give_the_eager_results(cpu_indexes, preset, track,
                                              replayed_on_cpu, monkeypatch):
    """Capture on the buffers advances no query (the capturing call and a
    replay of its graph give the eager results), and a second batch size
    gets its own graph."""
    ds, idx = cpu_indexes
    index, cfg = idx[preset]
    q = ds.queries[:40]
    want = _eager(monkeypatch, lambda: _search(index, cfg, q, 16, track))
    for captures in (2, 0):
        before = replayed_on_cpu.captures
        _assert_same(_search(index, cfg, q, 16, track), want)
        assert replayed_on_cpu.captures - before == captures


@pytest.mark.parametrize("preset", PRESETS)
def test_search_call_counts_replayed_hops(cpu_indexes, preset,
                                          replayed_on_cpu, monkeypatch):
    ds, idx = cpu_indexes
    _check_call_counts(*idx[preset], ds.queries[:40], monkeypatch)


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("track", [False, True], ids=["untracked", "tracked"])
def test_graph_equals_eager_on_the_card(card_indexes, preset, size, track,
                                        monkeypatch):
    ds, idx = card_indexes
    index, cfg = idx[preset]
    q = ds.queries[:size]
    graphs = _fresh_graphs(monkeypatch)
    want = _eager(monkeypatch, lambda: _search(index, cfg, q, size, track))
    for _ in range(2):               # the capturing call, then a replay
        _assert_same(_search(index, cfg, q, size, track), want)
    assert graphs.captures == 1 and graphs.hops > 0


@pytest.mark.cuda
@pytest.mark.parametrize("preset", PRESETS)
def test_every_hop_of_a_call_is_replayed_on_the_card(card_indexes, preset,
                                                     monkeypatch):
    ds, idx = card_indexes
    _fresh_graphs(monkeypatch)
    _check_call_counts(*idx[preset], ds.queries[:40], monkeypatch)


@pytest.mark.cuda
def test_a_store_uploaded_anew_captures_anew(card_indexes, monkeypatch):
    """After a MutableIndex flush the store uploads its tensors again; the
    graph path gives the eager results, capturing anew where the key (the
    tensors' addresses, shapes, strides and dtypes) changed."""
    from repro_torch.mutation.mutable_index import MutableIndex
    ds, idx = card_indexes
    base, cfg = idx["baseline"]
    mi = MutableIndex(base)
    q = ds.queries[:16]
    graphs = _fresh_graphs(monkeypatch)
    store = mi.page_store(use_cache=cfg.cache_frac > 0)

    def key():
        cent, codes = sk._pq_device_arrays(mi.pq, store.device)
        return sk._graph_key(store.device, len(q), (
            *store.kernel_arrays(), cent, codes, store._device_cache_mask),
            {})
    _assert_same(mi.search(q, cfg, batch=16),
                 _eager(monkeypatch, lambda: mi.search(q, cfg, batch=16)))
    before, captured = key(), graphs.captures
    assert captured == 1
    rng = np.random.default_rng(3)
    for v in ds.vectors[:40] + rng.normal(0, 0.01, (40, ds.vectors.shape[1])):
        mi.insert(v.astype(np.float32))
    mi.flush()
    got = mi.search(q, cfg, batch=16)
    assert graphs.captures - captured == int(key() != before)
    _assert_same(got, _eager(monkeypatch, lambda: mi.search(q, cfg,
                                                            batch=16)))
