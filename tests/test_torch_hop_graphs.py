"""Both search loops' captured hops, run by core/hop_loop.py: the disk loop
(core/search_kernel.py `_hop`, from the process's cache `GRAPHS`) and the
MemGraph loop (core/vamana.py `_mem_hop`, from the MemGraph's own cache,
which only `MemGraph.entry_points` passes). On the CPU: each loop's cache
key and the cache's bound; the graphs' bookkeeping with a capture that
replays the hop op by op; that only the MemGraph's entry points, whose
vectors and graph stay on the device, take the MemGraph loop's graph path.
On the card: the captured graphs against the eager loops, bit for bit, for
every key of the result. The tests marked `cuda` skip without a card; this
file imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_hop_graphs.py
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch.core import hop_loop as hl
from repro_torch.core import search_kernel as sk
from repro_torch.core import vamana
from repro_torch.core.builder import build_index
from repro_torch.core.cache import frequency_cache
from repro_torch.core.dataset import make_dataset
from repro_torch.core.presets import get_preset
from repro_torch.core.stats import QueryStats
from repro_torch.obs import Tracer

# the presets each loop is checked on
PRESETS = {"disk": ["baseline", "diskann", "pipeline", "octopusann"],
           "mem": ["memgraph", "octopusann"]}
CPU_SIZES = [1, 5, 16, 40]
CARD_SIZES = [1, 5, 16, 256]
TRACK = {False: "untracked", True: "tracked"}


# -- each loop's cache key, and the cache's bound -----------------------------

# the tensors each loop's graph reads in place, and its static arguments
def _reads(loop):
    if loop == "disk":
        return [torch.zeros(4, 6, dtype=torch.int64),
                torch.zeros(4, 6, 8), torch.zeros(3, 5, dtype=torch.uint8)]
    return [torch.zeros(64, 8), torch.zeros(64, 6, dtype=torch.int64)]


READ_NAMES = {"disk": ["0", "1", "2"], "mem": ["X", "G"]}
STATIC = {
    "disk": dict(k=10, L=64, width=8, max_iters=96, n_p=6,
                 page_search=False, dynamic_width=False, dw_min=2, dw_max=32,
                 pipeline=False, spec=2, track_visited=False,
                 track_trace=False),
    "mem": dict(L=32, width=2, max_iters=128, visited_cap=256),
}


@pytest.mark.parametrize("loop", list(STATIC))
def test_graph_key_is_equal_for_equal_inputs(loop):
    ts = _reads(loop)
    dev = torch.device("cuda", 0)
    a = hl.graph_key(dev, 16, ts, dict(STATIC[loop]))
    assert a == hl.graph_key(dev, 16, list(ts), dict(STATIC[loop]))
    assert hash(a) == hash(hl.graph_key(dev, 16, ts, dict(STATIC[loop])))
    assert a[0] == str(dev)


SAME_SIZE = {torch.int64: torch.float64, torch.float32: torch.int32,
             torch.uint8: torch.int8}


@pytest.mark.parametrize("loop,i,change", [
    pytest.param(loop, i, change, id=f"{loop}-{name}-{change}")
    for loop in STATIC for i, name in enumerate(READ_NAMES[loop])
    for change in ("data_ptr", "shape", "dtype", "stride")])
def test_graph_key_changes_with_any_tensor_it_reads(loop, i, change):
    """Each change alone (a new shape has new strides too)."""
    ts = _reads(loop)
    before = hl.graph_key("cuda:0", 16, ts, STATIC[loop])
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
    assert hl.graph_key("cuda:0", 16, ts, STATIC[loop]) != before


@pytest.mark.parametrize("loop,name", [
    pytest.param(loop, name, id=f"{loop}-{name}") for loop in STATIC
    for name in list(STATIC[loop]) + ["batch", "device"]])
def test_graph_key_changes_with_any_static_argument(loop, name):
    ts = _reads(loop)
    before = hl.graph_key("cuda:0", 16, ts, STATIC[loop])
    static, batch, dev = dict(STATIC[loop]), 16, "cuda:0"
    if name == "batch":
        batch = 17
    elif name == "device":
        dev = "cuda:1"
    elif isinstance(static[name], bool):
        static[name] = not static[name]
    else:
        static[name] += 1
    assert hl.graph_key(dev, batch, ts, static) != before


def test_graph_cache_drops_the_least_recently_used():
    graphs = hl.HopGraphs(capacity=3)
    made = []

    def capture(key):
        return lambda: made.append(key) or ("graph", key)
    for key in "abc":
        assert graphs.get(key, capture(key)) == ("graph", key)
    assert graphs.get("a", capture("a")) == ("graph", "a")   # a hit
    graphs.get("d", capture("d"))                            # drops b
    assert made == list("abcd") and graphs.counts() == (0, 4)
    assert list(graphs.graphs) == ["c", "a", "d"]
    graphs.get("b", capture("b"))                            # drops c
    assert list(graphs.graphs) == ["a", "d", "b"]
    assert len(graphs.graphs) <= graphs.capacity and graphs.captures == 5


# -- indexes, and searching them on either path -------------------------------

def _indexes(device):
    ds = make_dataset("deep-like", n=1024, nq=2 * max(CARD_SIZES), seed=1,
                      device=device)
    graph, med, _ = vamana.build_vamana(ds.vectors, R=16, L=32, batch=512,
                                        seed=1, device=device)
    out = {}
    for name in dict.fromkeys(PRESETS["disk"] + PRESETS["mem"]):
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
        pytest.skip("needs a CUDA device: the search loops capture CUDA "
                    "graphs only on the card")
    return _indexes("cuda")


def _fresh_caches(monkeypatch, index, capacity=64):
    """A new, empty cache for each loop the index runs, by loop."""
    caches = {"disk": hl.HopGraphs(capacity)}
    monkeypatch.setattr(sk, "GRAPHS", caches["disk"])
    if index.memgraph is not None:
        caches["mem"] = hl.HopGraphs(capacity)
        monkeypatch.setattr(index.memgraph, "graphs", caches["mem"])
    return caches


def _eager(monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(hl, "graphs_on", lambda device: False)
        return fn()


def _search(index, cfg, queries, batch, track):
    store = index.page_store(use_cache=cfg.cache_frac > 0)
    return sk.search_batched(store, index.pq, cfg, queries,
                             medoid=index.medoid, memgraph=index.memgraph,
                             batch=batch, collect_visited=track,
                             collect_trace=track, account_kernel_io=False)


def _entry_points(index, cfg, q):
    return index.memgraph.entry_points(q, n_entries=cfg.memgraph_entries,
                                       L=cfg.memgraph_L)


def _assert_same(a, b):
    for f in QueryStats._KERNEL_KEYS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _assert_same_entries(a, b):
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _since(cache, before):
    """(iterations replayed, graphs captured) since `before`."""
    return tuple(now - then for now, then in zip(cache.counts(), before))


def _slowest(per_query, batch):
    """A loop's iterations over a call: its slowest query's in each batch."""
    return sum(int(per_query[s:s + batch].max())
               for s in range(0, len(per_query), batch))


def _check_replays(index, cfg, queries, loop, n, batch, track,
                   monkeypatch):
    """Two searches of n queries in batches of `batch`, the second on other
    queries: the first captures a graph of each batch size for each loop
    the preset runs, the second replays them and captures none. Each loop
    takes as many iterations as its slowest query in each batch (capture
    advanced no query), and the search equals the eager loops', bit for
    bit; for the MemGraph loop, so do its entry points."""
    caches = _fresh_caches(monkeypatch, index)
    assert loop in caches
    sizes = len({min(batch, n - s) for s in range(0, n, batch)})
    for q, captures in ((queries[:n], sizes), (queries[n:2 * n], 0)):
        want = _eager(monkeypatch, lambda: _search(index, cfg, q, batch,
                                                   track))
        before = {k: c.counts() for k, c in caches.items()}
        _assert_same(_search(index, cfg, q, batch, track), want)
        for k, c in caches.items():
            per_query = want.hops if k == "disk" else want.mem_hops
            assert _since(c, before[k]) == (_slowest(per_query, batch),
                                            captures), k
            assert per_query.max() > 0, k
        if loop == "mem":
            want_mg = _eager(monkeypatch, lambda: _entry_points(index, cfg,
                                                                q))
            before = caches["mem"].counts()
            _assert_same_entries(_entry_points(index, cfg, q), want_mg)
            assert _since(caches["mem"], before) == (
                int(want_mg["hops"].max()), 0)


# the `search.call` args of each loop: replayed, iterations, captured
CALL_ARGS = {"disk": ("graph_hops", "hop_iters", "graph_captures"),
             "mem": ("mem_graph_iters", "mem_iters", "mem_graph_captures")}


def _check_call_counts(index, cfg, queries, loop, monkeypatch):
    """Two traced facade calls in batches of 16, 16 and 8: the first
    captures a graph of each size for each loop the preset runs, the
    second none; every iteration of both loops is replayed, and both calls
    give the eager results, loop iterations and syncs."""
    def counts():
        tracer = Tracer(clock="host")
        st = index.search(queries, cfg, batch=16, tracer=tracer)
        return st, tracer.spans[0].args

    caches = _fresh_caches(monkeypatch, index)
    assert loop in caches
    want, eager = _eager(monkeypatch, counts)
    for replayed, _, captured in CALL_ARGS.values():
        assert eager[replayed] == eager[captured] == 0
    for captures in (2, 0):
        got, args = counts()
        _assert_same(got, want)
        for k, (replayed, iters, captured) in CALL_ARGS.items():
            runs = k in caches
            assert args[replayed] == args[iters] == eager[iters], k
            assert (args[iters] > 0) == runs, k
            assert args[captured] == (captures if runs else 0), k
        assert args["syncs"] == eager["syncs"]
    assert all(c.captures == 2 for c in caches.values())


# -- the graphs' bookkeeping, on the CPU --------------------------------------

@pytest.fixture
def replayed_on_cpu(monkeypatch):
    """Both loops' graph path on the CPU: a `capture` that runs the warm-up
    on the buffers, then replays the hop op by op; the disk loop gets a
    fresh cache of its own."""
    def capture(step, device, pool):
        for _ in range(hl._HopGraph.WARMUP):
            step()
        return types.SimpleNamespace(replay=step)
    monkeypatch.setattr(hl.HopGraphs, "pool", lambda self: None)
    monkeypatch.setattr(hl._HopGraph, "_capture", staticmethod(capture))
    monkeypatch.setattr(hl, "graphs_on", lambda device: True)
    monkeypatch.setattr(sk, "GRAPHS", hl.HopGraphs())


@pytest.mark.parametrize("loop,preset,n,batch,track", [
    pytest.param("disk", p, 40, 16, track, id=f"disk-{p}-{TRACK[track]}")
    for p in PRESETS["disk"] for track in TRACK] + [
    pytest.param("mem", p, size, size, True, id=f"mem-{p}-{size}")
    for p in PRESETS["mem"] for size in CPU_SIZES])
def test_graph_buffers_give_the_eager_results(cpu_indexes, loop, preset, n,
                                              batch, track, replayed_on_cpu,
                                              monkeypatch):
    """Capture on the buffers advances no query: the capturing call and a
    replay of its graphs give the eager results; a second batch size gets
    its own graph."""
    ds, idx = cpu_indexes
    _check_replays(*idx[preset], ds.queries, loop, n, batch, track,
                   monkeypatch)


@pytest.mark.parametrize("loop,preset", [
    pytest.param(loop, p, id=f"{loop}-{p}")
    for loop in PRESETS for p in PRESETS[loop]])
def test_search_call_counts_replayed_iterations(cpu_indexes, loop, preset,
                                                replayed_on_cpu,
                                                monkeypatch):
    ds, idx = cpu_indexes
    _check_call_counts(*idx[preset], ds.queries[:40], loop, monkeypatch)


@pytest.mark.parametrize("loop", list(PRESETS))
def test_each_loop_keys_its_graph_by_what_it_reads(cpu_indexes, loop,
                                                   replayed_on_cpu,
                                                   monkeypatch):
    """The disk loop files its graph under the store's page tensors, the PQ
    centroids and codes and the cache mask with the search's thirteen
    arguments; the MemGraph loop under X and G with L, width, max_iters
    and visited_cap."""
    ds, idx = cpu_indexes
    index, cfg = idx["octopusann"]
    caches = _fresh_caches(monkeypatch, index)
    _search(index, cfg, ds.queries[:16], 16, False)
    store = index.page_store(use_cache=cfg.cache_frac > 0)
    if loop == "disk":
        reads = (*store.kernel_arrays(),
                 *sk._pq_device_arrays(index.pq, store.device),
                 store._device_cache_mask)
        static = dict(k=cfg.k, L=cfg.L, width=cfg.beam_width,
                      max_iters=cfg.max_iters, n_p=store.layout.n_p,
                      page_search=cfg.page_search,
                      dynamic_width=cfg.dynamic_width, dw_min=cfg.dw_min,
                      dw_max=cfg.dw_max, pipeline=bool(cfg.pipeline),
                      spec=cfg.pipeline_spec, track_visited=False,
                      track_trace=False)
    else:
        reads = index.memgraph._device_arrays()
        L = cfg.memgraph_L
        static = dict(L=L, width=2, max_iters=4 * L, visited_cap=8 * L)
    assert list(caches[loop].graphs) == [
        hl.graph_key(store.device, 16, reads, static)]


def test_entry_points_drop_the_least_recently_used_graph(cpu_indexes,
                                                         replayed_on_cpu,
                                                         monkeypatch):
    ds, idx = cpu_indexes
    index, cfg = idx["memgraph"]
    graphs = _fresh_caches(monkeypatch, index, capacity=2)["mem"]
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
    real_get = hl.HopGraphs.get

    def get(self, key, capture):
        if self is not sk.GRAPHS:        # the disk loop's is another matter
            gets.append(key)
        return real_get(self, key, capture)
    monkeypatch.setattr(hl.HopGraphs, "get", get)
    OTHER_CALLERS[caller](index, ds)
    assert gets == []
    _fresh_caches(monkeypatch, index)
    _entry_points(index, cfg, ds.queries[:4])
    assert len(gets) == 1


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("loop,preset,size,track", [
    pytest.param("disk", p, size, track, id=f"disk-{p}-{size}-{TRACK[track]}")
    for p in PRESETS["disk"] for size in CARD_SIZES for track in TRACK] + [
    pytest.param("mem", p, size, True, id=f"mem-{p}-{size}")
    for p in PRESETS["mem"] for size in CARD_SIZES])
def test_graph_equals_eager_on_the_card(card_indexes, loop, preset, size,
                                        track, monkeypatch):
    ds, idx = card_indexes
    _check_replays(*idx[preset], ds.queries, loop, size, size, track,
                   monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("loop,preset", [
    pytest.param(loop, p, id=f"{loop}-{p}")
    for loop in PRESETS for p in PRESETS[loop]])
def test_every_iteration_of_a_call_is_replayed_on_the_card(card_indexes,
                                                           loop, preset,
                                                           monkeypatch):
    ds, idx = card_indexes
    _check_call_counts(*idx[preset], ds.queries[:40], loop, monkeypatch)


@pytest.mark.cuda
def test_a_store_uploaded_anew_captures_anew(card_indexes, monkeypatch):
    """After a MutableIndex flush the store uploads its tensors again; the
    disk loop's graph path gives the eager results, capturing anew where
    the key (the tensors' addresses, shapes, strides and dtypes)
    changed."""
    from repro_torch.mutation.mutable_index import MutableIndex
    ds, idx = card_indexes
    base, cfg = idx["baseline"]
    mi = MutableIndex(base)
    q = ds.queries[:16]
    graphs = _fresh_caches(monkeypatch, base)["disk"]
    store = mi.page_store(use_cache=cfg.cache_frac > 0)

    def key():
        cent, codes = sk._pq_device_arrays(mi.pq, store.device)
        return hl.graph_key(store.device, len(q), (
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


@pytest.mark.cuda
def test_memgraph_arrays_uploaded_anew_capture_anew(card_indexes,
                                                    monkeypatch):
    """A MemGraph whose vectors and graph are uploaded again (the old ones
    still held, so the addresses differ) captures a graph for the new
    addresses and gives the eager results."""
    ds, idx = card_indexes
    index, cfg = idx["memgraph"]
    mg = index.memgraph
    graphs = _fresh_caches(monkeypatch, index)["mem"]
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
