"""The port's whole store stack against the JAX package's.

Every composition of `build_store` that tests/test_store_conservation.py
walks, except the mutable ones (the port has no MutablePageStore yet), is
built by both packages on the same layout and driven through the same
workload: replays of a page trace, a cross-query coalesce, page- and
vertex-granular fetches. Every layer's counters, every accounting dict, the
hit rates and the per-shard rows must be equal, and the conservation
identities must hold at every layer of the port's stack. Then the stack is
fed by a real search: the port's and the reference's `search_batched` on a
tie-free index give the same `visited_pages` and `page_trace`, and both
stores account for them alike.
"""
import numpy as np
import pytest
import torch

from repro.core.dataset import Dataset
from repro.core.engine import DiskIndex as JaxDiskIndex
from repro.core.pages import build_layout as jax_layout
from repro.core.pq import PQ as JaxPQ
from repro.core.pq import encode as jax_encode
from repro.core.presets import get_preset
from repro.core.search_kernel import search_batched as jax_search_batched
from repro.io import build_store as jax_build_store
from repro_torch.convert import config_from_reference, index_from_reference
from repro_torch.core.pages import build_layout
from repro_torch.core.search_kernel import search_batched
from repro_torch.core.vamana import build_vamana
from repro_torch.io import (BatchedPageStore, PrefetchingPageStore,
                            ShardedPageStore, SharedCachePageStore,
                            build_store)

WRITE_FIELDS = ("data_writes", "journal_writes", "snapshot_writes")


@pytest.fixture(scope="module")
def layouts():
    """tests/test_store_conservation.py's tiny layout, built by both."""
    rng = np.random.default_rng(0)
    vectors = rng.normal(size=(64, 8)).astype(np.float32)
    graph = rng.integers(0, 64, (64, 4)).astype(np.int32)
    return (jax_layout(vectors, graph, page_bytes=256),
            build_layout(vectors, graph, page_bytes=256))


def _mask(layout):
    m = np.zeros(layout.vid2page.shape[0], bool)
    m[:8] = True
    return m


# name -> build_store's keywords for a layout: the compositions of
# tests/test_store_conservation.py without its three mutable ones
STACKS = {
    "none": lambda lay: {},
    "static-vertex": lambda lay: dict(cached_vertices=_mask(lay),
                                      cache_policy="static-vertex"),
    "batched": lambda lay: dict(batched=True),
    "lru": lambda lay: dict(batched=True, cache_policy="lru",
                            cache_bytes=8 * lay.page_bytes),
    "2q": lambda lay: dict(batched=True, cache_policy="2q",
                           cache_bytes=8 * lay.page_bytes),
    "lru-prefetch": lambda lay: dict(batched=True, cache_policy="lru",
                                     cache_bytes=16 * lay.page_bytes,
                                     prefetch=1),
    "partitioned": lambda lay: dict(batched=True, cache_policy="lru",
                                    cache_bytes=8 * lay.page_bytes,
                                    tenants=2),
    "sharded": lambda lay: dict(batched=True, shards=3),
    "sharded-cached": lambda lay: dict(batched=True, shards=3,
                                       cache_policy="lru",
                                       cache_bytes=9 * lay.page_bytes),
}


def _trace(B, num_pages, seed=7):
    """(B, 4, 3) trace with deliberate within- and cross-query reuse."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, min(num_pages, 12), (B, 4, 3)).astype(np.int32)
    t[rng.random(t.shape) < 0.2] = -1
    return t


def _plain(x):
    """Accounting results as plain Python values, compared with ==."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _drive(store, layout):
    """tests/test_store_conservation.py's workload on the store's own
    serving paths; returns every result it gave."""
    out = []
    trace = _trace(3, layout.num_pages)
    if hasattr(store, "replay_batch"):
        tenants = ([0, 1, 0] if getattr(getattr(store, "cache", None),
                                        "tenant_aware", False) else None)
        out.append(store.replay_batch(trace, tenants=tenants))
        out.append(store.replay_batch(trace, tenants=tenants))
    if hasattr(store, "coalesce"):
        vis = np.zeros((3, layout.num_pages), bool)
        vis[0, [0, 1, 2]] = True
        vis[1, [1, 2, 3]] = True
        vis[2, [0, 3, 4]] = True
        out.append(store.coalesce(vis))
    out.append(store.fetch([0, 1, 1, 2]))
    if not hasattr(store, "shard_counters"):
        vids = np.asarray([2, 9, 40])
        out.append(store.fetch(layout.vid2page[vids], vids=vids))
    return _plain(out)


def _layers(store):
    out = [store]
    while hasattr(out[-1], "inner"):
        out.append(out[-1].inner)
    return out


def _observed(store):
    """Everything a caller can read off a driven stack."""
    seen = {"layers": [type(s).__name__ for s in _layers(store)],
            "counters": [s.counters.as_dict() for s in _layers(store)]}
    for name in ("hit_rate", "tenant_hit_rates", "savings", "shard_rows"):
        if hasattr(store, name):
            seen[name] = _plain(getattr(store, name)())
    if hasattr(store, "shard_counters"):
        seen["shard_counters"] = [c.as_dict() for c in store.shard_counters]
    return seen


def _assert_conserved(store, label):
    """tests/test_store_conservation.py's identities at every layer."""
    layers = _layers(store)
    for layer, inner in zip(layers, layers[1:] + [None]):
        c = layer.counters
        at = f"{label}:{type(layer).__name__}"
        assert c.pages_written == sum(getattr(c, f) for f in WRITE_FIELDS)
        if inner is not None:
            for f in WRITE_FIELDS + ("pages_written",):
                assert getattr(c, f) == getattr(inner.counters, f), (at, f)
        if isinstance(layer, (BatchedPageStore, ShardedPageStore)):
            assert c.pages_requested >= c.cache_hits + c.pages_fetched, at
            assert layer.savings() == c.pages_requested - c.pages_fetched
        elif isinstance(layer, PrefetchingPageStore):
            assert (c.pages_requested == c.cache_hits + c.pages_fetched
                    - layer.prefetch_issued), at
        else:
            assert c.pages_requested == c.cache_hits + c.pages_fetched, at
        if inner is not None:
            assert c.pages_fetched == inner.counters.pages_fetched, at
        if isinstance(layer, ShardedPageStore):
            for f in ("pages_requested", "pages_fetched", "cache_hits",
                      "records_fetched", "pages_written") + WRITE_FIELDS:
                assert getattr(c, f) == sum(
                    getattr(sc, f) for sc in layer.shard_counters), (at, f)


@pytest.mark.parametrize("name", sorted(STACKS))
def test_stack_moves_as_the_reference(layouts, name):
    jl, tl = layouts
    ref = jax_build_store(jl, **STACKS[name](jl))
    port = build_store(tl, **STACKS[name](tl), device="cpu")
    assert _drive(port, tl) == _drive(ref, jl)
    assert _observed(port) == _observed(ref)
    _assert_conserved(port, name)
    # the stack hands the search the bottom store's tensors
    assert port.kernel_arrays() is _layers(port)[-1].kernel_arrays()
    assert port.device == torch.device("cpu")


def test_fetch_for_queries_moves_as_the_reference(layouts):
    """The record-returning coalesce: same union, records and counters.
    (Both packages charge the union to the inner store twice here, once
    by `coalesce` and once by the fetch of its records.)"""
    jl, tl = layouts
    vis = np.zeros((3, tl.num_pages), bool)
    vis[0, [0, 1, 2]] = True
    vis[1, [1, 2, 5]] = True
    ref = jax_build_store(jl, batched=True)
    port = build_store(tl, batched=True, device="cpu")
    assert _plain(port.fetch_for_queries(vis)) == \
        _plain(ref.fetch_for_queries(vis))
    assert _observed(port) == _observed(ref)


# keyword sets that build_store refuses, each with the reference's error
BAD = [dict(cache_policy="belady"),
       dict(cache_policy="static-vertex"),
       dict(cache_bytes=4096),
       dict(cache_policy="lru", cache_bytes=4096, prefetch=-1),
       dict(prefetch=1),
       dict(cache_policy="lru", cache_bytes=4096, tenants=0),
       dict(cache_policy="lru", cache_bytes=4096, tenant_shares=[1.0]),
       dict(cache_policy="lru", cache_bytes=4096, rebalance_every=8),
       dict(placement="contiguous"),
       dict(tenants=2),
       dict(shards=0),
       dict(shards=2, placement="replicated"),
       dict(shards=2, placement="diagonal"),
       dict(cache_policy="lru", cache_bytes=0),
       dict(cache_policy="lru", cache_bytes=256, tenants=2)]


@pytest.mark.parametrize("kw", BAD, ids=[str(sorted(k.items())) for k in BAD])
def test_build_store_refuses_what_the_reference_refuses(layouts, kw):
    jl, tl = layouts
    with pytest.raises(ValueError) as want:
        jax_build_store(jl, **kw)
    with pytest.raises(ValueError) as got:
        build_store(tl, **kw, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(mutable=True), dict(journal=object()),
                                dict(crash=object())],
                         ids=["mutable", "journal", "crash"])
def test_build_store_refuses_the_mutable_stack(layouts, kw):
    """The port has no MutablePageStore yet: the mutable stack raises,
    naming the slice that brings it, and nothing runs in its place."""
    with pytest.raises(NotImplementedError, match="A8"):
        build_store(layouts[1], batched=True, **kw, device="cpu")


# -- the stack fed by a real search -----------------------------------------


@pytest.fixture(scope="module")
def tie_free():
    """tests/test_torch_search.py's tie-free index, smaller: integer data
    and PQ centroids, so both packages' searches take the same path."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 8, (512, 32)).astype(np.float32)
    q = rng.integers(0, 8, (24, 32)).astype(np.float32)
    ds = Dataset("tie-free", x, q, np.zeros((24, 10), np.int32), "float")
    graph, med, _ = build_vamana(x, R=16, L=32, batch=256, seed=0,
                                 device="cpu")
    cent = rng.integers(0, 8, (16, 256, 2)).astype(np.float32)
    pq = JaxPQ(centroids=cent, codes=jax_encode(x, cent), m=16, dsub=2)
    cfg = get_preset("baseline")
    layout = jax_layout(x, graph, page_bytes=cfg.page_bytes)
    ref = JaxDiskIndex(layout, pq, graph, med, cfg)
    port = index_from_reference(ref, "cpu")
    kw = dict(medoid=med, batch=8, collect_visited=True, collect_trace=True)
    want = jax_search_batched(ref.page_store(batched=True), ref.pq, cfg,
                              ds.queries, **kw)
    got = search_batched(port.page_store(batched=True), port.pq,
                         config_from_reference(cfg), ds.queries, **kw)
    return ref, port, want, got


def test_search_feeds_the_batched_store_alike(tie_free):
    ref, port, want, got = tie_free
    assert isinstance(port.page_store(batched=True), BatchedPageStore)
    assert port.page_store(batched=True) is port.page_store(batched=True)
    assert port.page_store(batched=True) is not port.page_store()
    np.testing.assert_array_equal(got.visited_pages, want.visited_pages)
    np.testing.assert_array_equal(got.page_trace, want.page_trace)
    assert want.visited_pages.any()
    # the search's own stores hold its per-query bookings (note_kernel_io);
    # the batches' coalesced reads are booked on a fresh stack
    assert _observed(port.page_store(batched=True)) == \
        _observed(ref.page_store(batched=True))
    jb = jax_build_store(ref.layout, batched=True)
    tb = build_store(port.layout, batched=True, device="cpu")
    for s in range(0, len(got.ids), 8):
        acct = tb.coalesce(got.visited_pages[s:s + 8])
        assert acct == jb.coalesce(want.visited_pages[s:s + 8])
        assert acct["issued"] <= acct["requested"]
    assert _observed(tb) == _observed(jb)
    _assert_conserved(tb, "search")


@pytest.mark.parametrize("policy", ["lru", "2q"])
def test_search_trace_replays_alike(tie_free, policy):
    ref, port, want, got = tie_free
    kw = dict(batched=True, cache_policy=policy,
              cache_bytes=8 * ref.layout.page_bytes)
    jstore = jax_build_store(ref.layout, **kw)
    tstore = build_store(port.layout, **kw, device="cpu")
    assert isinstance(tstore, SharedCachePageStore)
    for s in range(0, len(got.ids), 8):
        acct = _plain(tstore.replay_batch(got.page_trace[s:s + 8]))
        assert acct == _plain(jstore.replay_batch(want.page_trace[s:s + 8]))
    assert tstore.hit_rate() > 0
    assert _observed(tstore) == _observed(jstore)
    _assert_conserved(tstore, policy)
