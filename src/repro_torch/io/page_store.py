"""I/O layer of the port: the PageStore contract and its three stores.
Copied from src/repro/io/page_store.py (the port imports nothing of
`repro`), with two changes: `kernel_arrays()` returns torch tensors on the
store's device, built once, with int64 ids so that the search's gathers
index with them directly; and `build_store` takes the stack's `device` and
refuses the mutable stack, which the port does not have yet.

  ArrayPageStore    — base store over a PageLayout's arrays (the simulated
                      SSD; every fetched page is a charged read).
  CachedPageStore   — decorator carrying the vertex cache mask (§4.1.2):
                      fetches for cached vertices are memory hits, and the
                      mask is what the search consumes to zero-charge
                      frontier reads of cached vertices.
  BatchedPageStore  — decorator that coalesces duplicate page requests
                      across the queries of a batch (cross-query dedup).

The stateful page caches are in page_cache.py, the sharded store in
sharded_store.py; `build_store` composes all of them.

The contract (duck-typed; see PageStore Protocol):
  fetch(page_ids, vids=None) -> dict(vids, vecs, nbrs)   [+ counters moving]
  charge(page_ids)        — accounting-only device reads: every id is one
                            read already past any dedup, so each layer
                            books it 1:1 and forwards down (the
                            conservation spine)
  note_write(page_ids=, kind=, count=) — device page writes, booked 1:1 at
                            every layer
  kernel_arrays() -> (page_vids, page_vecs, page_nbrs, vid2page, vid2slot)
  vertex_cache_mask() -> (n,) bool
  note_kernel_io(stats)   — fold search-measured reads/hits into counters
  counters: StoreCounters
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import sanitize


@dataclasses.dataclass
class StoreCounters:
    pages_requested: int = 0   # pages callers asked for
    pages_fetched: int = 0     # pages actually charged to the device
    cache_hits: int = 0        # requests served from memory
    records_fetched: int = 0   # records moved (pages_fetched * n_p)
    pages_written: int = 0     # total device page writes (the sum of the
    #                            three kinds below — the write-conservation
    #                            invariant every layer keeps)
    data_writes: int = 0       # in-place page rewrites (flush/compaction)
    journal_writes: int = 0    # write-ahead journal commits (sequential)
    snapshot_writes: int = 0   # snapshot checkpoint pages (sequential)

    def __setattr__(self, name: str, value) -> None:
        # REPRO_SANITIZE=1: counters only count — non-negative and monotone
        # (reset() bypasses via object.__setattr__). A decrement means some
        # layer un-booked I/O, which the conservation property tests can
        # only catch after the fact; this catches it at the exact line.
        if sanitize.enabled():
            old = self.__dict__.get(name)
            sanitize.check(
                value >= 0,
                f"counter {name} set to negative value {value}")
            sanitize.check(
                old is None or value >= old,
                f"counter {name} moved backward: {old} -> {value}")
        object.__setattr__(self, name, value)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            object.__setattr__(self, f.name, 0)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def fetch_mirroring_inner(counters: StoreCounters, inner, page_ids,
                          vids) -> dict:
    """Forward a vertex-granular fetch to `inner`, mirroring its full
    counter movement (pages charged, hits served, records moved) into
    `counters` — the one idiom every pass-through decorator uses, so
    savings() and counter rollups agree across the stack."""
    c = inner.counters
    b_fetched, b_hits, b_recs = (c.pages_fetched, c.cache_hits,
                                 c.records_fetched)
    out = inner.fetch(page_ids, vids=vids)
    counters.pages_fetched += c.pages_fetched - b_fetched
    counters.cache_hits += c.cache_hits - b_hits
    counters.records_fetched += c.records_fetched - b_recs
    return out


def book_charged_reads(counters: StoreCounters, n_pages: int,
                       n_p: int) -> None:
    """Book `n_pages` accounting-only device reads (already past any dedup
    or cache decision) into `counters` — the shared body of every layer's
    `charge`."""
    counters.pages_requested += n_pages
    counters.pages_fetched += n_pages
    counters.records_fetched += n_pages * n_p


#: StoreCounters per-kind write fields, keyed by note_write(kind=).
WRITE_KINDS = ("data", "journal", "snapshot")


def book_writes(counters: StoreCounters, n_pages: int, kind: str) -> None:
    """Book `n_pages` device page writes of `kind` into `counters` — the
    shared body of every layer's `note_write`, keeping the invariant
    pages_written == data_writes + journal_writes + snapshot_writes at
    each layer (the WRITE half of the conservation spine `charge` keeps
    for reads)."""
    if kind not in WRITE_KINDS:
        raise ValueError(f"unknown write kind {kind!r}; one of "
                         f"{WRITE_KINDS}")
    counters.pages_written += n_pages
    setattr(counters, f"{kind}_writes",
            getattr(counters, f"{kind}_writes") + n_pages)
    # write conservation holds again at the end of every booking (it is
    # transiently broken between the two bumps above, so the check lives
    # here, not in __setattr__)
    sanitize.check_counters(counters)


def resolve_write(page_ids, count: Optional[int]) -> tuple:
    """Normalize a note_write call: data writes name their pages
    (`page_ids`), journal/snapshot writes are count-only sequential
    traffic (`count=`). Returns (page_ids array or None, n_pages)."""
    if count is not None:
        if page_ids is not None:
            raise ValueError("note_write takes page_ids OR count, not both")
        if count < 0:
            raise ValueError(f"count={count} must be >= 0")
        return None, int(count)
    if page_ids is None:
        raise ValueError("note_write needs page_ids (data writes) or "
                         "count= (sequential journal/snapshot writes)")
    pages = np.asarray(list(page_ids), np.int64).reshape(-1)
    return pages, len(pages)


def note_inner_writes(inner, page_ids, kind: str, count: int) -> None:
    """Forward a write booking down the spine, tolerating stores below a
    legacy/foreign stack that carry no write books."""
    if hasattr(inner, "note_write"):
        if page_ids is not None:
            inner.note_write(page_ids, kind=kind)
        else:
            inner.note_write(kind=kind, count=count)


def charge_inner_reads(inner, page_ids) -> None:
    """Charge `page_ids` to `inner` as device reads, preferring its
    accounting-only `charge` path. The fallback (a store without `charge`)
    issues `fetch` in rounds of unique ids so a coalescing store cannot
    dedup a genuine re-read: a page evicted and missed again IS two device
    reads, and conservation demands every layer book both."""
    if len(page_ids) == 0:
        return
    if hasattr(inner, "charge"):
        inner.charge(np.asarray(page_ids, np.int64).reshape(-1))
        return
    counts = {}
    for p in page_ids:
        counts[int(p)] = counts.get(int(p), 0) + 1
    while counts:
        inner.fetch(np.fromiter(counts.keys(), np.int64, len(counts)))
        counts = {p: c - 1 for p, c in counts.items() if c > 1}


@runtime_checkable
class PageStore(Protocol):
    """Anything that can serve pages to the kernel and serving layers."""

    counters: StoreCounters

    def fetch(self, page_ids: np.ndarray,
              vids: Optional[np.ndarray] = None) -> dict: ...

    def charge(self, page_ids: np.ndarray) -> None: ...

    def kernel_arrays(self) -> tuple: ...

    def vertex_cache_mask(self) -> np.ndarray: ...

    def note_kernel_io(self, stats) -> None: ...


class ArrayPageStore:
    """Base store: a PageLayout's arrays stand in for the SSD. Every page in
    `fetch` is one charged read (callers dedup; see BatchedPageStore)."""

    def __init__(self, layout, device):
        self.layout = layout
        self.device = torch.device(device)
        self.counters = StoreCounters()
        self._kernel_cache: Optional[tuple] = None

    @property
    def num_pages(self) -> int:
        return self.layout.num_pages

    def fetch(self, page_ids: np.ndarray,
              vids: Optional[np.ndarray] = None) -> dict:
        page_ids = np.asarray(page_ids, np.int64).reshape(-1)
        if np.any((page_ids < 0) | (page_ids >= self.layout.num_pages)):
            raise IndexError("page id out of range")
        self.counters.pages_requested += len(page_ids)
        self.counters.pages_fetched += len(page_ids)
        self.counters.records_fetched += len(page_ids) * self.layout.n_p
        return {"vids": self.layout.page_vids[page_ids],
                "vecs": self.layout.page_vecs[page_ids],
                "nbrs": self.layout.page_nbrs[page_ids]}

    def charge(self, page_ids: np.ndarray) -> None:
        """Accounting-only reads: same counter movement as `fetch`, no
        record materialization (the serving hot path's replay/coalesce
        charges are pure accounting — the kernel already holds the page
        arrays)."""
        page_ids = np.asarray(page_ids, np.int64).reshape(-1)
        if np.any((page_ids < 0) | (page_ids >= self.layout.num_pages)):
            raise IndexError("page id out of range")
        book_charged_reads(self.counters, len(page_ids), self.layout.n_p)

    def note_write(self, page_ids=None, *, kind: str = "data",
                   count: Optional[int] = None) -> None:
        """Book device page writes at the bottom of the spine: data writes
        name their (range-checked) pages, journal/snapshot writes are
        count-only sequential traffic appended past the page space."""
        pages, n = resolve_write(page_ids, count)
        if pages is not None and len(pages) and (
                pages.min() < 0 or pages.max() >= self.layout.num_pages):
            raise IndexError("page id out of range")
        book_writes(self.counters, n, kind)

    def kernel_arrays(self) -> tuple:
        """(page_vids, page_vecs, page_nbrs, vid2page, vid2slot) on the
        store's device: ids as int64, vectors as float32."""
        if self._kernel_cache is None:
            lay = self.layout

            def put(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a),
                                       device=self.device).to(dtype)
            self._kernel_cache = (
                put(lay.page_vids, torch.int64),
                put(lay.page_vecs, torch.float32),
                put(lay.page_nbrs, torch.int64),
                put(lay.vid2page, torch.int64),
                put(lay.vid2slot, torch.int64))
        return self._kernel_cache

    def vertex_cache_mask(self) -> np.ndarray:
        return np.zeros(self.layout.vid2page.shape[0], bool)

    def note_kernel_io(self, stats) -> None:
        pages = int(stats.page_reads.sum())
        self.counters.pages_requested += pages
        self.counters.pages_fetched += pages
        self.counters.records_fetched += int(stats.n_read_records.sum())


class CachedPageStore:
    """Decorator: a vertex cache mask in front of an inner store. A fetch
    that names its requesting vertices (`vids`) serves cached vertices from
    memory (hits) and forwards only the rest; the same mask is exported to
    the kernel, which zero-charges frontier reads of cached vertices."""

    def __init__(self, inner, cached_vertices: np.ndarray):
        self.inner = inner
        self.device = inner.device
        self.cached_vertices = np.asarray(cached_vertices, bool)
        self.counters = StoreCounters()

    @property
    def layout(self):
        return self.inner.layout

    @property
    def num_pages(self) -> int:
        return self.inner.num_pages

    def fetch(self, page_ids: np.ndarray,
              vids: Optional[np.ndarray] = None) -> dict:
        page_ids = np.asarray(page_ids, np.int64).reshape(-1)
        self.counters.pages_requested += len(page_ids)
        if vids is None:
            self.counters.pages_fetched += len(page_ids)
            self.counters.records_fetched += len(page_ids) * self.layout.n_p
            return self.inner.fetch(page_ids)
        vids = np.asarray(vids, np.int64).reshape(-1)
        hit = self.cached_vertices[vids]
        self.counters.cache_hits += int(hit.sum())
        self.counters.pages_fetched += int((~hit).sum())
        self.counters.records_fetched += int((~hit).sum()) * self.layout.n_p
        out = self.inner.fetch(page_ids[~hit])
        # cached vertices' records come from memory: single-record "pages"
        lay = self.layout
        hv = vids[hit]
        out["cached_vids"] = hv.astype(np.int32)
        out["cached_vecs"] = lay.page_vecs[lay.vid2page[hv], lay.vid2slot[hv]]
        out["cached_nbrs"] = lay.page_nbrs[lay.vid2page[hv], lay.vid2slot[hv]]
        return out

    def charge(self, page_ids: np.ndarray) -> None:
        """Accounting-only reads already past any cache decision above:
        book 1:1 and forward, so this layer's movement mirrors the inner
        store's."""
        page_ids = np.asarray(page_ids, np.int64).reshape(-1)
        book_charged_reads(self.counters, len(page_ids), self.layout.n_p)
        self.inner.charge(page_ids)

    def note_write(self, page_ids=None, *, kind: str = "data",
                   count: Optional[int] = None) -> None:
        """Write bookings pass the cache untouched (the vertex mask is a
        READ shortcut): book 1:1 and forward down the spine."""
        pages, n = resolve_write(page_ids, count)
        book_writes(self.counters, n, kind)
        note_inner_writes(self.inner, pages, kind, n)

    def kernel_arrays(self) -> tuple:
        return self.inner.kernel_arrays()

    def vertex_cache_mask(self) -> np.ndarray:
        return self.cached_vertices

    def note_kernel_io(self, stats) -> None:
        self.counters.cache_hits += int(stats.cache_hits.sum())
        pages = int(stats.page_reads.sum())
        self.counters.pages_requested += pages
        self.counters.pages_fetched += pages
        self.inner.note_kernel_io(stats)


class BatchedPageStore:
    """Decorator: coalesce duplicate page requests across the queries of a
    batch. `fetch` dedups a flat request list; `fetch_for_queries` takes
    per-query charged-page bitmaps (QueryStats.visited_pages) and issues the
    union once — the cross-query I/O reduction the paper's per-query
    accounting cannot express. `savings()` reports requested - issued."""

    def __init__(self, inner):
        self.inner = inner
        self.counters = StoreCounters()

    @property
    def device(self):
        return self.inner.device

    @property
    def layout(self):
        return self.inner.layout

    @property
    def num_pages(self) -> int:
        return self.inner.num_pages

    def fetch(self, page_ids: np.ndarray,
              vids: Optional[np.ndarray] = None) -> dict:
        page_ids = np.asarray(page_ids, np.int64).reshape(-1)
        self.counters.pages_requested += len(page_ids)
        if vids is not None:
            # vertex-granular requests can name several records on one page,
            # so page coalescing doesn't apply — pass through to the inner
            # store (which may serve cache hits) uncoalesced
            return fetch_mirroring_inner(self.counters, self.inner,
                                         page_ids, vids)
        uniq, inv = np.unique(page_ids, return_inverse=True)
        self.counters.pages_fetched += len(uniq)
        out = self.inner.fetch(uniq)
        # scatter back so callers see one record-set per requested page
        return {k: v[inv] for k, v in out.items()}

    def fetch_for_queries(self, visited_pages: np.ndarray) -> dict:
        """visited_pages: (B, num_pages) bool per-query charged-page bitmaps.
        Issues the cross-query union once; returns the union's records plus
        the accounting from coalesce()."""
        acct = self.coalesce(visited_pages)
        union = np.flatnonzero(np.asarray(visited_pages, bool).any(axis=0))
        out = self.inner.fetch(union)
        out.update(acct)
        return out

    def coalesce(self, visited_pages: np.ndarray) -> dict:
        """Accounting-only variant of fetch_for_queries for the serving hot
        path: moves the same counters but skips materializing the union's
        records (the kernel already holds the page arrays, so re-copying
        vectors/neighbors per batch would be pure waste). The union IS
        charged to the inner store (`charge`), so cross-stack counter
        rollups stay conserved on the record-free path too."""
        visited_pages = np.asarray(visited_pages, bool)
        union = np.flatnonzero(visited_pages.any(axis=0))
        requested = int(visited_pages.sum())
        issued = len(union)
        self.counters.pages_requested += requested
        self.counters.pages_fetched += issued
        self.counters.records_fetched += issued * self.layout.n_p
        charge_inner_reads(self.inner, union)
        return {"requested": requested, "issued": issued}

    def savings(self) -> int:
        return self.counters.pages_requested - self.counters.pages_fetched

    def charge(self, page_ids: np.ndarray) -> None:
        """Accounting-only reads from a layer above (shared-cache replay,
        sharded stores): already past any coalescing decision, so they pass
        through uncoalesced — a cache miss re-issued after eviction is a
        genuine second device read."""
        page_ids = np.asarray(page_ids, np.int64).reshape(-1)
        book_charged_reads(self.counters, len(page_ids), self.layout.n_p)
        self.inner.charge(page_ids)

    def note_write(self, page_ids=None, *, kind: str = "data",
                   count: Optional[int] = None) -> None:
        """Writes never coalesce (each rewritten page is one device write
        past any dedup decision): book 1:1 and forward down the spine."""
        pages, n = resolve_write(page_ids, count)
        book_writes(self.counters, n, kind)
        note_inner_writes(self.inner, pages, kind, n)

    def kernel_arrays(self) -> tuple:
        return self.inner.kernel_arrays()

    def vertex_cache_mask(self) -> np.ndarray:
        return self.inner.vertex_cache_mask()

    def note_kernel_io(self, stats) -> None:
        # kernel-internal reads are per-query; batching accounts its own
        # fetches in fetch_for_queries, so only forward to the inner store
        self.inner.note_kernel_io(stats)


def build_store(layout, cached_vertices: Optional[np.ndarray] = None,
                batched: bool = False, *, cache_policy: str = "none",
                cache_bytes: int = 0, prefetch: int = 0, tenants: int = 1,
                tenant_shares=None, rebalance_every: int = 0,
                shards: int = 1, placement: str = "round-robin",
                page_profile: Optional[np.ndarray] = None,
                placement_hot_frac: float = 0.25, mutable: bool = False,
                journal=None, crash=None, device):
    """Compose the store stack for an index. Bottom-up:

      ArrayPageStore                          (always — the simulated SSD)
      CachedPageStore                         cache_policy="static-vertex",
                                              or legacy `cached_vertices=`
      BatchedPageStore                        batched=True
      SharedCachePageStore / Prefetching...   cache_policy in DYNAMIC_POLICIES
                                              ("lru" | "fifo" | "2q"), sized
                                              by `cache_bytes`; `prefetch` > 0
                                              selects the look-ahead variant
      ShardedPageStore                        shards > 1: the page space
                                              split across S devices by
                                              `placement` (PLACEMENTS), the
                                              dynamic cache (if any) split
                                              into per-shard slices of the
                                              same `cache_bytes` budget —
                                              tenant-partitioned per shard
                                              when `tenants > 1`, with
                                              `prefetch` look-ahead issued
                                              against the owning shard's
                                              queue

    The static vertex mask (§4.1.2) is now just one policy of the cache
    subsystem: "static-vertex" requires `cached_vertices`; passing
    `cached_vertices` with the default policy keeps composing it (the
    pre-refactor surface). The stateful policies sit ABOVE the batch
    coalescer — their state outlives the batch boundary.

    `tenants > 1` partitions the SAME `cache_bytes` budget across tenants
    (PartitionedPageCache: static `tenant_shares` plus utility rebalance
    every `rebalance_every` accesses when set); replay callers then pass
    per-query tenant ids so each query charges its own partition.

    `shards > 1` replaces the single-device stateful top with a
    `ShardedPageStore`: placement "replicated" additionally needs
    `page_profile` (per-page access counts — `profile_from_trace` offline,
    or `profile_from_counters` from a live store's read counters). All
    three axes compose: `tenants > 1` makes each shard's cache slice a
    per-tenant partition, and `prefetch > 0` issues look-ahead against the
    owning shard's queue (both still need a dynamic `cache_policy` to hold
    the state, same as on one device).

    `mutable=True`, `journal=` and `crash=` configure the streaming-update
    subsystem's MutablePageStore, which the port does not have yet
    (ROADMAP.md A8, mutation and durability): they raise
    NotImplementedError, and nothing runs in their place.

    Every knob that only configures a subordinate layer is validated here:
    a silently ignored `cache_bytes`/`tenant_shares`/`rebalance_every`/
    `placement` is an accounting bug waiting to be measured, so
    unsupported compositions raise one error naming the combination instead."""
    from repro_torch.io.page_cache import (DYNAMIC_POLICIES,
                                           PrefetchingPageStore,
                                           SharedCachePageStore, make_cache)
    from repro_torch.io.sharded_store import (ShardedPageStore,
                                              make_placement,
                                              make_shard_caches)
    if mutable or journal is not None or crash is not None:
        raise NotImplementedError(
            "build_store(mutable=/journal=/crash=) needs the MutablePageStore "
            "of the mutation slice (ROADMAP.md A8, mutation and durability), "
            "which repro_torch does not have yet")
    known = ("none", "static-vertex") + DYNAMIC_POLICIES
    if cache_policy not in known:
        raise ValueError(f"unknown cache_policy {cache_policy!r}; "
                         f"choose from {known}")
    if cache_policy == "static-vertex" and cached_vertices is None:
        raise ValueError(
            "cache_policy='static-vertex' needs `cached_vertices` (the "
            "vertex mask IS the policy's state)")
    if cache_bytes > 0 and cache_policy not in DYNAMIC_POLICIES:
        raise ValueError(
            f"cache_bytes={cache_bytes} with cache_policy="
            f"{cache_policy!r} configures no store: a byte budget only "
            f"sizes the stateful policies {DYNAMIC_POLICIES} — set one, or "
            f"drop cache_bytes")
    if prefetch < 0:
        raise ValueError(f"prefetch={prefetch} must be >= 0")
    if prefetch and cache_policy not in DYNAMIC_POLICIES:
        raise ValueError(
            f"prefetch={prefetch} needs a stateful cache_policy "
            f"{DYNAMIC_POLICIES} to hold the looked-ahead pages")
    if tenants < 1:
        raise ValueError(f"tenants={tenants} must be >= 1")
    if tenants == 1 and tenant_shares is not None:
        raise ValueError(
            "tenant_shares with tenants=1 splits nothing — one tenant owns "
            "the whole budget; set tenants > 1 or drop tenant_shares")
    if tenants == 1 and rebalance_every:
        raise ValueError(
            f"rebalance_every={rebalance_every} with tenants=1 has no "
            f"partitions to rebalance — set tenants > 1 or drop "
            f"rebalance_every")
    if shards == 1 and placement != "round-robin":
        raise ValueError(
            f"placement={placement!r} with shards=1 places nothing — a "
            f"single device has no placement decision; set shards > 1 or "
            f"leave placement at its default")
    if tenants > 1 and cache_policy not in DYNAMIC_POLICIES:
        raise ValueError(
            f"tenants={tenants} partitions a stateful page cache — set "
            f"cache_policy to one of {DYNAMIC_POLICIES}")
    if shards < 1:
        raise ValueError(f"shards={shards} must be >= 1")
    store = ArrayPageStore(layout, device)
    if cached_vertices is not None and cached_vertices.any():
        store = CachedPageStore(store, cached_vertices)
    if batched:
        store = BatchedPageStore(store)
    if shards > 1:
        pl = make_placement(placement, layout.num_pages, shards,
                            profile=page_profile,
                            hot_frac=placement_hot_frac)
        caches = (make_shard_caches(cache_policy, cache_bytes,
                                    layout.page_bytes, shards,
                                    tenants=tenants,
                                    tenant_shares=tenant_shares,
                                    rebalance_every=rebalance_every)
                  if cache_policy in DYNAMIC_POLICIES else None)
        store = ShardedPageStore(store, pl, caches, lookahead=prefetch)
    elif cache_policy in DYNAMIC_POLICIES:
        cache = make_cache(cache_policy, cache_bytes, layout.page_bytes,
                           tenants=tenants, tenant_shares=tenant_shares,
                           rebalance_every=rebalance_every)
        store = (PrefetchingPageStore(store, cache, lookahead=prefetch)
                 if prefetch > 0 else SharedCachePageStore(store, cache))
    return store
