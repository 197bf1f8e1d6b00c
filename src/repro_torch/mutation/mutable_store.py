"""Streaming-update I/O layer: page versioning + invalidation over the
store stack. The port of src/repro/mutation/mutable_store.py; it also drops
the page kernels' memoized code tile on a rewrite (`_drop_kernel_memos`).

A frozen index lets every layer of the store stack assume a page's bytes
never change: device arrays are uploaded once, caches keep copies forever.
Streaming mutations (repro_torch/mutation/mutable_index.py) break that — an
append flush or a compaction run rewrites pages in place — so this module
adds the one store layer that knows pages have VERSIONS:

  MutablePageStore — a pass-through decorator on TOP of any build_store
      composition (Array/Cached/Batched/SharedCache/Prefetching/Sharded).
      Reads flow through untouched with mirrored accounting, so with zero
      mutations the stack behaves bit-identically to the unwrapped one.
      On a rewrite (`invalidate`) it bumps the page's version, walks the
      stack evicting every stale cached copy (shared caches, per-shard
      caches, tenant partitions), and drops the memoized kernel/device
      arrays so the next kernel launch sees the new bytes. On an append
      (`notify_append`) it grows the version vector, extends a sharded
      placement's page→shard map, and refreshes the static vertex mask.

Write traffic (`note_write`) rides the write half of the conservation
spine: every layer books `pages_written` split by kind (`data_writes` /
`journal_writes` / `snapshot_writes`) 1:1 and forwards down, so the
invariant pages_written == data + journal + snapshot holds at every
layer of every stack — the mirror of what `charge` keeps for reads.
Reads the background jobs issue (compaction reading dirty pages) go down
the accounting-only `charge` spine as before.

Durability (PR 8): this layer is where a page write can TEAR. With a
`journal` attached (repro_torch/mutation/journal.py: MutationJournal) every
data-page write is two-phase — a synced intent record naming the pages,
then the pages themselves — and with a `crash` attached (CrashPoint)
each of those I/O boundaries is numbered and killable, which is what the
crash-point sweep in tests/test_durability.py drives. An index-owned
journal (MutableIndex(journal=)) supersedes a store-owned one: the index
journals logical ops and ticks the crash clock itself, and its attached
stores only book the traffic.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from repro_torch.io.page_store import (StoreCounters, book_writes,
                                       note_inner_writes, resolve_write)

#: StoreCounters fields mirrored from the inner store on every delegated
#: read-path call (pages_written is booked at this layer only).
_MIRRORED = ("pages_requested", "pages_fetched", "cache_hits",
             "records_fetched")


class MutablePageStore:
    """Decorator: page versioning + rewrite invalidation over a finished
    store stack. `build_store(..., mutable=True)` composes it on top."""

    def __init__(self, inner, journal=None, crash=None):
        self.inner = inner
        self.counters = StoreCounters()
        self.page_version = np.zeros(inner.num_pages, np.int64)
        self.invalidations = 0      # stale cached copies actually evicted
        # durability hooks (repro_torch/mutation/journal.py): a store-owned
        # journal makes every data-page write two-phase (synced intent
        # record first); a CrashPoint numbers + kills the I/O boundaries
        self.journal = journal
        self.crash = crash

    # -- delegation with mirrored accounting ---------------------------------

    def _mirrored(self, method: str, *args, **kw):
        """Forward to the inner store, mirroring its full counter movement
        into this layer — the conservation property every decorator keeps
        (pages_fetched here == the device movement below)."""
        c = self.inner.counters
        before = [getattr(c, f) for f in _MIRRORED]
        out = getattr(self.inner, method)(*args, **kw)
        for f, b in zip(_MIRRORED, before):
            setattr(self.counters, f, getattr(self.counters, f)
                    + getattr(c, f) - b)
        return out

    def fetch(self, page_ids: np.ndarray,
              vids: Optional[np.ndarray] = None) -> dict:
        return self._mirrored("fetch", page_ids, vids=vids)

    def charge(self, page_ids: np.ndarray) -> None:
        return self._mirrored("charge", page_ids)

    def note_kernel_io(self, stats) -> None:
        return self._mirrored("note_kernel_io", stats)

    #: accounting paths that exist only when the inner stack provides them
    #: (replay needs a stateful cache, coalescing needs the batch store) —
    #: resolved in __getattr__ so hasattr() mirrors the inner capability
    _MIRRORED_METHODS = ("replay_batch", "coalesce", "fetch_for_queries")

    def kernel_arrays(self) -> tuple:
        return self.inner.kernel_arrays()

    def vertex_cache_mask(self) -> np.ndarray:
        return self.inner.vertex_cache_mask()

    @property
    def layout(self):
        return self.inner.layout

    @property
    def num_pages(self) -> int:
        return self.inner.num_pages

    def __getattr__(self, name: str):
        # public reporting/config surface (savings, hit_rate, cache,
        # caches, shard_rows, tenant_hit_rates, ...) passes through; private
        # names never delegate — memoized per-store state (_kernel_cache,
        # _device_cache_mask) must live on exactly one object
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._MIRRORED_METHODS:
            getattr(self.inner, name)        # capability check (may raise)
            return lambda *a, **kw: self._mirrored(name, *a, **kw)
        return getattr(self.inner, name)

    # -- the mutation surface ------------------------------------------------

    def _layers(self) -> List:
        out = [self.inner]
        while hasattr(out[-1], "inner"):
            out.append(out[-1].inner)
        return out

    def _drop_kernel_memos(self) -> None:
        """The search indexes device copies of the layout arrays, memoized
        on the base store (`_kernel_cache`); search_batched stamps the cache
        mask on THIS object (`_device_cache_mask`), and measure_step_us the
        page-aligned PQ codes the page kernels read (`_device_page_codes`).
        A rewrite makes all three stale. (The reference drops the first
        two: its code tile re-memoizes only when the page count changes,
        so after an in-place compaction its kernels read the old codes.)"""
        for layer in [self] + self._layers():
            layer.__dict__.pop("_device_cache_mask", None)
            layer.__dict__.pop("_device_page_codes", None)
            if hasattr(layer, "_kernel_cache"):
                layer._kernel_cache = None

    def invalidate(self, page_ids: Iterable[int]) -> int:
        """Pages were rewritten in place: bump their versions and evict
        every stale cached copy anywhere in the stack (the shared cache, a
        partitioned cache's per-tenant copies, per-shard cache slices).
        Returns the number of stale copies evicted. The NEXT demand access
        of an evicted page is a charged device read — exactly the locality
        cost a rewrite inflicts on a warm cache."""
        pages = np.asarray(list(page_ids), np.int64).reshape(-1)
        if len(pages) == 0:
            return 0
        if pages.min() < 0 or pages.max() >= len(self.page_version):
            raise IndexError(
                f"page id out of range for {len(self.page_version)} pages "
                f"(after an append, call notify_append first)")
        self.page_version[pages] += 1
        evicted = 0
        for layer in self._layers():
            cache = getattr(layer, "cache", None)
            if cache is not None and hasattr(cache, "invalidate"):
                for p in pages:
                    evicted += bool(cache.invalidate(int(p)))
            caches = getattr(layer, "caches", None)
            if caches is not None:
                for c in caches:
                    for p in pages:
                        evicted += bool(c.invalidate(int(p)))
        self.invalidations += evicted
        self._drop_kernel_memos()
        return evicted

    def notify_append(self, num_pages: int,
                      vertex_mask: Optional[np.ndarray] = None) -> None:
        """The page space grew (append flush): extend the version vector
        (new pages start at version 0), extend a sharded placement's
        page→shard map, refresh the static vertex mask (`vertex_mask` is
        the full new-length mask when the stack carries a CachedPageStore),
        and drop the kernel memos — the array SHAPES changed."""
        if num_pages < len(self.page_version):
            raise ValueError(
                f"page space cannot shrink: {num_pages} < "
                f"{len(self.page_version)}")
        grow = num_pages - len(self.page_version)
        if grow:
            self.page_version = np.concatenate(
                [self.page_version, np.zeros(grow, np.int64)])
        for layer in self._layers():
            if hasattr(layer, "extend_placement"):
                layer.extend_placement(num_pages)
            if vertex_mask is not None and \
                    hasattr(layer, "cached_vertices"):
                layer.cached_vertices = np.asarray(vertex_mask, bool)
        self._drop_kernel_memos()

    def note_write(self, page_ids: Optional[Iterable[int]] = None, *,
                   kind: str = "data",
                   count: Optional[int] = None) -> None:
        """Book device page writes, 1:1 down the spine. With a store-owned
        journal, a data write is TWO-PHASE: the page ids are first made
        durable as a synced intent record (billed as journal writes on
        this same spine), and only then do the data pages move — each one
        a numbered, killable I/O boundary when a CrashPoint is armed. A
        kill between intent and data pages is exactly the torn-write state
        recovery must survive: the journal names pages whose bytes never
        landed, and logical replay rebuilds them."""
        pages, n = resolve_write(page_ids, count)
        if kind == "data" and self.journal is not None and n:
            jpages = self.journal.append(
                "intent", [int(p) for p in pages], sync=True)
            if jpages:
                book_writes(self.counters, jpages, "journal")
                note_inner_writes(self.inner, None, "journal", jpages)
        if kind == "data" and self.crash is not None:
            for _ in range(n):
                self.crash.tick()
        book_writes(self.counters, n, kind)
        note_inner_writes(self.inner, pages, kind, n)

    def version_of(self, page: int) -> int:
        return int(self.page_version[page])
