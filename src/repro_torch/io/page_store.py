"""I/O layer of the port: the PageStore contract and the two stores the
`DiskIndex` facade composes. Copied from src/repro/io/page_store.py (the port
imports nothing of `repro`), with one change: `kernel_arrays()` returns
torch tensors on the store's device, built once, with int64 ids so that the
search's gathers index with them directly.

  ArrayPageStore    — base store over a PageLayout's arrays (the simulated
                      SSD; every fetched page is a charged read).
  CachedPageStore   — decorator carrying the vertex cache mask (§4.1.2):
                      fetches for cached vertices are memory hits, and the
                      mask is what the search consumes to zero-charge
                      frontier reads of cached vertices.

The cross-query `BatchedPageStore`, the stateful page caches and the sharded
store are not ported yet.

The contract (duck-typed; see PageStore Protocol):
  fetch(page_ids, vids=None) -> dict(vids, vecs, nbrs)   [+ counters moving]
  charge(page_ids)        — accounting-only device reads
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
    `fetch` is one charged read (callers dedup)."""

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


def build_store(layout, cached_vertices: Optional[np.ndarray] = None, *,
                device):
    """The store stack of a `DiskIndex`: an ArrayPageStore on `device`,
    under a CachedPageStore when `cached_vertices` marks any vertex."""
    store = ArrayPageStore(layout, device)
    if cached_vertices is not None and cached_vertices.any():
        store = CachedPageStore(store, cached_vertices)
    return store
