"""Streaming index mutations: the MutableIndex over a frozen DiskIndex.

The paper's page-level complexity model prices a search as path length x
page locality — and PR 0–4 only ever measured it on a frozen index. This
module opens the streaming workload: inserts and deletes arrive while the
index serves, and the locality that `page_shuffle` bought at build time
decays measurably (the Chen et al. survey's and PageANN's open gap).

Lifecycle of a mutation
-----------------------
  insert(vec) -> vid      the vector lands in the in-memory DeltaIndex
                          (repro_torch/mutation/delta_index.py); the disk graph
                          carries no edge to it, so the kernel is untouched
                          and search correctness comes from merging the
                          delta's exact results into the result heap.
  delete(vid)             a delta vid dies in memory; a disk vid becomes a
                          TOMBSTONE: its record and edges stay on the page
                          (it keeps routing), results are filtered, and the
                          disk search overfetches (`MutationConfig.
                          overfetch`) so filtered slots can backfill.
  flush()                 the delta backlog is written to pages in ARRIVAL
                          order (append zone) — the locality-destroying
                          baseline every real system ships first. Inserts
                          get Vamana-style edges (beam search for
                          candidates + robust prune + back-edges), touched
                          pages are rewritten/invalidated, and the pages
                          become part of the DIRTY set.
  compact(max_pages)      the background repair: a bounded slice of the
                          dirty set is re-packed with the SAME greedy
                          packer PageShuffle uses (core/page_shuffle.py:
                          greedy_pack) restricted to the dirty
                          neighborhood, tombstones are purged (in-edges
                          spliced through), wholly-freed pages return to
                          the free list, and every rewritten page is
                          invalidated in the attached stores.

Attached stores (MutablePageStore, repro_torch/mutation/mutable_store.py)
are the I/O-layer half: every flush/compaction charges its read traffic down the
normal accounting spine, books its writes, and evicts stale cached copies,
so the serving layer can price background I/O against query I/O.

With zero mutations every path is a pure pass-through: `search` returns
the same bits as `DiskIndex.search` (the golden facade contract extends to
the wrapper — tests/test_mutation.py pins it).

Durability (PR 8)
-----------------
Construct with `journal=` (repro_torch/mutation/journal.py: MutationJournal)
and every logical op — insert / delete / flush / compact — is appended to
the write-ahead log BEFORE it is applied; flush and compact records are
force-synced (the two-phase rule: the intent must be durable before any
data page moves), inserts and deletes ride the group-commit buffer. A
`crash=` CrashPoint additionally numbers every I/O boundary (journal
syncs + each data-page write) and kills the index at the configured one.

`recover(base, journal)` rebuilds the pre-crash state by replaying the
committed log through these same deterministic code paths — the torn
tail is discarded by checksum, attached stores are charged the replay's
reads/writes down the conservation spine, and the result is bit-identical
to an index that applied the same op prefix uninterrupted
(tests/test_durability.py sweeps every kill point to prove it).

`snapshot()` checkpoints the full mutable state (priced as sequential
snapshot writes on the spine) and truncates the journal; `restore()` /
`recover(snapshot=)` start replay from the checkpoint instead of the
pristine base. The serving loop journals its rng cursor at the end of a
mutating run, so `recovered_rng()` resumes the exact arrival/victim
stream a same-seed uninterrupted run would produce.

The port (of src/repro/mutation/mutable_index.py)
--------------------------------------------------
The mutable state stays numpy on the host — it is what the journal and
snapshots see, and the deterministic host loops (robust prune, back-edges,
purge, relocation, re-pack) run on it exactly as in the reference. The
device work runs on the base DiskIndex's `device`: PQ encoding of a flush's
vectors, the delta scan, and the insert wiring search (`beam_search_mem`),
which reads device mirrors of `vectors` and `graph` (float32, int64) that
every flush, compaction and restore updates row by row — re-uploading the
whole vid space per flush would copy about 0.9 GB at n = 1M. The reverse
adjacency is built from one sort of the edge list by target, and each
vertex's set is made when it is first read (`_ReverseAdjacency`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np

import torch

from repro_torch.core import pq as pq_mod
from repro_torch.core.engine import DiskIndex, SearchConfig
from repro_torch.core.page_shuffle import (bfs_order, greedy_pack,
                                          undirected_adjacency)
from repro_torch.core.pages import PageLayout, overlap_ratio
from repro_torch.core.search_kernel import search_batched
from repro_torch.core.stats import QueryStats
from repro_torch.core.vamana import beam_search_mem
from repro_torch.io import build_store
from repro_torch.mutation.delta_index import DeltaIndex
from repro_torch.mutation.journal import CrashPoint, MutationJournal


@dataclasses.dataclass(frozen=True)
class MutationConfig:
    """Knobs of the streaming-update subsystem."""

    flush_threshold: int = 64    # delta size at which maybe_flush() flushes
    growth_chunk: int = 256      # vid-capacity growth quantum: arrays (and
    #                              page space) grow in chunks, not per flush
    insert_L: int = 32           # beam width of the insert candidate search
    insert_width: int = 2
    insert_alpha: float = 1.2    # robust-prune slack for insert edges
    overfetch: int = 16          # extra disk-side k while tombstones are
    #                              pending (filtered slots backfill)
    compaction_pages: int = 8    # default dirty-page budget per compact()

    def __post_init__(self):
        if self.flush_threshold < 1:
            raise ValueError(
                f"flush_threshold={self.flush_threshold} must be >= 1")
        if self.growth_chunk < 1:
            raise ValueError(
                f"growth_chunk={self.growth_chunk} must be >= 1")
        if self.insert_L < 1 or self.insert_width < 1:
            raise ValueError("insert_L and insert_width must be >= 1")
        if self.insert_alpha < 1.0:
            raise ValueError(
                f"insert_alpha={self.insert_alpha} must be >= 1.0")
        if self.overfetch < 0:
            raise ValueError(f"overfetch={self.overfetch} must be >= 0")
        if self.compaction_pages < 1:
            raise ValueError(
                f"compaction_pages={self.compaction_pages} must be >= 1")


def _copy_layout(lay: PageLayout) -> PageLayout:
    """A private, mutable copy of the base layout — the base DiskIndex
    (and its golden tests) must never observe a mutation."""
    return PageLayout(
        page_bytes=lay.page_bytes, n_p=lay.n_p, num_pages=lay.num_pages,
        vid2page=lay.vid2page.copy(), vid2slot=lay.vid2slot.copy(),
        page_vids=lay.page_vids.copy(), page_vecs=lay.page_vecs.copy(),
        page_nbrs=lay.page_nbrs.copy(), record_bytes=lay.record_bytes,
        mapping_bytes=lay.mapping_bytes,
        # the reference's layouts (convert.mutable_from_reference) have
        # one sector a page and no field for it
        sectors_per_page=getattr(lay, "sectors_per_page", 1))


def mutable_state(m) -> dict:
    """Deep copies of `m`'s full mutable state in `snapshot()`'s format
    (what `restore()` loads), read by attribute only: no write is billed
    and no journal is touched, so it reads the reference package's
    MutableIndex, whose attributes have the same names, as well."""
    return {
        "layout": _copy_layout(m.layout),
        "graph": m.graph.copy(),
        "codes": m.pq.codes.copy(),
        "vectors": m.vectors.copy(),
        "deleted": m.deleted.copy(),
        "cached": m.cached.copy(),
        "pending_tombstones": set(m.pending_tombstones),
        "delta": m.delta.state(),
        "dirty_pages": set(m.dirty_pages),
        "append_pages": set(m.append_pages),
        "free_pages": list(m.free_pages),
        "next_vid": m.next_vid, "n_disk": m.n_disk,
        "medoid": m.medoid,
        "flushes": m.flushes, "compactions": m.compactions,
        "mutated": m._mutated, "ops_applied": m.ops_applied,
        "rng_state": m._recovered_rng_state,
    }


class _ReverseAdjacency:
    """The reverse adjacency v -> {u : u→v} of a -1 padded graph, as the
    reference's list of sets, built from one sort of the edge list by
    target on `device`. The set of v is made from its run of sources the
    first time it is read, so an index of 1M vertices pays for the sets a
    flush or compaction touches, not for all of them; reading every entry
    (iteration, equality) gives the reference's sets."""

    def __init__(self, graph: np.ndarray, device):
        n = graph.shape[0]
        g = torch.as_tensor(np.ascontiguousarray(graph),
                            device=device).to(torch.int64)
        src, col = torch.nonzero(g >= 0, as_tuple=True)
        dst, order = torch.sort(g[src, col], stable=True)
        self._src = src[order].cpu().numpy()
        self._bounds = torch.searchsorted(
            dst, torch.arange(n + 1, device=dst.device)).cpu().numpy()
        self._n = n
        self._sets: Dict[int, Set[int]] = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, v) -> Set[int]:
        v = int(v)
        out = self._sets.get(v)
        if out is None:
            if not 0 <= v < self._n:
                raise IndexError(f"vertex {v} out of range for {self._n}")
            lo, hi = self._bounds[v], self._bounds[v + 1]
            out = self._sets[v] = set(self._src[lo:hi].tolist())
        return out

    def __iter__(self):
        return (self[v] for v in range(self._n))

    def __eq__(self, other) -> bool:
        return len(self) == len(other) and all(
            a == b for a, b in zip(self, other))

    def extend(self, sets) -> None:
        for s_ in sets:
            self._sets[self._n] = set(s_)
            self._n += 1


class MutableIndex:
    """Streaming wrapper over a DiskIndex: delta inserts, tombstoned
    deletes, append flushes, and localized background compaction. Exposes
    the DiskIndex surface the serving layer consumes (`layout`, `pq`,
    `cached`, `medoid`, `memgraph`, `cfg`, `device`) so `AnnServer` runs
    unchanged on top."""

    def __init__(self, base: DiskIndex,
                 mcfg: Optional[MutationConfig] = None,
                 journal: Optional[MutationJournal] = None,
                 crash: Optional[CrashPoint] = None):
        self.base = base
        self.device = base.device
        self.cfg: SearchConfig = base.cfg
        self.mcfg = mcfg or MutationConfig()
        self.layout = _copy_layout(base.layout)
        self.graph = base.graph.copy()
        self.pq = pq_mod.PQ(centroids=base.pq.centroids,
                            codes=base.pq.codes.copy(),
                            m=base.pq.m, dsub=base.pq.dsub)
        self.medoid = base.medoid
        self.memgraph = base.memgraph
        self.cached = base.cached.copy()
        n = self.layout.vid2page.shape[0]
        idx = np.arange(n)
        self.vectors = self.layout.page_vecs[
            self.layout.vid2page[idx], self.layout.vid2slot[idx]].copy()
        self.d = self.vectors.shape[1]
        self.n_disk = n              # vids [0, n_disk) are on pages
        self.next_vid = n            # next id handed to insert()
        # deleted[v] filters results; rows beyond n_disk are pre-marked so
        # capacity padding and never-flushed gaps can never surface
        self.deleted = np.zeros(n, bool)
        self.pending_tombstones: Set[int] = set()   # deleted, still on disk
        self.delta = DeltaIndex(self.d, self.device)
        self.dirty_pages: Set[int] = set()   # pages awaiting compaction
        self.append_pages: Set[int] = set()  # dirty subset: arrival-order
        #                                      flush zone (re-pack eligible)
        self.free_pages: List[int] = []      # wholly-empty pages, reusable
        # reverse adjacency (v -> {u : u→v}), maintained incrementally at
        # every graph write so tombstone purges find in-edges without an
        # O(n·R) full-graph scan per compaction run (the "continuous"
        # policy runs one per dispatched batch)
        self._rev = _ReverseAdjacency(self.graph, self.device)
        # device mirrors of `vectors` and `graph` for the insert wiring
        # search, made at the first flush and then updated row by row
        self._dev_vectors: Optional[torch.Tensor] = None
        self._dev_graph: Optional[torch.Tensor] = None
        self.flushes = 0
        self.compactions = 0
        self._mutated = False
        self._stores: List = []      # attached MutablePageStores
        self._facade_stores: Dict[bool, object] = {}
        # --- durability (repro_torch/mutation/journal.py) ---
        self.journal = journal       # write-ahead log of the logical ops
        self.crash = crash           # numbered-I/O-boundary fault injection
        self.ops_applied = 0         # insert/delete/flush/compact ops this
        #                              index has applied (live or replayed) —
        #                              the resume cursor a crash harness uses
        self.last_recovery_us = 0.0  # device time the last recover() cost
        #                              (consumed/reported by serve_open_loop)
        self._recovered_rng_state: Optional[dict] = None  # journaled cursor
        self._replaying = False      # recovery replay must not re-journal

    # -- DiskIndex-compatible surface ---------------------------------------

    @property
    def capacity(self) -> int:
        return self.graph.shape[0]

    @property
    def mutated(self) -> bool:
        return self._mutated

    @property
    def live_count(self) -> int:
        return int((~self.deleted[:self.n_disk]).sum()) + len(self.delta)

    @property
    def dirty_fraction(self) -> float:
        return len(self.dirty_pages) / max(self.layout.num_pages, 1)

    def overlap_ratio(self) -> float:
        """OR(G) over LIVE vertices only — the locality signal whose decay
        and repair this subsystem exists to measure."""
        return overlap_ratio(self.layout, self.graph, alive=~self.deleted)

    def mutation_stats(self) -> dict:
        return {"n_disk": self.n_disk, "delta_size": len(self.delta),
                "pending_tombstones": len(self.pending_tombstones),
                "dirty_pages": len(self.dirty_pages),
                "free_pages": len(self.free_pages),
                "flushes": self.flushes, "compactions": self.compactions,
                "live": self.live_count,
                "overlap_ratio": round(self.overlap_ratio(), 4)}

    # -- store attachment ----------------------------------------------------

    def attach_store(self, store) -> None:
        """Register a MutablePageStore built over this index's layout: every
        flush/compaction will invalidate, charge, and (on growth) extend it."""
        if not hasattr(store, "invalidate") or \
                not hasattr(store, "notify_append"):
            raise ValueError(
                "attach_store needs a MutablePageStore "
                "(build_store(..., mutable=True)) — a frozen stack cannot "
                "be invalidated")
        self._stores.append(store)

    def page_store(self, use_cache: bool = True):
        """Facade store (mirrors DiskIndex.page_store): the composed stack
        wrapped mutable and attached, memoized per cache choice."""
        key = bool(use_cache and self.cached.any())
        if key not in self._facade_stores:
            st = build_store(self.layout,
                             cached_vertices=self.cached if key else None,
                             mutable=True, device=self.device)
            self.attach_store(st)
            self._facade_stores[key] = st
        return self._facade_stores[key]

    # -- durability plumbing -------------------------------------------------

    def _journal_append(self, kind: str, payload=None,
                        sync: bool = False) -> None:
        """WAL discipline: the record goes to the journal BEFORE the op is
        applied. Journal pages a group commit flushes are booked on every
        attached store's write spine (`journal_writes`); the serving loop
        separately drains `journal.take_pending_io()` onto the background
        device clock. Replay never re-journals (the log already holds the
        record)."""
        if self.journal is None or self._replaying:
            return
        pages = self.journal.append(kind, payload, sync=sync)
        if pages:
            for st in self._stores:
                st.note_write(kind="journal", count=pages)

    def _crash_ticks(self, n: int) -> None:
        """One numbered, killable I/O boundary per data-page write (the
        journal ticks its own boundaries at sync time)."""
        if self.crash is not None:
            for _ in range(n):
                self.crash.tick()

    def journal_rng_state(self, state) -> None:
        """Persist the serving loop's rng cursor (a `bit_generator.state`
        dict) — force-synced, so a resumed run draws the same arrival and
        delete-victim stream an uninterrupted one would."""
        self._recovered_rng_state = state
        self._journal_append("rng", state, sync=True)

    def recovered_rng(self) -> np.random.Generator:
        """A generator positioned at the last journaled rng cursor — pass
        as `serve_open_loop(rng=)` to resume a crashed streaming run."""
        if self._recovered_rng_state is None:
            raise ValueError(
                "no rng cursor on record: the journal holds no 'rng' "
                "record (serve_open_loop journals one at the end of every "
                "mutating run over a durable index)")
        gen = np.random.default_rng(0)
        gen.bit_generator.state = self._recovered_rng_state
        return gen

    # -- mutations -----------------------------------------------------------

    def insert(self, vec: np.ndarray) -> int:
        """Stage a vector in the delta; it becomes disk-resident at the
        next flush. Returns the assigned vid."""
        vec = np.asarray(vec, np.float32).reshape(-1)
        self._journal_append("insert", vec)
        self.ops_applied += 1
        vid = self.next_vid
        self.next_vid += 1
        self.delta.insert(vid, vec)
        self._mutated = True
        return vid

    def delete(self, vid: int) -> bool:
        """Tombstone a vid. Delta vids die in memory; disk vids keep their
        record (routing) until compaction purges the page."""
        vid = int(vid)
        self._journal_append("delete", vid)
        self.ops_applied += 1
        self._mutated = True
        if vid in self.delta:
            return self.delta.remove(vid)
        if vid < 0 or vid >= self.n_disk or self.deleted[vid]:
            return False
        self.deleted[vid] = True
        self.pending_tombstones.add(vid)
        self.dirty_pages.add(int(self.layout.vid2page[vid]))
        return True

    def random_live_vid(self, rng: np.random.Generator) -> Optional[int]:
        """A uniformly random live DISK vid (delete-workload driver).
        Rejection-sampled: expected O(1) while most vids are live — this
        runs once per delete ARRIVAL in the serving ingest path, so an
        O(n) mask scan per call would make the mutation sweep scale as
        arrivals x n. The full scan is only the fallback when sampling
        keeps hitting tombstones (a mostly-dead id space)."""
        n = self.n_disk
        if n == 0:
            return None
        for _ in range(16):
            v = int(rng.integers(n))
            if not self.deleted[v]:
                return v
        alive = np.flatnonzero(~self.deleted[:n])
        if len(alive) == 0:
            return None
        return int(alive[rng.integers(len(alive))])

    @property
    def needs_flush(self) -> bool:
        return len(self.delta) >= self.mcfg.flush_threshold

    def maybe_flush(self) -> Optional[dict]:
        return self.flush() if self.needs_flush else None

    # -- device mirrors -------------------------------------------------------

    def _mirrors(self):
        """(vectors, graph) on the device: uploaded whole on first use,
        then kept current by `_sync_rows`."""
        if self._dev_vectors is None:
            self._dev_vectors = torch.as_tensor(
                np.ascontiguousarray(self.vectors, np.float32),
                device=self.device)
            self._dev_graph = torch.as_tensor(
                np.ascontiguousarray(self.graph), device=self.device
            ).to(torch.int64)
        return self._dev_vectors, self._dev_graph

    def _sync_rows(self, vector_rows=(), graph_rows=()) -> None:
        """Write the given rows of `vectors` and `graph` into the device
        mirrors (a no-op before the mirrors exist)."""
        if self._dev_vectors is None:
            return
        for host, dev, rows in ((self.vectors, self._dev_vectors,
                                 vector_rows),
                                (self.graph, self._dev_graph, graph_rows)):
            rows = np.unique(np.asarray(list(rows), np.int64))
            if len(rows):
                dev[torch.as_tensor(rows, device=self.device)] = \
                    torch.as_tensor(host[rows], device=self.device).to(
                        dev.dtype)

    # -- capacity growth (chunked) --------------------------------------------

    def _ensure_vid_capacity(self, n: int) -> None:
        cap = self.capacity
        if n <= cap:
            return
        chunk = self.mcfg.growth_chunk
        new_cap = ((n + chunk - 1) // chunk) * chunk
        grow = new_cap - cap
        self.vectors = np.concatenate(
            [self.vectors, np.zeros((grow, self.d), np.float32)])
        self.graph = np.concatenate(
            [self.graph, np.full((grow, self.graph.shape[1]), -1,
                                 self.graph.dtype)])
        self.pq.codes = np.concatenate(
            [self.pq.codes, np.zeros((grow, self.pq.m), np.uint8)])
        self.pq.__dict__.pop("_device_arrays", None)
        self.deleted = np.concatenate([self.deleted, np.ones(grow, bool)])
        self.cached = np.concatenate([self.cached, np.zeros(grow, bool)])
        self._rev.extend(set() for _ in range(grow))
        if self._dev_vectors is not None:
            # the grown rows are zeros / -1, as on the host
            self._dev_vectors = torch.cat([
                self._dev_vectors,
                self._dev_vectors.new_zeros((grow, self.d))])
            self._dev_graph = torch.cat([
                self._dev_graph,
                self._dev_graph.new_full((grow, self.graph.shape[1]), -1)])
        lay = self.layout
        # unassigned vids map to page 0 slot 0 — never referenced (no edge
        # reaches a vid that was never flushed)
        lay.vid2page = np.concatenate(
            [lay.vid2page, np.zeros(grow, lay.vid2page.dtype)])
        lay.vid2slot = np.concatenate(
            [lay.vid2slot, np.zeros(grow, lay.vid2slot.dtype)])

    def _ensure_free_pages(self, pages_needed: int) -> List[int]:
        """Allocate `pages_needed` wholly-empty pages, appending a CHUNK of
        empty pages to the layout when the free list runs short (shape
        growth is the expensive event — amortize it)."""
        lay = self.layout
        if len(self.free_pages) < pages_needed:
            chunk = max(1, self.mcfg.growth_chunk // lay.n_p)
            short = pages_needed - len(self.free_pages)
            grow = ((short + chunk - 1) // chunk) * chunk
            P = lay.num_pages
            lay.page_vids = np.concatenate(
                [lay.page_vids,
                 np.full((grow, lay.n_p), -1, lay.page_vids.dtype)])
            lay.page_vecs = np.concatenate(
                [lay.page_vecs,
                 np.zeros((grow,) + lay.page_vecs.shape[1:],
                          lay.page_vecs.dtype)])
            lay.page_nbrs = np.concatenate(
                [lay.page_nbrs,
                 np.full((grow,) + lay.page_nbrs.shape[1:], -1,
                         lay.page_nbrs.dtype)])
            lay.num_pages = P + grow
            self.free_pages.extend(range(P, P + grow))
        taken = self.free_pages[:pages_needed]
        del self.free_pages[:pages_needed]
        return taken

    def _notify_growth(self) -> None:
        for st in self._stores:
            st.notify_append(self.layout.num_pages, vertex_mask=self.cached)

    def _charge_background(self, read_pages: np.ndarray,
                           written_pages: np.ndarray) -> None:
        """Background I/O reaches every attached store's books: reads down
        the conservation spine, writes at the mutable layer, stale copies
        evicted."""
        touched = np.union1d(read_pages, written_pages).astype(np.int64)
        for st in self._stores:
            if len(read_pages):
                st.charge(read_pages)
            if len(written_pages):
                st.note_write(written_pages)
            if len(touched):
                st.invalidate(touched)

    # -- page rewriting ------------------------------------------------------

    def _refresh_page(self, p: int) -> None:
        """Rebuild one page's records from the authoritative per-vid state
        (vectors + graph)."""
        lay = self.layout
        row = lay.page_vids[p]
        valid = row >= 0
        if valid.any():
            vids = row[valid]
            lay.page_vecs[p][valid] = self.vectors[vids]
            lay.page_nbrs[p][valid] = self.graph[vids]
        lay.page_vecs[p][~valid] = 0.0
        lay.page_nbrs[p][~valid] = -1

    # -- insert edge construction -------------------------------------------

    def _robust_prune(self, x_vec: np.ndarray,
                      cand: np.ndarray) -> np.ndarray:
        """Numpy RobustPrune (Vamana): pick nearest candidates, killing any
        candidate an earlier pick alpha-dominates (squared-distance form)."""
        a2 = self.mcfg.insert_alpha ** 2
        R = self.graph.shape[1]
        d2 = np.sum(np.square(self.vectors[cand] - x_vec), axis=1)
        order = np.argsort(d2, kind="stable")
        cand, d2 = cand[order], d2[order]
        alive = np.ones(len(cand), bool)
        out: List[int] = []
        for j in range(len(cand)):
            if not alive[j]:
                continue
            p = int(cand[j])
            out.append(p)
            if len(out) >= R:
                break
            dpc = np.sum(np.square(self.vectors[cand] - self.vectors[p]),
                         axis=1)
            alive &= a2 * dpc > d2
        return np.asarray(out, np.int64)

    def _add_back_edge(self, u: int, x: int) -> bool:
        """Append x to N(u) (free slot, else replace the farthest neighbor
        when x is closer). Returns whether N(u) changed. Maintains the
        reverse-adjacency index."""
        row = self.graph[u]
        if (row == x).any():
            return False                     # batch-mate already wired it
        free = np.flatnonzero(row < 0)
        if len(free):
            row[free[0]] = x
            self._rev[x].add(u)
            return True
        dux = float(np.sum(np.square(self.vectors[u] - self.vectors[x])))
        dn = np.sum(np.square(self.vectors[row] - self.vectors[u]), axis=1)
        far = int(np.argmax(dn))
        if dux < float(dn[far]):
            old = int(row[far])
            row[far] = x
            if not (row == old).any():       # seed graphs can carry dups
                self._rev[old].discard(u)
            self._rev[x].add(u)
            return True
        return False

    # -- flush ---------------------------------------------------------------

    def flush(self) -> dict:
        """Materialize the delta backlog onto pages in ARRIVAL order (the
        append zone), wire the inserts into the graph, and invalidate/charge
        every touched page. Returns the I/O accounting dict the serving
        layer prices: {flushed, pages_read, pages_written, read_pages,
        written_pages}."""
        # two-phase: the flush intent is durable BEFORE any page moves —
        # recovery re-runs the whole flush from the journaled inserts
        self._journal_append("flush", None, sync=True)
        self.ops_applied += 1
        vids, vecs = self.delta.drain()
        m = len(vids)
        if m == 0:
            return {"flushed": 0, "pages_read": 0, "pages_written": 0,
                    "read_pages": np.zeros(0, np.int64),
                    "written_pages": np.zeros(0, np.int64)}
        lay = self.layout
        self._ensure_vid_capacity(self.next_vid)
        self.vectors[vids] = vecs
        self.deleted[vids] = False
        self.pq.codes[vids] = pq_mod.encode(vecs, self.pq.centroids,
                                            device=self.device)
        self.pq.__dict__.pop("_device_arrays", None)
        dev_vectors, dev_graph = self._mirrors()
        self._sync_rows(vector_rows=vids)

        # --- place in arrival order onto wholly-empty pages ----------------
        n_p = lay.n_p
        pages = self._ensure_free_pages((m + n_p - 1) // n_p)
        for i, vid in enumerate(vids):
            p, s = pages[i // n_p], i % n_p
            lay.page_vids[p, s] = vid
            lay.vid2page[vid] = p
            lay.vid2slot[vid] = s
        self.n_disk = self.next_vid

        # --- graph wiring: beam-search candidates + robust prune -----------
        mcfg = self.mcfg
        res = beam_search_mem(dev_vectors, dev_graph, self.medoid, vecs,
                              L=mcfg.insert_L, width=mcfg.insert_width,
                              device=self.device)
        vis = np.asarray(res["visited_ids"])
        top = np.asarray(res["ids"])
        modified: Set[int] = set()
        # two passes: every new row is FINAL before any back-edge lands in
        # it — a one-pass interleave would wipe back-edges already placed
        # into a later batch-mate's row (and desync the reverse index)
        for i, vid in enumerate(vids):
            cand = np.concatenate([vis[i], top[i], vids])
            cand = np.unique(cand[(cand >= 0) & (cand < self.n_disk)])
            cand = cand[(cand != vid) & ~self.deleted[cand]]
            if len(cand) == 0:
                cand = np.asarray([self.medoid], np.int64)
            nbrs = self._robust_prune(vecs[i], cand)
            self.graph[vid] = -1
            self.graph[vid, :len(nbrs)] = nbrs
            for u in nbrs:
                self._rev[int(u)].add(int(vid))
        for vid in vids:
            for u in self.graph[vid]:
                if u >= 0 and self._add_back_edge(int(u), int(vid)):
                    modified.add(int(u))
        self._sync_rows(graph_rows=list(vids) + sorted(modified))

        # --- rewrite + account ---------------------------------------------
        # back-edge pages are read-modify-written and invalidated, but NOT
        # marked dirty: one replaced neighbor slot barely moves their
        # locality, and handing a well-packed page to the localized
        # re-packer would dismantle co-location the packer cannot see
        # (its external edges). Only the arrival-order append zone is
        # compaction-eligible.
        back_pages = ({int(lay.vid2page[u]) for u in modified}
                      - set(pages))
        for p in list(pages) + sorted(back_pages):
            self._refresh_page(p)
        written = np.asarray(sorted(set(pages) | back_pages), np.int64)
        read = np.asarray(sorted(back_pages), np.int64)  # read-modify-write
        self.dirty_pages.update(int(p) for p in pages)
        self.append_pages.update(int(p) for p in pages)
        self.flushes += 1
        self._crash_ticks(len(written))   # each data-page write can kill
        self._notify_growth()
        self._charge_background(read, written)
        return {"flushed": m, "pages_read": len(read),
                "pages_written": len(written),
                "read_pages": read, "written_pages": written}

    # -- compaction ----------------------------------------------------------

    def _live_page_links(self, v: int) -> np.ndarray:
        """Pages of v's live neighbors (the co-location signal relocation
        trades on)."""
        nb = self.graph[v]
        nb = nb[nb >= 0]
        nb = nb[~self.deleted[nb]]
        return self.layout.vid2page[nb]

    def compact(self, max_pages: Optional[int] = None) -> dict:
        """One bounded background-compaction run over up to `max_pages`
        dirty pages, in three strictly locality-non-negative steps:

        1. PURGE: tombstoned records on the selected pages are cleared in
           place (their in-edges spliced through the deleted vertex's own
           neighbors) — no survivor moves, so a well-packed page keeps its
           packing and gains a HOLE.
        2. RELOCATE: each live resident of a selected APPEND page whose
           neighbors cluster on some other page with a hole moves into
           that hole when it strictly gains co-links — delete holes become
           the landing slots that pull the append zone back toward its
           graph neighborhood (the FreshDiskANN/PageANN consolidation
           move).
        3. RE-PACK: what remains on the selected append pages is re-packed
           among those same pages with the PageShuffle greedy packer
           (core/page_shuffle.py: greedy_pack on the dirty neighborhood
           only), so mutual-neighbor inserts stop sitting in arrival
           order; wholly-emptied pages return to the free list.

        Returns the flush() accounting shape plus {compacted_pages,
        purged, relocated, repacked}."""
        budget = max_pages or self.mcfg.compaction_pages
        if budget < 1:
            raise ValueError(f"max_pages={budget} must be >= 1")
        # journal the RESOLVED budget: replay must compact the same slice
        self._journal_append("compact", int(budget), sync=True)
        self.ops_applied += 1
        if not self.dirty_pages:
            return {"compacted_pages": 0, "purged": 0, "relocated": 0,
                    "repacked": 0, "pages_read": 0, "pages_written": 0,
                    "read_pages": np.zeros(0, np.int64),
                    "written_pages": np.zeros(0, np.int64)}
        self._mutated = True
        lay = self.layout
        pages = sorted(self.dirty_pages)[:budget]
        page_set = set(int(p) for p in pages)
        pv = lay.page_vids[pages]
        vids = pv[pv >= 0]
        purged = vids[self.deleted[vids]]

        # --- 1. purge: splice in-edges, clear slots in place ---------------
        outside_touched: Set[int] = set()
        if len(purged):
            purged_set = set(int(v) for v in purged)
            # in-edges come from the incrementally maintained reverse
            # index — no O(n·R) full-graph scan per run
            hit_rows = sorted(set().union(
                *(self._rev[v] for v in purged_set)) - purged_set)
            for u in hit_rows:
                u = int(u)
                row = self.graph[u]
                present = set(int(v) for v in row if v >= 0)
                for j, v in enumerate(row):
                    if int(v) in purged_set:
                        repl = -1
                        for w in self.graph[int(v)]:
                            w = int(w)
                            if w >= 0 and w != u and not self.deleted[w] \
                                    and w not in present:
                                repl = w
                                break
                        row[j] = repl
                        self._rev[int(v)].discard(u)
                        if repl >= 0:
                            self._rev[repl].add(u)
                            present.add(repl)
                outside_touched.add(u)
            for v in purged_set:
                p, s = int(lay.vid2page[v]), int(lay.vid2slot[v])
                lay.page_vids[p, s] = -1            # the hole stays put
                for w in self.graph[v]:             # out-edges die with v
                    if w >= 0:
                        self._rev[int(w)].discard(v)
            self.graph[purged] = -1
            self._sync_rows(graph_rows=hit_rows + sorted(purged_set))
            for v in purged_set:
                self._rev[v].clear()
                self.pending_tombstones.discard(v)
            if self.medoid in purged_set:
                # the entry point just lost its out-edges — re-elect the
                # live vertex nearest the live mean (a tombstoned medoid
                # keeps routing until THIS moment, so only purge needs it)
                alive = np.flatnonzero(~self.deleted[:self.n_disk])
                if len(alive):
                    av = self.vectors[alive]
                    mean = av.mean(axis=0)
                    self.medoid = int(alive[np.argmin(
                        np.sum(np.square(av - mean), axis=1))])

        # --- 2. relocate append residents into neighbor-page holes ---------
        relocated = 0
        reloc_targets: Set[int] = set()
        apages = [p for p in pages if p in self.append_pages]
        for p in apages:
            for s in range(lay.n_p):
                v = int(lay.page_vids[p, s])
                if v < 0:
                    continue
                links = self._live_page_links(v)
                if len(links) == 0:
                    continue
                here = int((links == p).sum())
                cands, counts = np.unique(links, return_counts=True)
                for oi in np.argsort(counts, kind="stable")[::-1]:
                    c, cnt = int(cands[oi]), int(counts[oi])
                    if cnt <= here:
                        break                       # no strict gain left
                    if c == p or (c in page_set and c in self.append_pages):
                        continue                    # re-pack handles those
                    hole = np.flatnonzero(lay.page_vids[c] < 0)
                    if len(hole) == 0:
                        continue
                    lay.page_vids[c, hole[0]] = v
                    lay.page_vids[p, s] = -1
                    lay.vid2page[v] = c
                    lay.vid2slot[v] = hole[0]
                    reloc_targets.add(c)
                    relocated += 1
                    break

        # --- 3. greedy re-pack of what remains in the append zone ----------
        repacked = 0
        packed = np.zeros(0, np.int64)
        if apages:
            rem = lay.page_vids[apages]
            rem = np.sort(rem[rem >= 0])
            if len(rem):
                lid = {int(v): i for i, v in enumerate(rem)}
                sub = np.full((len(rem), self.graph.shape[1]), -1, np.int32)
                for i, v in enumerate(rem):
                    for j, w in enumerate(self.graph[int(v)]):
                        sub[i, j] = lid.get(int(w), -1)
                adj = undirected_adjacency(sub)
                packed = rem[greedy_pack(adj, bfs_order(adj, 0), lay.n_p)]
                repacked = len(packed)
            n_p = lay.n_p
            for i, p in enumerate(apages):
                seg = packed[i * n_p:(i + 1) * n_p]
                lay.page_vids[p] = -1
                lay.page_vids[p, :len(seg)] = seg
                if len(seg):
                    lay.vid2page[seg] = p
                    lay.vid2slot[seg] = np.arange(
                        len(seg), dtype=lay.vid2slot.dtype)

        # --- bookkeeping + rewrite + account -------------------------------
        for p in pages:
            p = int(p)
            self._refresh_page(p)
            self.dirty_pages.discard(p)
            self.append_pages.discard(p)
            if not (lay.page_vids[p] >= 0).any():
                self.free_pages.append(p)
        outside_pages = (({int(lay.vid2page[u]) for u in outside_touched}
                          | reloc_targets) - page_set)
        for p in sorted(outside_pages):
            self._refresh_page(p)
        nonfree = set(int(p) for p in pages) - set(self.free_pages)
        read = np.asarray(sorted(page_set | outside_pages), np.int64)
        # freed pages need no device write — they leave the mapping
        written = np.asarray(sorted(nonfree | outside_pages), np.int64)
        self.compactions += 1
        self._crash_ticks(len(written))   # each data-page write can kill
        self._charge_background(read, written)
        return {"compacted_pages": len(pages), "purged": len(purged),
                "relocated": relocated, "repacked": repacked,
                "pages_read": len(read), "pages_written": len(written),
                "read_pages": read, "written_pages": written}

    # -- snapshots (consistent checkpoints) ----------------------------------

    def snapshot(self) -> dict:
        """A consistent checkpoint of the full mutable state: deep copies
        of the layout, graph, PQ codes, vectors, tombstones, delta
        contents, dirty/append/free page sets, counters, and the rng
        cursor. Priced as SEQUENTIAL snapshot writes on every attached
        store's spine (`snapshot_pages` = the page-space image plus the
        per-vid sidecars), and the journal is truncated — the checkpoint
        supersedes it. The returned dict feeds `restore()`/
        `recover(snapshot=)` and is never mutated by either, so one
        snapshot can seed any number of recoveries (and ROADMAP item 3's
        shard migration can ship it wholesale)."""
        lay = self.layout
        aux_bytes = (self.graph.nbytes + self.pq.codes.nbytes
                     + self.vectors.nbytes + self.deleted.nbytes)
        pages = lay.num_pages + -(-aux_bytes // lay.page_bytes)
        state = dict(mutable_state(self), snapshot_pages=pages)
        for st in self._stores:
            st.note_write(kind="snapshot", count=pages)
        if self.journal is not None:
            self.journal.truncate()
        return state

    def restore(self, snap: dict) -> None:
        """Load a `snapshot()` checkpoint into THIS index (built over the
        same base). Deep-copies everything out of `snap` so the snapshot
        stays reusable, and rebuilds the derived reverse adjacency."""
        self.layout = _copy_layout(snap["layout"])
        self.graph = snap["graph"].copy()
        self.pq.codes = snap["codes"].copy()
        self.pq.__dict__.pop("_device_arrays", None)
        self.vectors = snap["vectors"].copy()
        self.deleted = snap["deleted"].copy()
        self.cached = snap["cached"].copy()
        self.pending_tombstones = set(snap["pending_tombstones"])
        self.delta = DeltaIndex(self.d, self.device)
        self.delta.load(snap["delta"])
        self.dirty_pages = set(snap["dirty_pages"])
        self.append_pages = set(snap["append_pages"])
        self.free_pages = list(snap["free_pages"])
        self.next_vid = int(snap["next_vid"])
        self.n_disk = int(snap["n_disk"])
        self.medoid = int(snap["medoid"])
        self.flushes = int(snap["flushes"])
        self.compactions = int(snap["compactions"])
        self._mutated = bool(snap["mutated"])
        self.ops_applied = int(snap["ops_applied"])
        self._recovered_rng_state = snap["rng_state"]
        self._rev = _ReverseAdjacency(self.graph, self.device)
        # every row may differ: the mirrors are uploaded anew when next used
        self._dev_vectors = self._dev_graph = None
        for st in self._stores:
            st.notify_append(self.layout.num_pages, vertex_mask=self.cached)

    # -- search (the merged path) -------------------------------------------

    def disk_cfg(self, cfg: Optional[SearchConfig] = None) -> SearchConfig:
        """The SearchConfig the DISK side of a merged search runs: while
        tombstones are pending, the kernel overfetches so filtered slots
        can backfill from the candidate pool."""
        cfg = cfg or self.cfg
        if not self.pending_tombstones or self.mcfg.overfetch == 0:
            return cfg
        return cfg.replace(k=min(cfg.L, cfg.k + self.mcfg.overfetch))

    def merge_mutations(self, stats: QueryStats, queries: np.ndarray,
                        cfg: Optional[SearchConfig] = None) -> QueryStats:
        """Fold the delta's exact results into the kernel's result heap and
        filter tombstones, truncating back to cfg.k. The delta scan's
        distance evaluations are charged to `mem_evals` so the device model
        prices them."""
        cfg = cfg or self.cfg
        k = cfg.k
        ids = np.asarray(stats.ids)
        dists = np.asarray(stats.dists, np.float32)
        dead = (ids >= 0) & self.deleted[np.maximum(ids, 0)]
        dists = np.where(dead | (ids < 0), np.float32(np.inf), dists)
        ids = np.where(dead, -1, ids)
        d_ids, d_dists, evals = self.delta.search(queries, k)
        cat_ids = np.concatenate([ids.astype(np.int64), d_ids], axis=1)
        cat_d = np.concatenate([dists, d_dists], axis=1)
        order = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
        stats.ids = np.take_along_axis(cat_ids, order, axis=1).astype(
            stats.ids.dtype)
        stats.dists = np.take_along_axis(cat_d, order, axis=1).astype(
            stats.dists.dtype)
        stats.mem_evals = stats.mem_evals + evals
        return stats

    def search(self, queries: np.ndarray,
               cfg: Optional[SearchConfig] = None,
               batch: int = 256) -> QueryStats:
        """The DiskIndex.search facade, mutation-aware: disk search (with
        tombstone overfetch) merged with the delta scan. With zero
        mutations this is bit-identical to the frozen facade."""
        cfg = cfg or self.cfg
        store = self.page_store(use_cache=cfg.cache_frac > 0)
        if not self._mutated:
            return search_batched(store, self.pq, cfg, queries,
                                  medoid=self.medoid,
                                  memgraph=self.memgraph, batch=batch,
                                  collect_visited=False)
        stats = search_batched(store, self.pq, self.disk_cfg(cfg), queries,
                               medoid=self.medoid, memgraph=self.memgraph,
                               batch=batch, collect_visited=False)
        return self.merge_mutations(stats, queries, cfg)


# -- crash recovery ----------------------------------------------------------

def recover(base: DiskIndex, journal: MutationJournal,
            mcfg: Optional[MutationConfig] = None,
            snapshot: Optional[dict] = None,
            model=None, attach=()) -> MutableIndex:
    """Rebuild a MutableIndex from its durable remains: the base (or a
    `snapshot()` checkpoint) plus the journal's committed record prefix.

    Replay goes through the SAME deterministic code paths the live index
    ran — insert staging, flush placement + graph wiring, compaction — so
    the recovered state is bit-identical to an index that applied the same
    op prefix uninterrupted. The journal's volatile group-commit buffer is
    dropped first (it died with the process), the torn tail is discarded
    by checksum (MutationJournal.replay), "intent" markers are skipped
    (logical replay rebuilds every page they named), and the last "rng"
    record restores the serving loop's generator cursor
    (`recovered_rng()`).

    `attach` takes MutablePageStores (built over the recovered index's
    layout) to attach BEFORE replay: the replayed flushes/compactions then
    charge their reads and book their writes down the conservation spine,
    exactly as the live run did. `model` (SSDModel, default-constructed
    when omitted) prices the recovery itself — journal pages read
    sequentially plus every redo read/write — into
    `MutableIndex.last_recovery_us`, which the next `serve_open_loop`
    reports (and clears) as its `recovery_us` column.

    Idempotent: recovering twice from the same remains yields bit-identical
    indexes (the journal is only read, the snapshot only copied)."""
    idx = MutableIndex(base, mcfg)
    for st in attach:
        idx.attach_store(st)
    if snapshot is not None:
        idx.restore(snapshot)
    journal.drop_uncommitted()
    records = journal.replay()
    redo_reads = redo_writes = 0
    idx._replaying = True
    try:
        for _seq, kind, payload in records:
            if kind == "insert":
                idx.insert(payload)
            elif kind == "delete":
                idx.delete(payload)
            elif kind == "flush":
                acct = idx.flush()
                redo_reads += acct["pages_read"]
                redo_writes += acct["pages_written"]
            elif kind == "compact":
                acct = idx.compact(payload)
                redo_reads += acct["pages_read"]
                redo_writes += acct["pages_written"]
            elif kind == "rng":
                idx._recovered_rng_state = payload
            # "intent"/"snapshot" markers carry no logical state
    finally:
        idx._replaying = False
    idx.journal = journal            # resumed ops append after the prefix
    if model is None:
        from repro_torch.core.device_model import SSDModel
        model = SSDModel()
    idx.last_recovery_us = (
        journal.log_pages * model.read_service_us(journal.cfg.page_bytes)
        + redo_reads * model.read_service_us(idx.layout.page_bytes)
        + redo_writes * model.write_service_us(idx.layout.page_bytes))
    return idx
