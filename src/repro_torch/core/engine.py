"""Engine facade of the port: `SearchConfig` and `DiskIndex`.

The port of src/repro/core/engine.py. `SearchConfig` has the same fields and
checks (the paper's eight techniques as one composable configuration, §4).
`DiskIndex.search` drives core/search_kernel.search_batched on the index's
device: page reads, hops, distance evaluations and recall are counted from
the actual search, and its time is the card's wall clock. The SSD device
model (core/device_model.py, `QueryStats.summary`) prices those counts as
the paper's disk would serve them. A host-clock tracer
(`search(..., tracer=Tracer(clock="host"))`) records where a call's time
goes (docs/torch_host_clock.md).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import search_kernel
from repro_torch.core.hop_loop import HopGraphs
from repro_torch.core.stats import QueryStats, SearchResult  # noqa: F401
from repro_torch.io import build_store


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    name: str = "baseline"
    k: int = 10
    L: int = 64                  # candidate pool
    beam_width: int = 8
    max_iters: int = 96
    # --- memory layout ---
    pq_m: int = 16
    cache_frac: float = 0.0
    cache_policy: str = "sssp"   # "sssp" (paper) | "freq" (beyond-paper)
    memgraph_frac: float = 0.0
    memgraph_entries: int = 4
    memgraph_L: int = 32
    # --- disk layout ---
    page_shuffle: bool = False
    all_in_storage: bool = False
    page_bytes: int = 4096
    # --- search algorithm ---
    page_search: bool = False
    dynamic_width: bool = False
    dw_min: int = 2
    dw_max: int = 32
    # Pipeline execution mode: False = sequential; True = speculative
    # overlap priced by the device model's analytic rebate; "fused" = the
    # same search (identical results) but each batch's traced page schedule
    # is also re-executed through the fused page kernel
    # (kernels/csrc/fused_page_rank.cu), and QueryStats.measured_step_us
    # carries the MEASURED kernel step time next to the modeled time.
    pipeline: bool = False       # False | True | "fused"
    pipeline_spec: int = 2       # speculative reads per step

    def __post_init__(self):
        if self.k > self.L:
            raise ValueError(
                f"k={self.k} must be <= L={self.L}: the candidate pool "
                f"must hold at least the k results it returns")
        if self.dw_min > self.dw_max:
            raise ValueError(
                f"dw_min={self.dw_min} must be <= dw_max={self.dw_max} "
                f"(DynamicWidth doubles the beam from dw_min up to dw_max)")
        if not 0.0 <= self.cache_frac <= 1.0:
            raise ValueError(
                f"cache_frac={self.cache_frac} must be in [0, 1] "
                f"(fraction of vertices pinned in memory)")
        if self.pipeline_spec < 0:
            raise ValueError(
                f"pipeline_spec={self.pipeline_spec} must be >= 0 "
                f"(speculative reads per step)")
        if self.pipeline not in (False, True, "fused"):
            raise ValueError(
                f"pipeline={self.pipeline!r} must be False, True, or "
                f"'fused' (the measured fused-kernel path)")

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------


class DiskIndex:
    """Bundles layout + PQ + optional cache/memgraph on one device; see
    core/presets.py and core/builder.py for construction. `device` is
    "cuda" unless the caller names another; with no card and no device
    named, construction fails."""

    def __init__(self, layout, pq, graph, medoid, cfg: SearchConfig,
                 memgraph=None, cached: Optional[np.ndarray] = None,
                 build_stats: Optional[dict] = None, *, device=None):
        self.device = resolve_device(device)
        self.layout = layout
        self.pq = pq
        self.graph = graph
        self.medoid = medoid
        self.cfg = cfg
        self.memgraph = memgraph
        n = graph.shape[0]
        self.cached = (cached if cached is not None else np.zeros(n, bool))
        self.build_stats = build_stats or {}
        self._stores = {}

    def memory_bytes(self) -> int:
        b = self.pq.memory_bytes if not self.cfg.all_in_storage else 0
        if self.memgraph is not None:
            b += self.memgraph.memory_bytes
        b += int(self.cached.sum()) * self.layout.record_bytes
        b += self.layout.mapping_bytes
        return b

    def page_store(self, use_cache: bool = True, batched: bool = False):
        """The index's I/O-layer view: array store + cache decorator (when
        the index holds a cache and the caller wants it) + optional batch
        coalescer. Memoized per (use_cache, batched) so repeated searches
        share counters and the device tensors."""
        key = (bool(use_cache and self.cached.any()), batched)
        if key not in self._stores:
            self._stores[key] = build_store(
                self.layout,
                cached_vertices=self.cached if key[0] else None,
                batched=batched, device=self.device)
        return self._stores[key]

    def search(self, queries: np.ndarray, cfg: Optional[SearchConfig] = None,
               batch: int = 256, tracer=None) -> QueryStats:
        """`tracer` (repro_torch.obs.Tracer(clock="host")) records the call
        as one `search.call` span over the spans of search_batched, with the
        call's counts in its args: queries, batches, hop_iters (disk-loop
        iterations), mem_iters (MemGraph-loop iterations), syncs,
        graph_hops (disk-loop iterations replayed from a captured CUDA
        graph), graph_captures (graphs captured in the call),
        mem_graph_iters and mem_graph_captures (the same two of the
        MemGraph loop), page_bytes
        and sectors_per_page (the layout's page, core/pages.py) and
        sectors_read (the call's page reads times sectors_per_page)."""
        cfg = cfg or self.cfg
        if tracer:
            call = tracer.begin("search.call", "search")
            # the two loops' graph caches (core/hop_loop.py)
            caches = (search_kernel.GRAPHS,
                      HopGraphs() if self.memgraph is None
                      else self.memgraph.graphs)
            before = [c.counts() for c in caches]
        # the cache only serves reads when the search config enables it
        store = self.page_store(use_cache=cfg.cache_frac > 0)
        # facade callers never batch across queries: skip the per-query
        # visited-page bitmaps
        st = search_kernel.search_batched(
            store, self.pq, cfg, queries, medoid=self.medoid,
            memgraph=self.memgraph, batch=batch, collect_visited=False,
            tracer=tracer)
        if tracer:
            n = Counter(s.name for s in tracer.spans[call + 1:])
            (hops, captures), (mem_hops, mem_captures) = (
                [now - then for now, then in zip(c.counts(), b)]
                for c, b in zip(caches, before))
            tracer.end(call, args={
                "queries": len(queries), "batches": n["search.hops"],
                "hop_iters": n["search.hop"], "mem_iters": n["mem.hop"],
                "syncs": n["search.sync"],
                "graph_hops": hops, "graph_captures": captures,
                "mem_graph_iters": mem_hops,
                "mem_graph_captures": mem_captures,
                "page_bytes": self.layout.page_bytes,
                "sectors_per_page": self.layout.sectors_per_page,
                "sectors_read": (int(st.page_reads.sum())
                                 * self.layout.sectors_per_page)})
        return st
