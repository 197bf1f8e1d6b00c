"""QueryStats — the one per-query accounting record shared by every layer.
(A copy of src/repro/core/stats.py: the port imports nothing of `repro`.)

The search kernel (core/search_kernel.py) produces raw per-query counters;
`QueryStats` carries them from the kernel to the device model, the serving
layer and the benchmark scripts through a single code path (previously each
benchmark hand-plumbed its own dict of fields out of `SearchResult`).

`visited_pages` is the per-query charged-page bitmap (B, num_pages). It is
what the I/O layer's `BatchedPageStore` consumes to coalesce duplicate page
requests across the queries of a batch — an accounting the scalar per-query
counters cannot express.

`page_trace` is the temporally ordered form of the same charges,
(B, max_iters, w) with -1 padding: row (b, h) names the distinct pages
query b charged at hop h. The stateful cache subsystem
(repro/io/page_cache.py) replays it against LRU/FIFO/2Q caches whose state
persists across batches — an accounting the order-free bitmap cannot
express.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class QueryStats:
    ids: np.ndarray            # (B, k)
    dists: np.ndarray          # (B, k)
    hops: np.ndarray           # (B,)
    page_reads: np.ndarray     # (B,) unique page fetches charged to SSD
    cache_hits: np.ndarray     # (B,)
    n_read_records: np.ndarray  # (B,) records fetched (N_read, Eq. 3)
    n_eff: np.ndarray          # (B,) records actually expanded (N_eff)
    full_evals: np.ndarray     # (B,) full-precision distance computations
    pq_evals: np.ndarray       # (B,) ADC distance computations
    mem_hops: np.ndarray       # (B,) MemGraph in-memory hops
    mem_evals: np.ndarray      # (B,) MemGraph distance evals
    # (B, num_pages) bool — pages each query charged to the device; feeds
    # BatchedPageStore's cross-query dedup. Optional: facade callers that
    # never batch across queries may drop it.
    visited_pages: Optional[np.ndarray] = None
    # (B, max_iters, w) int32, -1 padded — the same charged pages in hop
    # order; feeds the stateful cache subsystem's trace replay
    # (repro/io/page_cache.py). Optional: only trace-replaying callers
    # (dynamic cache policies, prefetch) pay for it.
    page_trace: Optional[np.ndarray] = None
    # (B,) int64 — per-query tenant ids, stamped by the SERVING layer (the
    # kernel is tenant-blind): routes trace replay to per-tenant cache
    # partitions and keys per-tenant report accounting. Optional: single-
    # tenant callers never carry it.
    tenants: Optional[np.ndarray] = None
    # (B,) float64 — MEASURED fused-kernel wall clock per query in us (the
    # query's page count x the batch's measured per-page step rate), set
    # only under SearchConfig.pipeline == "fused"
    # (core/search_kernel.measure_step_us). Sits NEXT TO the modeled device
    # time — never inside it: the device model stays the paper's analytic
    # account, and this column is what it is compared against.
    measured_step_us: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.hops)

    def io_utilization(self) -> float:
        return self.n_eff.sum() / max(self.n_read_records.sum(), 1)

    # -- construction -------------------------------------------------------

    _KERNEL_KEYS = {
        "ids": "ids", "dists": "dists", "hops": "hops",
        "page_reads": "page_reads", "cache_hits": "cache_hits",
        "n_read_records": "n_read", "n_eff": "n_eff",
        "full_evals": "full_evals", "pq_evals": "pq_evals",
        "mem_hops": "mem_hops", "mem_evals": "mem_evals",
        "visited_pages": "visited_pages", "page_trace": "page_trace",
        "tenants": "tenants", "measured_step_us": "measured_step_us",
    }

    @classmethod
    def from_kernel(cls, out: dict) -> "QueryStats":
        """Build from one kernel output dict (see search_kernel.KERNEL_KEYS)."""
        kw = {f: np.asarray(out[k]) for f, k in cls._KERNEL_KEYS.items()
              if k in out}
        kw.setdefault("visited_pages", None)
        kw.setdefault("page_trace", None)
        kw.setdefault("tenants", None)
        kw.setdefault("measured_step_us", None)
        return cls(**kw)

    @classmethod
    def concat(cls, parts: List["QueryStats"]) -> "QueryStats":
        """Concatenate per-batch stats along the query axis.

        `visited_pages` widths may differ across batches when the page
        space GROWS mid-run (streaming updates append pages): earlier
        bitmaps are padded with False — a page that did not exist cannot
        have been charged. `page_trace` rows are -1-padded likewise (its
        width follows the beam, which degrade levels shrink)."""
        if len(parts) == 1:
            return parts[0]
        kw = {}
        for f in cls._KERNEL_KEYS:
            vals = [getattr(p, f) for p in parts]
            if any(v is None for v in vals):
                kw[f] = None
                continue
            if f == "visited_pages":
                w = max(v.shape[1] for v in vals)
                vals = [v if v.shape[1] == w else
                        np.pad(v, ((0, 0), (0, w - v.shape[1])))
                        for v in vals]
            elif f == "page_trace":
                h = max(v.shape[1] for v in vals)
                w = max(v.shape[2] for v in vals)
                vals = [v if v.shape[1:] == (h, w) else
                        np.pad(v, ((0, 0), (0, h - v.shape[1]),
                                   (0, w - v.shape[2])),
                               constant_values=-1)
                        for v in vals]
            kw[f] = np.concatenate(vals)
        return cls(**kw)

    def take(self, n: int) -> "QueryStats":
        """First n queries (drops padding added by the batch scheduler)."""
        kw = {f: (getattr(self, f)[:n] if getattr(self, f) is not None
                  else None) for f in self._KERNEL_KEYS}
        return QueryStats(**kw)

    # -- metrics (the single summary code path) -----------------------------

    def batch_unique_pages(self) -> int:
        """Pages a cross-query coalescing fetcher would issue for this batch
        (union of per-query charged pages). Requires visited_pages."""
        if self.visited_pages is None:
            raise ValueError("visited_pages not collected for these stats")
        return int(self.visited_pages.any(axis=0).sum())

    def summary(self, model, *, d: int, pq_m: int, page_bytes: int,
                pipeline: bool = False) -> dict:
        """Latency/QPS/device counters via the SSD device model — the one
        code path every benchmark and test consumes (device_model.summarize
        is a thin alias kept for compatibility)."""
        lat = model.query_latency_us(
            hops=self.hops.astype(np.float64),
            pages=self.page_reads.astype(np.float64),
            full_evals=self.full_evals.astype(np.float64),
            pq_evals=self.pq_evals.astype(np.float64),
            mem_evals=self.mem_evals.astype(np.float64),
            d=d, pq_m=pq_m, page_bytes=page_bytes, pipeline=pipeline)
        qps = model.qps(lat, pages=self.page_reads, page_bytes=page_bytes)
        dev = model.device_counters(qps, pages=self.page_reads,
                                    page_bytes=page_bytes)
        io_us = (self.page_reads.astype(np.float64)
                 * model.page_service_us(page_bytes))
        return {
            "mean_latency_us": float(np.mean(lat)),
            "p99_latency_us": float(np.percentile(lat, 99)),
            "qps": qps,
            "mean_pages_per_query": float(np.mean(self.page_reads)),
            "mean_hops": float(np.mean(self.hops)),
            "io_fraction": float(np.mean(io_us / np.maximum(lat, 1e-9))),
            "u_io": float(self.io_utilization()),
            **dev,
        }


# Compatibility alias: the pre-refactor engine exposed the same record under
# this name; downstream code may keep using it.
SearchResult = QueryStats
