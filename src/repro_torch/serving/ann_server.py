"""Serving layer: concurrent ANN query serving — closed-loop, open-loop,
admission-controlled, and multi-tenant.

The port of src/repro/serving/ann_server.py. Its one device contact is
`AnnServer._execute`, which runs the port's `search_batched` on the
server's store on the index's device; with `pipeline="fused"` each batch's
page schedule also runs through the `fused_page_rank` CUDA kernel to stamp
`measured_step_us`. Everything else is host code on the virtual clock,
copied from the reference.

The two measurement contracts
-----------------------------
Closed loop (`serve_closed_loop`): W clients each keep exactly ONE query in
flight — submit, wait, resubmit (the paper's concurrency axis, §8; device
queue depth is set by the client count). The loop is self-throttling:
offered load automatically equals served load, so every submission
completes, latency is bounded by construction, and the interesting axis is
how latency and QPS move with W. The report (`ServingReport`) therefore
covers the ENTIRE workload of workers x rounds queries.

Open loop (`serve_open_loop`): queries arrive by a Poisson process at
`rate_qps` for `duration_us`, INDEPENDENT of completions — the arrival-rate
axis the §8 storage-centric/hybrid guideline actually turns on. Nothing
throttles arrivals, so past device saturation the backlog and every latency
percentile grow with the window length: an uncontrolled open-loop p99 is a
statement about the measurement duration, not about the system. The report
(`OpenLoopReport`) is therefore split by admission outcome: `offered`
arrivals, `admitted` (= `completed`: every admitted query is served to
completion, even past the window's end), `shed`, `degraded`; latency
percentiles are over the ADMITTED work only, and throughput appears twice —
`offered_qps` (arrivals / window) vs `qps` (goodput: completions / elapsed).

Admission control (`ServerConfig.admission`, repro_torch/serving/admission.py)
decides at arrival time what enters the queue: a token bucket sheds above a
configured rate; a bounded queue sheds by policy — "reject" (drop newest),
"shed-oldest" (drop the query whose SLO is already lost), or "degrade"
(admit everything but serve under pressure with a shrunken beam:
`degrade_levels` multiply `L`/`beam_width`/`dw_max` by queue-pressure
level, trading recall for service rate).

Both loops share the dynamic batch scheduler: drain the queue at `max_batch`
or `max_wait_us`, whichever binds first. With an SLO configured
(`slo_p99_us`) the batcher is deadline-aware: it dispatches early when the
oldest enqueued query's latency budget, less the estimated service time,
would otherwise be at risk.

I/O state is per-server and SHARED ACROSS BATCHES: the store stack is built
once (`build_store`), so a stateful cache policy (`cache_policy` = "lru" |
"fifo" | "2q", byte-budgeted by `cache_bytes`) keeps its pages warm from one
batch to the next, and `prefetch` adds LAANN-style look-ahead whose device
service overlaps compute (the device model's `prefetch_overlap` rebate).
With the default policy the batch accounting is the order-free cross-query
union (BatchedPageStore), exactly the pre-refactor behaviour.

Distributed serving: `ServerConfig.shards > 1` splits the page space across
S simulated devices (repro_torch/io/sharded_store.py: ShardedPageStore behind
`ServerConfig.placement` = "round-robin" | "contiguous" | "replicated" —
the last needs a `page_profile` on the AnnServer constructor). Each batch's
charged pages are split by shard, the device time is the max over per-shard
completion times at per-shard queue depths
(`SSDModel.concurrent_latency_us(shard_pages=, shard_depths=)`), and the
reports carry `per_shard` rows (load share, mean queue depth, utilization,
hit rate) plus the flattened `shards`/`shard_imbalance`/`max_shard_util`
row columns. With a dynamic cache policy configured the same `cache_bytes`
budget is split into per-shard caches; shards compose with `tenants` (each
shard's slice is tenant-partitioned) and with `prefetch` (look-ahead issued
against the owning shard's queue), so one ServerConfig can describe a full
production store. Replica groups — N complete copies of the shard set with
load-aware routing, hot-page migration and autoscaling — live one layer up
in the reference (src/repro/serving/fleet.py), which the port does not
have yet.

Multi-tenancy: `ServerConfig.tenants > 1` splits the SAME `cache_bytes`
budget into per-tenant partitions (repro_torch/io/page_cache.py:
PartitionedPageCache — static `tenant_shares` + optional utility
rebalance), and both loops accept a `tenants=` array mapping each query-
pool vector to its tenant. Per-query tenant ids travel on
`QueryStats.tenants` (stamped here — the kernel is tenant-blind), route
trace replay to the right partition, and come back as the `per_tenant`
report column (admission counts, latency, per-tenant hit rates).

Search execution is REAL (the search runs every query; hops, pages,
distance evals and result ids are measured; stateful policies replay the
kernel's temporally ordered `page_trace` — format documented in
repro_torch/io/page_cache.py). Time is VIRTUAL: the container has no NVMe, so
the clock advances by the paper-measured device model —
`SSDModel.concurrent_latency_us(queue_depth, ...)`. Latency includes queue
wait + device service; QPS is completed queries over elapsed virtual time.

Batches are padded to `max_batch` with duplicates of the batch's first query
(the reference pads so its jitted kernel compiles once per (config,
max_batch); the port pads so that its launches do the reference's work);
padding rows are dropped from all accounting before any cache replay (a
padded duplicate must not warm the cache twice).
"""
from __future__ import annotations

import dataclasses
import heapq
import warnings
from typing import List, Optional, Tuple

import numpy as np

from repro_torch import sanitize
from repro_torch.core.device_model import SSDModel
from repro_torch.core.search_kernel import search_batched
from repro_torch.core.stats import QueryStats
from repro_torch.io import DYNAMIC_POLICIES, PLACEMENTS, build_store
from repro_torch.mutation import Compactor, MutableIndex, MutationMix
from repro_torch.obs import Histogram, Tracer
from repro_torch.serving.admission import AdmissionConfig, AdmissionController


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    max_batch: int = 16          # dynamic batcher: dispatch when this full...
    max_wait_us: float = 200.0   # ...or this long after the first enqueue
    pad_batches: bool = True     # pad to max_batch (the reference's work)
    # --- stateful I/O (repro_torch/io/page_cache.py) ---
    cache_policy: str = "none"   # "none" | "lru" | "fifo" | "2q"
    cache_bytes: int = 0         # shared page-cache budget (0 = policy off)
    prefetch: int = 0            # look-ahead hops (needs a cache policy)
    # --- SLO-aware batching ---
    slo_p99_us: Optional[float] = None   # dispatch early when the oldest
    #                                      query's p99 budget is at risk
    # --- overload control (repro_torch/serving/admission.py) ---
    admission: Optional[AdmissionConfig] = None   # None = admit everything
    # --- multi-tenant cache partitioning (repro_torch/io/page_cache.py) ---
    tenants: int = 1                     # >1 partitions cache_bytes
    tenant_shares: Optional[Tuple[float, ...]] = None  # default: equal
    cache_rebalance_every: int = 0       # utility rebalance period (0 = off)
    # --- distributed serving (repro_torch/io/sharded_store.py) ---
    shards: int = 1                      # >1 splits the page space across
    #                                      S simulated devices
    placement: str = "round-robin"       # "round-robin" | "contiguous" |
    #                                      "replicated" (needs page_profile=
    #                                      on the AnnServer constructor)
    placement_hot_frac: float = 0.25     # replicated: page-space fraction
    #                                      eligible for the replica hot set

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch={self.max_batch} must be >= 1 "
                f"(the batcher must be able to dispatch something)")
        if self.max_wait_us < 0:
            raise ValueError(
                f"max_wait_us={self.max_wait_us} must be >= 0 "
                f"(a negative wait deadline can never be reached)")
        if self.cache_policy != "none" and \
                self.cache_policy not in DYNAMIC_POLICIES:
            raise ValueError(
                f"cache_policy={self.cache_policy!r} must be 'none' or one "
                f"of {DYNAMIC_POLICIES} (the static vertex mask is driven "
                f"by SearchConfig.cache_frac, not the server)")
        if self.cache_policy != "none" and self.cache_bytes <= 0:
            raise ValueError(
                f"cache_policy={self.cache_policy!r} needs cache_bytes > 0")
        if self.cache_policy == "none" and self.cache_bytes > 0:
            raise ValueError(
                f"cache_bytes={self.cache_bytes} with cache_policy='none' "
                f"configures no cache — set cache_policy to one of "
                f"{DYNAMIC_POLICIES}, or drop cache_bytes")
        if self.prefetch < 0:
            raise ValueError(f"prefetch={self.prefetch} must be >= 0")
        if self.prefetch > 0 and self.cache_policy == "none":
            raise ValueError(
                "prefetch needs a cache_policy to hold looked-ahead pages")
        if self.slo_p99_us is not None and self.slo_p99_us <= 0:
            raise ValueError(
                f"slo_p99_us={self.slo_p99_us} must be positive")
        if self.admission is not None \
                and not isinstance(self.admission, AdmissionConfig):
            raise ValueError(
                f"admission={self.admission!r} must be an AdmissionConfig "
                f"(or None to admit everything)")
        if self.tenants < 1:
            raise ValueError(f"tenants={self.tenants} must be >= 1")
        if self.tenants > 1 and self.cache_policy not in DYNAMIC_POLICIES:
            raise ValueError(
                f"tenants={self.tenants} partitions the stateful page "
                f"cache — set cache_policy to one of {DYNAMIC_POLICIES}")
        if self.tenant_shares is not None and self.tenants == 1:
            raise ValueError(
                "tenant_shares needs tenants > 1 (one tenant owns the "
                "whole budget)")
        if self.cache_rebalance_every < 0:
            raise ValueError(
                f"cache_rebalance_every={self.cache_rebalance_every} "
                f"must be >= 0 (0 = static shares)")
        if self.cache_rebalance_every > 0 and self.tenants == 1:
            raise ValueError(
                f"cache_rebalance_every={self.cache_rebalance_every} with "
                f"tenants=1 has no partitions to rebalance — set tenants "
                f"> 1 or drop cache_rebalance_every")
        if self.shards < 1:
            raise ValueError(f"shards={self.shards} must be >= 1")
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"placement={self.placement!r} must be one of {PLACEMENTS}")
        if self.shards == 1 and self.placement != "round-robin":
            raise ValueError(
                f"placement={self.placement!r} with shards=1 places "
                f"nothing — a single device has no placement decision; "
                f"set shards > 1 or leave placement at its default")
        if not 0.0 < self.placement_hot_frac <= 1.0:
            raise ValueError(
                f"placement_hot_frac={self.placement_hot_frac} must be in "
                f"(0, 1] (the replica-eligible fraction of the page space)")


def _measured_step(stats: QueryStats) -> float:
    """Mean MEASURED fused-kernel wall clock per query (us), 0.0 unless the
    search config ran `pipeline="fused"` — reported next to the modeled
    device latency, never folded into it (the virtual clock stays the
    paper's analytic device model; this column is its measured check)."""
    if stats.measured_step_us is None or len(stats) == 0:
        return 0.0
    return float(np.mean(stats.measured_step_us))


def _latency_summary(lat_arr) -> Tuple[Histogram, float, float, float]:
    """(histogram, mean, p50, p99) for a latency sample — the ONE
    implementation behind every report percentile (repro_torch.obs.Histogram,
    quantiles within `Histogram.error_bound` ~0.1% of the exact order
    statistic). The empty case degrades to finite zeros with the same
    schema, where np.percentile would raise on a zero-length array —
    the zero-admitted open-loop path reports through here too."""
    h = Histogram.from_values(lat_arr, name="latency_us")
    mean = h.mean if h.count else 0.0
    return (h, mean, h.quantile(0.5, default=0.0),
            h.quantile(0.99, default=0.0))


def _tenant_columns(per_tenant: Optional[dict]) -> dict:
    """Flatten the per-tenant report rows into t<N>_* columns so `row()`
    carries the multi-tenant outcome into the benchmark tables (previously
    the dict was dropped on the way to print_table)."""
    if not per_tenant:
        return {}
    out = {}
    for t, r in sorted(per_tenant.items()):
        for key in ("completed", "shed", "p99_latency_us",
                    "cache_hit_rate"):
            if key in r:
                out[f"t{t}_{key}"] = r[key]
    return out


def _shard_columns(per_shard: Optional[dict]) -> dict:
    """Per-shard summary columns: how many devices, the max/mean issued-read
    imbalance (1.0 = perfectly balanced placement), and the peak device
    utilization — the one-line answer to \"did the placement spread the
    load\"."""
    if not per_shard:
        return {}
    issued = [r["issued"] for r in per_shard.values()]
    mean = sum(issued) / len(issued)
    util = [r["utilization"] for r in per_shard.values()]
    return {"shards": len(per_shard),
            "shard_imbalance": round(max(issued) / mean, 4) if mean else 1.0,
            "max_shard_util": round(max(util), 4)}


@dataclasses.dataclass
class ServingReport:
    workers: int
    queries: int
    elapsed_us: float
    qps: float
    mean_latency_us: float       # submit -> complete, queue wait included
    p99_latency_us: float
    mean_service_us: float       # dispatch -> complete (no queue wait)
    mean_batch_size: float
    pages_per_query: float           # per-query kernel accounting
    batched_pages_per_query: float   # after coalescing / cache replay
    dedup_saved_frac: float          # 1 - issued/requested
    stats: QueryStats            # per-query search stats, dispatch order
    query_indices: np.ndarray    # (queries,) index into the submitted pool
    cache_hit_rate: float = 0.0  # stateful-policy hits / requested
    overlap_frac: float = 0.0    # prefetched fraction of issued reads
    p50_latency_us: float = 0.0  # histogram median (repro_torch.obs.Histogram)
    measured_step_us: float = 0.0    # mean MEASURED fused-kernel wall clock
    #                                  per query (pipeline="fused" only) —
    #                                  sits next to mean_latency_us (modeled)
    per_tenant: Optional[dict] = None   # {tenant: {completed, latency,
    #                                     cache_hit_rate, ...}} when the
    #                                     workload is multi-tenant
    per_shard: Optional[dict] = None    # {shard: {issued, load_frac,
    #                                     mean_queue_depth, utilization,
    #                                     hit_rate}} when shards > 1

    def row(self) -> dict:
        row = {
            "workers": self.workers, "queries": self.queries,
            "qps": round(self.qps, 1),
            "mean_latency_us": round(self.mean_latency_us, 1),
            "p50_latency_us": round(self.p50_latency_us, 1),
            "p99_latency_us": round(self.p99_latency_us, 1),
            "mean_batch": round(self.mean_batch_size, 2),
            "pages_per_query": round(self.pages_per_query, 2),
            "batched_pages_per_query": round(self.batched_pages_per_query, 2),
            "dedup_saved_frac": round(self.dedup_saved_frac, 4),
            "cache_hit_rate": round(self.cache_hit_rate, 4),
            "overlap_frac": round(self.overlap_frac, 4),
        }
        if self.measured_step_us:
            row["measured_step_us"] = round(self.measured_step_us, 1)
        row.update(_tenant_columns(self.per_tenant))
        row.update(_shard_columns(self.per_shard))
        return row


@dataclasses.dataclass
class OpenLoopReport:
    rate_qps: float              # offered Poisson arrival rate
    duration_us: float           # arrival window (service may run past it)
    offered: int                 # arrivals in the window
    completed: int               # == admitted (admitted work always runs)
    elapsed_us: float            # last completion time
    qps: float                   # GOODPUT: completed / elapsed
    mean_latency_us: float       # over ADMITTED queries only
    p99_latency_us: float        # p99-of-admitted (shed work has no latency)
    mean_batch_size: float
    pages_per_query: float
    issued_pages_per_query: float
    cache_hit_rate: float
    overlap_frac: float
    slo_p99_us: Optional[float]
    slo_violation_frac: float    # fraction of ADMITTED queries past the SLO
    measured_step_us: float      # mean MEASURED fused-kernel wall clock per
    #                              query (pipeline="fused" only; 0.0 else)
    stats: QueryStats
    query_indices: np.ndarray    # pool index per COMPLETED query
    # --- admission outcome (ServerConfig.admission) ---
    offered_qps: float = 0.0     # arrivals / duration (vs `qps` = goodput)
    admitted: int = 0            # offered == admitted + shed
    shed: int = 0                # token-bucket + queue-policy drops
    degraded: int = 0            # queries served at a degraded level
    # --- latency attribution (repro_torch.obs; REPRO_SANITIZE-checked) ---
    p50_latency_us: float = 0.0  # histogram median (repro_torch.obs.Histogram)
    mean_queue_us: float = 0.0   # arrival -> earliest batcher dispatch
    mean_service_us: float = 0.0  # dispatch -> completion (device + compute)
    mean_interference_us: float = 0.0   # extra wait attributed to background
    #                              work holding the device (journal drain,
    #                              flush/compaction; fleet: bg clocks)
    attribution: Optional[dict] = None  # per-query float64 arrays, completion
    #                              order: {queue_us, service_us,
    #                              interference_us, latency_us} — each row
    #                              sums exactly (queue + service +
    #                              interference == latency)
    per_tenant: Optional[dict] = None   # {tenant: {offered, admitted, shed,
    #                                     completed, latency, hit rates}}
    per_shard: Optional[dict] = None    # {shard: {issued, load_frac,
    #                                     mean_queue_depth, utilization,
    #                                     hit_rate}} when shards > 1
    # --- streaming-mutation outcome (serve_open_loop(mutation_mix=)) ---
    inserts: int = 0             # insert arrivals applied (delta staging)
    deletes: int = 0             # delete arrivals applied (tombstones)
    flushes: int = 0             # delta -> append-zone flushes
    compactions: int = 0         # background compaction runs
    bg_pages_read: int = 0       # background device reads (flush RMW +
    #                              compaction page reads)
    bg_pages_written: int = 0    # background page rewrites
    bg_io_us: float = 0.0        # device time consumed by background I/O
    bg_util: float = 0.0         # bg_io_us / elapsed — the goodput tax
    overlap_ratio: float = 0.0   # live-vertex OR(G) after the run (0.0 on
    #                              non-mutating runs: frozen indexes report
    #                              it at build time instead)
    journal_writes: int = 0      # write-ahead journal pages committed (only
    #                              nonzero over a durable MutableIndex —
    #                              billed at the write unit on the same
    #                              background clock as flush/compaction)
    recovery_us: float = 0.0     # device time the preceding recover() cost
    #                              (journal replay reads + redo I/O) —
    #                              reported once by the first run after a
    #                              recovery, NOT folded into the window's
    #                              clock (recovery completes before serving)
    seed: Optional[int] = None   # the ONE rng seed that reproduces the run
    #                              (arrivals + mutation kinds + delete
    #                              victims); None when the caller supplied
    #                              its own generator

    def row(self) -> dict:
        row = {
            "rate_qps": round(self.rate_qps, 1),
            "offered": self.offered,
            "offered_qps": round(self.offered_qps, 1),
            "qps": round(self.qps, 1),
            "admitted": self.admitted,
            "shed": self.shed,
            "degraded": self.degraded,
            "mean_latency_us": round(self.mean_latency_us, 1),
            "p50_latency_us": round(self.p50_latency_us, 1),
            "p99_latency_us": round(self.p99_latency_us, 1),
            "mean_queue_us": round(self.mean_queue_us, 1),
            "mean_service_us": round(self.mean_service_us, 1),
            "mean_interference_us": round(self.mean_interference_us, 1),
            "mean_batch": round(self.mean_batch_size, 2),
            "pages_per_query": round(self.pages_per_query, 2),
            "issued_pages_per_query": round(self.issued_pages_per_query, 2),
            "cache_hit_rate": round(self.cache_hit_rate, 4),
            "overlap_frac": round(self.overlap_frac, 4),
            "slo_violation_frac": round(self.slo_violation_frac, 4),
        }
        if self.seed is not None:
            row["seed"] = self.seed
        if self.measured_step_us:
            row["measured_step_us"] = round(self.measured_step_us, 1)
        if self.inserts or self.deletes or self.flushes or self.compactions:
            row.update({
                "inserts": self.inserts, "deletes": self.deletes,
                "flushes": self.flushes, "compactions": self.compactions,
                "bg_pages_read": self.bg_pages_read,
                "bg_pages_written": self.bg_pages_written,
                "bg_util": round(self.bg_util, 4),
                "overlap_ratio": round(self.overlap_ratio, 4),
            })
        if self.journal_writes:
            row["journal_writes"] = self.journal_writes
        if self.recovery_us:
            row["recovery_us"] = round(self.recovery_us, 1)
        row.update(_tenant_columns(self.per_tenant))
        row.update(_shard_columns(self.per_shard))
        return row


class _ShardWindow:
    """Per-run per-shard aggregation: each dispatched batch adds its
    shard-split accounting (`shard_issued`/`shard_depths` from the sharded
    store), and `report(elapsed_us)` turns the window into the per-shard
    rows the serving reports expose — issued-read load share, mean device
    queue depth, and busy-time utilization (shard service time over the
    run's elapsed virtual time)."""

    def __init__(self, store, shards: int, model: SSDModel,
                 page_bytes: int):
        # explicit (store, shards, model, page_bytes) rather than a server
        # handle: a fleet replica owns one window per replica STORE, while
        # the single-server loops pass their own store — same aggregation
        # either way
        self.store = store
        self.model = model
        self.page_bytes = page_bytes
        self.on = shards > 1
        if self.on:
            self.req = np.zeros(shards, np.int64)
            self.hits = np.zeros(shards, np.int64)
            self.issued = np.zeros(shards, np.int64)
            self.depth_sum = np.zeros(shards, np.float64)
            self.busy_us = np.zeros(shards, np.float64)
            self.batches = 0

    def add(self, acct: dict) -> None:
        if not self.on:
            return
        self.req += acct["shard_requested"]
        self.hits += acct["shard_hits"]
        self.issued += acct["shard_issued"]
        self.depth_sum += np.asarray(acct["shard_depths"], np.float64)
        # busy time in raw service units: issued x read_service_us is the
        # device-capacity fraction consumed, independent of queueing
        self.busy_us += acct["shard_issued"] * self.model.\
            read_service_us(self.page_bytes)
        self.batches += 1

    def add_background(self, page_ids, service_us_each: float) -> None:
        """Background update I/O (flush/compaction) lands on the owning
        shards' busy time: each page is billed to its placement HOME at
        `service_us_each` (read or write unit), so a compaction run is
        visible in the very same per-shard utilization column query I/O
        fills."""
        if not self.on or len(page_ids) == 0:
            return
        homes = self.store.placement.page_to_shard[
            np.asarray(page_ids, np.int64)]
        counts = np.bincount(homes, minlength=len(self.busy_us))
        self.busy_us += counts * service_us_each

    def add_broadcast_writes(self, page_ids, service_us_each: float) -> None:
        """Hot-page migration copy I/O: a promoted page is WRITTEN to every
        shard except its home (the home already holds it), each copy billed
        at the write unit — the migration tax lands on the same per-shard
        utilization column query and compaction I/O fill."""
        if not self.on or len(page_ids) == 0:
            return
        homes = self.store.placement.page_to_shard[
            np.asarray(page_ids, np.int64)]
        counts = np.full(len(self.busy_us), len(page_ids), np.int64)
        counts -= np.bincount(homes, minlength=len(self.busy_us))
        self.busy_us += counts * service_us_each

    def report(self, elapsed_us: float) -> Optional[dict]:
        if not self.on or self.batches == 0:
            return None
        total = int(self.issued.sum())
        return {s: {
            "requested": int(self.req[s]),
            "issued": int(self.issued[s]),
            "hit_rate": (round(self.hits[s] / self.req[s], 4)
                         if self.req[s] else 0.0),
            "load_frac": (round(self.issued[s] / total, 4)
                          if total else 0.0),
            "mean_queue_depth": round(self.depth_sum[s] / self.batches, 2),
            "utilization": (round(float(self.busy_us[s]) / elapsed_us, 4)
                            if elapsed_us > 0 else 0.0),
        } for s in range(len(self.issued))}


class AnnServer:
    """Concurrent query server over a DiskIndex (closed- or open-loop)."""

    def __init__(self, index, cfg=None, model: Optional[SSDModel] = None,
                 server_cfg: Optional[ServerConfig] = None,
                 page_profile: Optional[np.ndarray] = None):
        self.index = index
        self.cfg = cfg or index.cfg
        self.model = model or SSDModel()
        self.server_cfg = server_cfg or ServerConfig()
        scfg = self.server_cfg
        # a fresh store stack with batch coalescing (and, per config, a
        # stateful shared cache + prefetcher, or a sharded store) on top —
        # the server's I/O counters and cache state must not leak into the
        # facade's stores. `page_profile` (per-page access counts, see
        # repro_torch.io.profile_from_trace) feeds the "replicated" placement's
        # hot-set ranking.
        use_cache = self.cfg.cache_frac > 0 and index.cached.any()
        self._stateful = scfg.cache_policy in DYNAMIC_POLICIES
        self._sharded = scfg.shards > 1
        self._mutable = isinstance(index, MutableIndex)
        placement = scfg.placement
        if self._sharded and placement == "replicated" \
                and page_profile is None:
            # the hot-set ranking needs a page profile; a server without
            # one can still run — fall back LOUDLY instead of crashing in
            # the store build (`make_placement` stays strict for callers
            # who configured replicated deliberately with data in hand)
            warnings.warn(
                "placement='replicated' without a page_profile: no hot set "
                "can be ranked — falling back to 'round-robin'. Pass "
                "AnnServer(page_profile=profile_from_trace(...)) to seed "
                "from an offline trace, or serve a warm-up window and call "
                "reseed_placement() to rank the hot set from the store's "
                "live read counters (profile_from_counters).", stacklevel=2)
            placement = "round-robin"
        self.store = build_store(
            index.layout,
            cached_vertices=index.cached if use_cache else None,
            batched=True,
            cache_policy=scfg.cache_policy if self._stateful else "none",
            cache_bytes=scfg.cache_bytes,
            prefetch=scfg.prefetch,
            tenants=scfg.tenants if self._stateful else 1,
            tenant_shares=scfg.tenant_shares,
            rebalance_every=scfg.cache_rebalance_every,
            shards=scfg.shards,
            placement=placement if self._sharded else "round-robin",
            page_profile=page_profile,
            placement_hot_frac=scfg.placement_hot_frac,
            mutable=self._mutable, device=index.device)
        if self._mutable:
            # flushes/compactions must invalidate THIS server's caches and
            # charge its books, not just the facade's
            index.attach_store(self.store)
        self._degraded_cfgs = {}    # degrade level -> SearchConfig

    # -- batch executor ------------------------------------------------------

    def _execute(self, qvecs: np.ndarray, cfg=None,
                 collect: bool = False) -> QueryStats:
        """Run one batch through the search on the index's device, padded to
        max_batch — `cfg` overrides the server's config for degraded
        dispatches. Stateful cache policies additionally collect the
        temporally ordered page trace their replay consumes; `collect=True`
        forces that trace on any store so a Tracer can emit per-hop device
        spans.

        Over a MutableIndex with pending mutations the disk side runs the
        tombstone-overfetch config and the delta's exact results are merged
        into the result heap (MutableIndex.merge_mutations) — with zero
        mutations both are identity and the frozen path is bit-identical."""
        cfg = cfg or self.cfg
        orig = qvecs
        b = len(qvecs)
        mb = self.server_cfg.max_batch
        if self.server_cfg.pad_batches and b < mb:
            qvecs = np.concatenate(
                [qvecs, np.repeat(qvecs[:1], mb - b, axis=0)])
        kcfg = (self.index.disk_cfg(cfg)
                if self._mutable and self.index.mutated else cfg)
        stats = search_batched(
            self.store, self.index.pq, kcfg, qvecs,
            medoid=self.index.medoid, memgraph=self.index.memgraph,
            batch=len(qvecs), collect_trace=self._stateful or collect,
            account_kernel_io=False)
        stats = stats.take(b)
        if self._mutable and self.index.mutated:
            stats = self.index.merge_mutations(stats, orig, cfg)
        return stats

    def _level_cfg(self, level: int):
        """SearchConfig for a degrade level: the configured beam knobs
        (`L`, `beam_width`, `dw_max`) scaled by the level's multiplier,
        floored at the smallest legal values (`k`, 1, `dw_min`). Level 0 is
        the undegraded config; levels are memoized."""
        if level == 0:
            return self.cfg
        if level not in self._degraded_cfgs:
            mult = self.server_cfg.admission.degrade_levels[level]
            cfg = self.cfg
            self._degraded_cfgs[level] = cfg.replace(
                L=max(cfg.k, int(round(cfg.L * mult))),
                beam_width=max(1, int(round(cfg.beam_width * mult))),
                dw_max=max(cfg.dw_min, int(round(cfg.dw_max * mult))))
        return self._degraded_cfgs[level]

    def reseed_placement(self, hot_frac: Optional[float] = None) -> dict:
        """Re-rank the replicated hot set from the store's LIVE per-page
        read counters (repro_torch.io.profile_from_counters) — the online
        escape from the replicated-placement cold start: construct the server with
        no page_profile (it warns and serves round-robin), run a warm-up
        window, then call this to promote the top `hot_frac` (default:
        ServerConfig.placement_hot_frac) pages the devices actually read.
        Only pages with at least one observed read are promoted (an unseen
        page has no evidence it is hot). Returns the swap delta
        ({"promoted", "demoted"} page-id arrays, plus "hot_pages"). The
        fleet's migration rebalancer applies the same ranking continuously
        on windowed deltas (repro_torch/serving/fleet.py)."""
        if not self._sharded:
            raise ValueError(
                "reseed_placement needs a sharded server (shards > 1) — a "
                "single device has no placement to re-rank")
        from repro_torch.io import profile_from_counters
        profile = profile_from_counters(self.store)
        frac = (hot_frac if hot_frac is not None
                else self.server_cfg.placement_hot_frac)
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"hot_frac={frac} must be in (0, 1]")
        k = max(1, int(round(frac * len(profile))))
        hot = np.argsort(profile, kind="stable")[::-1][:k]
        mask = np.zeros(len(profile), bool)
        mask[hot[profile[hot] > 0]] = True
        delta = self.store.set_replicated(mask)
        delta["hot_pages"] = int(mask.sum())
        return delta

    def _tenant_map(self, queries: np.ndarray,
                    tenants: Optional[np.ndarray]) -> np.ndarray:
        """Validate and normalize the query-pool -> tenant mapping. Ids must
        stay below ServerConfig.tenants whenever the cache is partitioned
        (each id names a partition); with an unpartitioned cache any ids are
        accepted and drive accounting only."""
        if tenants is None:
            return np.zeros(len(queries), np.int64)
        t = np.asarray(tenants, np.int64).reshape(-1)
        if len(t) != len(queries):
            raise ValueError(
                f"tenants has {len(t)} entries for {len(queries)} queries")
        if len(t) and t.min() < 0:
            raise ValueError("tenant ids must be >= 0")
        scfg = self.server_cfg
        if scfg.tenants > 1 and len(t) and t.max() >= scfg.tenants:
            raise ValueError(
                f"tenant id {t.max()} out of range for "
                f"tenants={scfg.tenants} cache partitions")
        return t

    def _cache_tenant_rows(self) -> dict:
        """Per-tenant cache-side accounting: replay hit rates from the
        store (any stateful cache) plus current partition capacities when
        the cache is partitioned."""
        if not self._stateful:
            return {}
        rows = {t: {"cache_hit_rate": round(r, 4)}
                for t, r in self.store.tenant_hit_rates().items()}
        cache = getattr(self.store, "cache", None)
        if getattr(cache, "tenant_aware", False):
            for t, cap in enumerate(cache.capacities()):
                rows.setdefault(t, {})["cache_pages"] = cap
        else:
            # sharded stores keep per-shard caches; when those are tenant-
            # partitioned, report each tenant's capacity summed over shards
            caps = getattr(self.store, "tenant_capacities", lambda: None)()
            if caps is not None:
                for t, cap in enumerate(caps):
                    rows.setdefault(t, {})["cache_pages"] = cap
        return rows

    def _per_tenant_report(self, tenant_ids, lat_arr,
                           ac: Optional[AdmissionController] = None) -> dict:
        """Merge completion-side latency stats, admission counts and cache
        accounting into one {tenant: row} dict."""
        ids = np.asarray(tenant_ids, np.int64)
        out = {}
        for t in np.unique(ids):
            m = ids == t
            _, t_mean, _, t_p99 = _latency_summary(lat_arr[m])
            out[int(t)] = {
                "completed": int(m.sum()),
                "mean_latency_us": round(t_mean, 1),
                "p99_latency_us": round(t_p99, 1)}
        if ac is not None:
            for t, row in ac.per_tenant_rows().items():
                out.setdefault(t, {"completed": 0}).update(row)
        for t, row in self._cache_tenant_rows().items():
            out.setdefault(t, {"completed": 0}).update(row)
        return out

    def _shard_window(self, store=None) -> _ShardWindow:
        """A fresh per-run shard aggregation window over `store` (default:
        the server's own store) — fleet replicas pass their own."""
        return _ShardWindow(store or self.store, self.server_cfg.shards,
                            self.model, self.cfg.page_bytes)

    def _batch_times_us(self, stats: QueryStats, depth: int, d: int,
                        store=None, lift: Optional[Tuple[int, int]] = None):
        """Per-query service latencies for one batch at the given device
        queue depth, plus the batch's I/O accounting dict. With a stateful
        policy the accounting is a trace replay against the shared cache
        (misses charged, hits free, prefetches overlapped); otherwise it is
        the order-free cross-query union of BatchedPageStore. A sharded
        store additionally splits each query's charged pages by shard
        (trace replay against the per-shard caches, or the per-shard
        union), and the device time becomes the max over per-shard
        completion times at per-shard queue depths.

        `store` overrides the server's own store (a fleet replica replays
        against ITS copy); `lift=(r, R)` lifts the shard split onto the
        fleet's (B, R, S) replica grid — this batch's pages on replica r's
        row, zero elsewhere — so the device time is priced by the model's
        max-over-replicas-then-shards path."""
        store = store if store is not None else self.store
        if self._stateful:
            acct = store.replay_batch(stats.page_trace,
                                      tenants=stats.tenants)
            pages = acct["per_query_issued"]
            dedup, overlap = 1.0, acct["overlap_frac"]
        else:
            acct = store.coalesce(stats.visited_pages)
            acct.setdefault("hits", 0)
            acct["overlap_frac"] = overlap = 0.0
            requested, issued = acct["requested"], acct["issued"]
            dedup = issued / requested if requested else 1.0
            # the batch store holds a page for the whole batch, so each query
            # is charged its DISTINCT pages (step revisits are buffer hits),
            # scaled by the coalescing rebate: charges sum to the union
            pages = stats.visited_pages.sum(axis=1).astype(np.float64)
        sp = acct.get("per_query_shard_pages")
        sd = acct.get("shard_depths")
        if lift is not None:
            r, R = lift
            if sp is None:
                # unsharded replica: its whole device is one (r, s) cell
                sp = np.asarray(pages, np.float64)[:, None]
                sd = np.asarray([depth], np.float64)
            S = sp.shape[1]
            grid = np.zeros((len(sp), R, S), np.float64)
            grid[:, r, :] = sp
            depths = np.zeros((R, S), np.float64)
            depths[r] = np.asarray(sd, np.float64)
            sp, sd = grid, depths
        lat = self.model.concurrent_latency_us(
            depth,
            hops=stats.hops.astype(np.float64),
            pages=pages,
            full_evals=stats.full_evals.astype(np.float64),
            pq_evals=stats.pq_evals.astype(np.float64),
            mem_evals=stats.mem_evals.astype(np.float64),
            d=d, pq_m=self.cfg.pq_m, page_bytes=self.cfg.page_bytes,
            pipeline=self.cfg.pipeline, page_dedup=dedup,
            prefetch_overlap=overlap,
            shard_pages=sp, shard_depths=sd)
        return np.asarray(lat, np.float64), acct

    def _trace_batch(self, tracer: Tracer, pid: int, dispatch: float,
                     lat: np.ndarray, acct: dict, stats: QueryStats,
                     b_times: np.ndarray, b_items, queue_b: np.ndarray,
                     inter_b: np.ndarray, level: int, rd_us: float,
                     d: int, store=None) -> None:
        """Emit one dispatched batch's spans: the batch slice and the
        model-priced kernel-compute rollup on the executor track, per-shard
        device busy time (issued reads x read unit — summing these per
        shard reproduces `_ShardWindow.busy_us` exactly on a non-mutating
        run), the per-query latency phases (queue / interference / service,
        whose durations sum to the query's reported latency), and — when
        the kernel collected a page trace — per-hop markers carrying each
        hop's page count and per-shard split."""
        store = store if store is not None else self.store
        tracer.span("batch", "batch", dispatch, float(lat.max()), pid=pid,
                    track="executor",
                    args={"size": len(b_items), "level": level})
        comp = self.model._compute_us(
            stats.full_evals.astype(np.float64),
            stats.pq_evals.astype(np.float64),
            stats.mem_evals.astype(np.float64), d, self.cfg.pq_m)
        tracer.span("kernel", "kernel", dispatch, float(np.sum(comp)),
                    pid=pid, track="executor",
                    args={"full_evals": float(np.sum(stats.full_evals)),
                          "pq_evals": float(np.sum(stats.pq_evals))})
        shard_issued = acct.get("shard_issued")
        if shard_issued is not None:
            for s, cnt in enumerate(np.asarray(shard_issued).tolist()):
                if cnt:
                    tracer.span("device", "device", dispatch, cnt * rd_us,
                                pid=pid, track=f"shard{s}",
                                args={"issued": int(cnt)})
        elif acct["issued"]:
            tracer.span("device", "device", dispatch,
                        acct["issued"] * rd_us, pid=pid, track="shard0",
                        args={"issued": int(acct["issued"])})
        page_to_shard = (store.placement.page_to_shard
                         if shard_issued is not None
                         and getattr(store, "placement", None) is not None
                         else None)
        for bi, item in enumerate(b_items):
            t_arr_us = float(b_times[bi])
            q_us, i_us, s_us = (float(queue_b[bi]), float(inter_b[bi]),
                                float(lat[bi]))
            tracer.span("queue", "queue", t_arr_us, q_us, pid=pid,
                        track="query", qid=item)
            if i_us > 0.0:
                tracer.span("interference", "interference",
                            t_arr_us + q_us, i_us, pid=pid, track="query",
                            qid=item)
            tracer.span("service", "service", dispatch, s_us, pid=pid,
                        track="query", qid=item,
                        args={"latency_us": q_us + i_us + s_us,
                              "queue_us": q_us, "interference_us": i_us,
                              "service_us": s_us})
            if stats.page_trace is None:
                continue
            t_hop_us = dispatch
            for h, hop_pages in enumerate(stats.page_trace[bi]):
                pages = hop_pages[hop_pages >= 0]
                if len(pages) == 0:
                    continue
                hop_args = {"hop": h, "pages": int(len(pages))}
                if page_to_shard is not None:
                    homes = np.bincount(page_to_shard[pages])
                    for s in np.flatnonzero(homes):
                        hop_args[f"s{s}_pages"] = int(homes[s])
                dur_us = len(pages) * rd_us
                tracer.span(f"hop{h}", "hop", t_hop_us, dur_us, pid=pid,
                            track="query", qid=item, args=hop_args)
                t_hop_us += dur_us

    # -- closed loop ---------------------------------------------------------

    def serve_closed_loop(self, queries: np.ndarray, workers: int,
                          rounds: int = 1,
                          tenants: Optional[np.ndarray] = None
                          ) -> ServingReport:
        """W clients, one outstanding query each, `rounds` queries per
        client, query vectors drawn round-robin from `queries`. `tenants`
        optionally maps each query-pool vector to a tenant id (see the
        module doc): closed loops need no admission control (they self-
        throttle), but the cache partition a query charges — and the
        per-tenant report — still follow the mapping."""
        if workers <= 0:
            raise ValueError(
                f"workers={workers} must be >= 1: a closed loop with no "
                f"client submits nothing")
        if rounds <= 0:
            raise ValueError(
                f"rounds={rounds} must be >= 1: each client must submit at "
                f"least one query")
        queries = np.asarray(queries, np.float32)
        d = queries.shape[1]
        scfg = self.server_cfg
        tenant_of = self._tenant_map(queries, tenants)
        multi_tenant = tenants is not None or scfg.tenants > 1
        total = workers * rounds
        # (submit_time, client, query_index); heap orders by time
        events: List[tuple] = [(0.0, c, c % len(queries))
                               for c in range(workers)]
        heapq.heapify(events)
        issued = [1] * workers      # queries issued per client so far
        exec_free = 0.0
        lat_out, qidx_out, stats_out = [], [], []
        service_out, batch_sizes, tenant_out = [], [], []
        requested_total = issued_total = hits_total = 0
        overlap_w = 0.0
        shard_win = self._shard_window()
        t_end = 0.0

        while events:
            t0, c0, q0 = heapq.heappop(events)
            batch = [(t0, c0, q0)]
            deadline = t0 + scfg.max_wait_us
            while events and len(batch) < scfg.max_batch \
                    and events[0][0] <= deadline:
                batch.append(heapq.heappop(events))
            # dispatch when full, at the wait deadline, or when the executor
            # frees up — whichever binds. Closed loop: if no submission is
            # outstanding, nothing can arrive before this batch completes,
            # so there is no point waiting out max_wait
            if len(batch) == scfg.max_batch or not events:
                t_fill = batch[-1][0]
            else:
                t_fill = deadline
            dispatch = max(exec_free, t_fill)
            while events and len(batch) < scfg.max_batch \
                    and events[0][0] <= dispatch:
                batch.append(heapq.heappop(events))

            qvecs = queries[[q for _, _, q in batch]]
            stats = self._execute(qvecs)
            stats.tenants = tenant_of[[q for _, _, q in batch]]
            # device queue depth = queries in flight in this batch
            lat, acct = self._batch_times_us(stats, len(batch), d)
            requested_total += acct["requested"]
            issued_total += acct["issued"]
            hits_total += acct["hits"]
            overlap_w += acct["overlap_frac"] * acct["issued"]
            shard_win.add(acct)
            done = dispatch + lat
            exec_free = dispatch + float(lat.max())
            t_end = max(t_end, exec_free)
            batch_sizes.append(len(batch))
            for (t_sub, c, q), t_done in zip(batch, done):
                lat_out.append(t_done - t_sub)
                service_out.append(t_done - dispatch)
                qidx_out.append(q)
                tenant_out.append(int(tenant_of[q]))
                if issued[c] < rounds:
                    nxt = (c + issued[c] * workers) % len(queries)
                    heapq.heappush(events, (float(t_done), c, nxt))
                    issued[c] += 1
            stats_out.append(stats)

        all_stats = QueryStats.concat(stats_out)
        lat_arr = np.asarray(lat_out)
        _, lat_mean, lat_p50, lat_p99 = _latency_summary(lat_arr)
        return ServingReport(
            workers=workers, queries=total, elapsed_us=t_end,
            qps=total / (t_end * 1e-6) if t_end > 0 else 0.0,
            mean_latency_us=lat_mean,
            p50_latency_us=lat_p50,
            p99_latency_us=lat_p99,
            mean_service_us=float(np.mean(service_out)),
            mean_batch_size=float(np.mean(batch_sizes)),
            pages_per_query=float(all_stats.page_reads.mean()),
            batched_pages_per_query=issued_total / total,
            dedup_saved_frac=(1.0 - issued_total / requested_total
                              if requested_total else 0.0),
            stats=all_stats,
            query_indices=np.asarray(qidx_out, np.int64),
            cache_hit_rate=(hits_total / requested_total
                            if requested_total else 0.0),
            overlap_frac=(overlap_w / issued_total if issued_total else 0.0),
            measured_step_us=_measured_step(all_stats),
            per_tenant=(self._per_tenant_report(tenant_out, lat_arr)
                        if multi_tenant else None),
            per_shard=shard_win.report(t_end))

    # -- open loop -----------------------------------------------------------

    def _empty_open_report(self, rate_qps: float, duration_us: float,
                           ac: AdmissionController,
                           per_tenant: Optional[dict],
                           extra: Optional[dict] = None,
                           seed: Optional[int] = None) -> OpenLoopReport:
        """Report for a run that completed nothing (no arrivals, or every
        arrival shed) — no search runs. `extra` carries the
        mutation-outcome fields of an all-mutation window. Latency
        columns route through the SAME histogram as the populated path
        (`_latency_summary` on a zero-length sample): finite zeros with
        identical formatting and schema, where the old path hardcoded an
        unrounded `p99_latency_us=0.0` next to the normal path's rounded
        value and np.percentile would have raised outright."""
        zi = np.zeros(0, np.int64)
        zf = np.zeros(0, np.float64)
        empty = QueryStats(
            ids=np.zeros((0, self.cfg.k), np.int64),
            dists=np.zeros((0, self.cfg.k), np.float64),
            hops=zi, page_reads=zf, cache_hits=zf, n_read_records=zf,
            n_eff=zf, full_evals=zf, pq_evals=zf, mem_hops=zi,
            mem_evals=zi)
        _, lat_mean, lat_p50, lat_p99 = _latency_summary(zf)
        return OpenLoopReport(
            rate_qps=rate_qps, duration_us=duration_us, offered=ac.offered,
            completed=0, elapsed_us=0.0, qps=0.0, mean_latency_us=lat_mean,
            p50_latency_us=lat_p50, p99_latency_us=lat_p99,
            mean_batch_size=0.0, pages_per_query=0.0,
            issued_pages_per_query=0.0, cache_hit_rate=0.0,
            overlap_frac=0.0, slo_p99_us=self.server_cfg.slo_p99_us,
            slo_violation_frac=0.0, measured_step_us=0.0, stats=empty,
            query_indices=np.zeros(0, np.int64),
            offered_qps=ac.offered / (duration_us * 1e-6),
            admitted=ac.admitted, shed=ac.shed, degraded=0,
            attribution={"queue_us": zf, "service_us": zf,
                         "interference_us": zf, "latency_us": zf},
            per_tenant=per_tenant, seed=seed, **(extra or {}))

    def serve_open_loop(self, queries: np.ndarray, rate_qps: float,
                        duration_us: float, seed: int = 0,
                        tenants: Optional[np.ndarray] = None,
                        arrivals: Optional[np.ndarray] = None,
                        mutation_mix: Optional[MutationMix] = None,
                        insert_pool: Optional[np.ndarray] = None,
                        rng: Optional[np.random.Generator] = None,
                        tracer: Optional[Tracer] = None,
                        trace_pid: int = 0) -> OpenLoopReport:
        """Poisson arrivals at `rate_qps` for `duration_us` of virtual time,
        query vectors drawn round-robin. Arrivals do not wait for
        completions (open loop), so past the device's saturation point the
        queue — and the latency — grows with the backlog; every ADMITTED
        arrival is served to completion, even past the window's end.

        With `ServerConfig.admission` set, each arrival first passes the
        `AdmissionController` (token bucket, then the bounded queue's
        reject / shed-oldest / degrade policy — see the module doc): shed
        arrivals never execute and carry no latency, so the report's
        percentiles are p99-of-admitted, and `qps` is goodput against
        `offered_qps`. Under "degrade", dispatches map queue pressure to a
        shrunken-beam SearchConfig (`_level_cfg`) instead of dropping.

        `tenants` optionally maps each query-pool vector to a tenant id
        (routes cache-partition charging and keys the `per_tenant` report).
        `arrivals` replaces the Poisson process with explicit sorted
        arrival times in us (deterministic admission tests: bursts at t=0,
        etc.); `rate_qps` then only scales the report's offered-load column.

        The batcher dispatches at `max_batch` / `max_wait_us` as in the
        closed loop; with `slo_p99_us` set it also dispatches as soon as the
        oldest enqueued query's remaining budget (SLO minus the estimated
        batch service time) runs out — trading batch-size efficiency for
        tail latency exactly when the SLO is at risk.

        ONE seeded rng drives the whole run: the Poisson arrivals, the
        mutation-mix arrival kinds AND the delete-victim draws all come
        from `np.random.default_rng(seed)` (`MutationMix.seed` is ignored),
        so a single seed reproduces a streaming run end to end and is
        stamped into `OpenLoopReport.row()`. Pass `rng=` to share a
        generator across calls (e.g. a multi-epoch trace replay); the
        stamped seed is then the caller's to report.

        `mutation_mix` (repro_torch/mutation/compactor.py: MutationMix) opens
        the STREAMING workload: each arrival is independently a read (served as
        above), an insert (staged in the MutableIndex's delta — requires an
        AnnServer over a MutableIndex and an `insert_pool` of vectors), or
        a delete (tombstones a random live vid). Inserts flush to the
        append zone when the delta crosses the index's `flush_threshold`,
        and the mix's compaction policy (none | threshold | continuous)
        schedules the background re-pack. ALL background I/O — flush
        read-modify-writes and compaction reads + rewrites — occupies the
        same device: it pushes the next dispatch out (`bg_free`), lands on
        the owning shards' busy time, and is reported per outcome
        (`inserts`/`deletes`/`flushes`/`compactions`/`bg_*` on the
        report), so compaction visibly competes with query I/O.

        Every reported latency is attributed exactly: per query,
        `queue_us` (arrival to the dispatch instant the batcher would
        have picked with an idle background device) + `interference_us`
        (the extra wait while journal/flush/compaction I/O holds the
        device) + `service_us` (dispatch to completion) sums to
        `latency_us` to the float — REPRO_SANITIZE re-checks the sum on
        every run, and `OpenLoopReport.attribution` carries the arrays.
        Pass `tracer=` (repro_torch.obs.Tracer) to additionally record the run
        as spans — arrivals, per-query phases, batches, per-shard device
        busy time, per-hop page reads, background interference — on
        replica-group `trace_pid` (fleet replicas trace side by side);
        `tracer=None` (the default) costs one falsy check per batch."""
        if rate_qps <= 0:
            raise ValueError(f"rate_qps={rate_qps} must be positive")
        if duration_us <= 0:
            raise ValueError(f"duration_us={duration_us} must be positive")
        mm = mutation_mix if (mutation_mix is not None
                              and mutation_mix.mutating) else None
        if mm is not None:
            if not self._mutable:
                raise ValueError(
                    "mutation_mix with insert/delete arrivals needs an "
                    "AnnServer over a MutableIndex "
                    "(repro_torch.mutation.MutableIndex) — a frozen DiskIndex "
                    "cannot absorb mutations")
            if mm.insert_frac > 0 and (insert_pool is None
                                       or len(insert_pool) == 0):
                raise ValueError(
                    "insert_frac > 0 needs a non-empty insert_pool of "
                    "vectors to draw inserts from")
        queries = np.asarray(queries, np.float32)
        d = queries.shape[1]
        scfg = self.server_cfg
        tenant_of = self._tenant_map(queries, tenants)
        multi_tenant = tenants is not None or scfg.tenants > 1

        # one generator for arrivals, arrival kinds and delete victims —
        # the single source of randomness the stamped seed reproduces
        gen = rng if rng is not None else np.random.default_rng(seed)
        run_seed = None if rng is not None else int(seed)
        if arrivals is None:
            mean_gap = 1e6 / rate_qps
            times: List[float] = []
            t = float(gen.exponential(mean_gap))
            while t < duration_us:
                times.append(t)
                t += float(gen.exponential(mean_gap))
            arr = np.asarray(times)
        else:
            arr = np.asarray(arrivals, np.float64).reshape(-1)
            if len(arr) and (np.any(arr < 0) or np.any(np.diff(arr) < 0)):
                raise ValueError(
                    "explicit arrivals must be non-negative and sorted")
        n = len(arr)
        ac = AdmissionController(scfg.admission)
        if n == 0:
            per_tenant = (self._per_tenant_report([], np.zeros(0), ac)
                          if multi_tenant else None)
            report = self._empty_open_report(rate_qps, duration_us, ac,
                                             per_tenant, seed=run_seed)
            sanitize.check_open_report(report)
            return report
        # arrival kinds: 0 = read, 1 = insert, 2 = delete. Reads index the
        # query pool round-robin BY READ ORDER, so a mutating mix serves
        # the same read sequence a pure-read run would
        if mm is not None:
            kinds = gen.choice(
                3, size=n, p=[mm.read_frac, mm.insert_frac, mm.delete_frac])
        else:
            kinds = np.zeros(n, np.int64)
        reads = kinds == 0
        n_reads = int(reads.sum())
        qidx = (np.where(reads, np.cumsum(reads) - 1, 0)) % len(queries)
        arr_tenant = tenant_of[qidx]

        # background-update device clock + per-outcome accounting: flush /
        # compaction I/O holds the device (dispatches wait on bg_free) and
        # is priced read/write asymmetrically
        mu = {"inserts": 0, "deletes": 0, "flushes": 0, "compactions": 0,
              "reads": 0, "writes": 0, "io_us": 0.0, "free": 0.0,
              "ins_i": 0, "journal": 0}
        rd_us = self.model.read_service_us(self.cfg.page_bytes)
        wr_us = self.model.write_service_us(self.cfg.page_bytes)
        compactor = Compactor(self.index, mm) if mm is not None else None
        # durable MutableIndex: journal commits occupy the same background
        # device clock as flush/compaction I/O, and a preceding recover()'s
        # cost is reported (once) without deferring this window's work —
        # recovery completed before the window opened
        jrn = (getattr(self.index, "journal", None)
               if self._mutable else None)
        rec_us = 0.0
        if self._mutable and getattr(self.index, "last_recovery_us", 0.0):
            rec_us = float(self.index.last_recovery_us)
            self.index.last_recovery_us = 0.0

        exec_free = 0.0
        est_service: Optional[float] = None
        lat_out, stats_out, batch_sizes = [], [], []
        que_out, svc_out, int_out = [], [], []
        qidx_out, tenant_out = [], []
        requested_total = issued_total = hits_total = 0
        overlap_w = 0.0
        shard_win = self._shard_window()
        degraded_n = 0
        t_end = 0.0

        def jrn_drain(t: float) -> None:
            """Bill journal pages committed since the last drain: one
            sequential write stream holding the device exactly like
            flush/compaction I/O (group commits amortize page rounding)."""
            if jrn is None:
                return
            pages = jrn.take_pending_io()
            if pages:
                us = pages * wr_us
                # REPRO_SANITIZE=1: priced durations are non-negative, so
                # the background clock below can only move forward
                sanitize.check(pages >= 0 and us >= 0.0,
                               f"journal drain billed negative time: "
                               f"{pages} pages, {us}us")
                bg_start = max(mu["free"], t)
                mu["free"] = bg_start + us
                mu["io_us"] += us
                mu["journal"] += pages
                if tracer:
                    tracer.span("journal_drain", "bg", bg_start, us,
                                pid=trace_pid, track="background",
                                args={"pages": pages})

        def bg_run(acct, t: float, kind: str) -> None:
            if not acct:
                return
            us = (acct["pages_read"] * rd_us
                  + acct["pages_written"] * wr_us)
            sanitize.check(us >= 0.0,
                           f"background {kind} billed negative time: {us}us "
                           f"(reads={acct['pages_read']}, "
                           f"writes={acct['pages_written']})")
            bg_start = max(mu["free"], t)
            mu["free"] = bg_start + us
            mu["io_us"] += us
            mu["reads"] += acct["pages_read"]
            mu["writes"] += acct["pages_written"]
            mu[kind] += 1
            shard_win.add_background(acct["read_pages"], rd_us)
            shard_win.add_background(acct["written_pages"], wr_us)
            if tracer:
                tracer.span(kind, "bg", bg_start, us, pid=trace_pid,
                            track="background",
                            args={"pages_read": acct["pages_read"],
                                  "pages_written": acct["pages_written"]})

        def ingest(j: int, executor_idle: bool = False) -> None:
            t = float(arr[j])
            if tracer:
                tracer.instant("arrival", "admission", t, pid=trace_pid,
                               track="admission", qid=j,
                               args={"kind": int(kinds[j])})
            if kinds[j] == 0:
                ac.offer(t, j, int(arr_tenant[j]),
                         executor_idle=executor_idle)
                return
            if kinds[j] == 1:
                self.index.insert(
                    insert_pool[mu["ins_i"] % len(insert_pool)])
                mu["ins_i"] += 1
                mu["inserts"] += 1
                bg_run(self.index.maybe_flush(), t, "flushes")
            else:
                vid = self.index.random_live_vid(gen)
                if vid is not None and self.index.delete(vid):
                    mu["deletes"] += 1
            bg_run(compactor.after_mutation(), t, "compactions")
            jrn_drain(t)

        i = 0
        mb = scfg.max_batch
        pend = ac.pending
        while i < n or pend:
            if not pend:
                # idle until the next arrival; its admission decision is
                # made at its own arrival instant
                ingest(i, executor_idle=exec_free <= float(arr[i]))
                i += 1
                continue
            t0 = pend[0][0]
            deadline = t0 + scfg.max_wait_us
            if scfg.slo_p99_us is not None:
                # the oldest query must still fit its p99 budget after the
                # (estimated) service time — dispatch before it cannot
                budget = scfg.slo_p99_us - (est_service or 0.0)
                deadline = min(deadline, t0 + max(budget, 0.0))
            # admissions while the batcher would still be waiting to fill
            while i < n and len(pend) < mb and arr[i] <= deadline:
                ingest(i)
                i += 1
            t_fill = pend[mb - 1][0] if len(pend) >= mb else np.inf
            # `base` is the dispatch instant an idle background device
            # would have allowed; waiting past it on mu["free"] is time
            # attributed to background interference (journal drain,
            # flush/compaction I/O) — the attribution split the per-query
            # queue_us/interference_us breakdown and the sanitizer's
            # conservation check both hang off
            base = max(exec_free, min(deadline, t_fill), t0)
            dispatch = max(base, mu["free"])
            # admissions up to the dispatch instant (under backlog this is
            # where the queue bound binds and shedding happens)
            while i < n and arr[i] <= dispatch:
                ingest(i)
                i += 1
            # mutations ingested above may have pushed the background
            # clock — the device must be free of flush/compaction work
            # before this batch can start
            dispatch = max(dispatch, mu["free"])
            level = ac.pressure_level()
            batch = ac.take_batch(mb)
            b_times = np.asarray([t for t, _, _ in batch])
            b_items = [it for _, it, _ in batch]
            b_tenants = np.asarray([tn for _, _, tn in batch], np.int64)
            stats = self._execute(queries[qidx[b_items]],
                                  self._level_cfg(level),
                                  collect=bool(tracer))
            stats.tenants = b_tenants
            lat, acct = self._batch_times_us(stats, len(batch), d)
            requested_total += acct["requested"]
            issued_total += acct["issued"]
            hits_total += acct["hits"]
            overlap_w += acct["overlap_frac"] * acct["issued"]
            shard_win.add(acct)
            if level > 0:
                degraded_n += len(batch)
            done = dispatch + lat
            exec_free = dispatch + float(lat.max())
            t_end = max(t_end, exec_free)
            lat_out.extend((done - b_times).tolist())
            # exact attribution: a query arriving after `base` (admitted
            # while the batch waited out the background clock) spent its
            # whole wait under interference, none of it queueing
            queue_b = np.maximum(base - b_times, 0.0)
            inter_b = (dispatch - b_times) - queue_b
            que_out.extend(queue_b.tolist())
            int_out.extend(inter_b.tolist())
            svc_out.extend(lat.tolist())
            if tracer:
                self._trace_batch(tracer, trace_pid, dispatch, lat, acct,
                                  stats, b_times, b_items, queue_b, inter_b,
                                  level, rd_us, d)
            qidx_out.extend(qidx[b_items].tolist())
            tenant_out.extend(b_tenants.tolist())
            batch_sizes.append(len(batch))
            stats_out.append(stats)
            mean_lat = float(lat.mean())
            est_service = (mean_lat if est_service is None
                           else 0.5 * est_service + 0.5 * mean_lat)
            if compactor is not None:
                # "continuous" policy: a bounded repair rides each batch
                bg_run(compactor.after_batch(), exec_free, "compactions")
                jrn_drain(exec_free)

        if mm is not None and jrn is not None:
            # persist the rng cursor: a crashed run's recover() +
            # recovered_rng() then resumes the exact arrival/victim stream
            self.index.journal_rng_state(gen.bit_generator.state)
            jrn_drain(exec_free)
        t_end = max(t_end, mu["free"])
        mut_kw = dict(journal_writes=mu["journal"], recovery_us=rec_us)
        if mm is not None:
            mut_kw.update(
                inserts=mu["inserts"], deletes=mu["deletes"],
                flushes=mu["flushes"], compactions=mu["compactions"],
                bg_pages_read=mu["reads"], bg_pages_written=mu["writes"],
                bg_io_us=mu["io_us"],
                bg_util=mu["io_us"] / t_end if t_end > 0 else 0.0,
                overlap_ratio=self.index.overlap_ratio())
        completed = len(lat_out)
        per_tenant = (self._per_tenant_report(tenant_out,
                                              np.asarray(lat_out), ac)
                      if multi_tenant else None)
        if completed == 0:
            report = self._empty_open_report(rate_qps, duration_us, ac,
                                             per_tenant, extra=mut_kw,
                                             seed=run_seed)
            sanitize.check_open_report(report)
            return report
        all_stats = QueryStats.concat(stats_out)
        lat_arr = np.asarray(lat_out)
        que_arr = np.asarray(que_out)
        svc_arr = np.asarray(svc_out)
        int_arr = np.asarray(int_out)
        # REPRO_SANITIZE=1: per-query queue + service + interference must
        # reproduce the reported latency exactly — no time invented, none
        # dropped (docs/observability.md: the conservation contract)
        sanitize.check_attribution(que_arr, svc_arr, int_arr, lat_arr)
        _, lat_mean, lat_p50, lat_p99 = _latency_summary(lat_arr)
        slo = scfg.slo_p99_us
        report = OpenLoopReport(
            rate_qps=rate_qps, duration_us=duration_us, offered=n_reads,
            completed=completed, elapsed_us=t_end,
            qps=completed / (t_end * 1e-6) if t_end > 0 else 0.0,
            mean_latency_us=lat_mean,
            p50_latency_us=lat_p50,
            p99_latency_us=lat_p99,
            mean_queue_us=float(que_arr.mean()),
            mean_service_us=float(svc_arr.mean()),
            mean_interference_us=float(int_arr.mean()),
            attribution={"queue_us": que_arr, "service_us": svc_arr,
                         "interference_us": int_arr, "latency_us": lat_arr},
            mean_batch_size=float(np.mean(batch_sizes)),
            pages_per_query=float(all_stats.page_reads.mean()),
            issued_pages_per_query=issued_total / completed,
            cache_hit_rate=(hits_total / requested_total
                            if requested_total else 0.0),
            overlap_frac=(overlap_w / issued_total if issued_total else 0.0),
            slo_p99_us=slo,
            slo_violation_frac=(float(np.mean(lat_arr > slo))
                                if slo is not None else 0.0),
            measured_step_us=_measured_step(all_stats),
            stats=all_stats,
            query_indices=np.asarray(qidx_out, np.int64),
            offered_qps=n_reads / (duration_us * 1e-6),
            admitted=ac.admitted, shed=ac.shed, degraded=degraded_n,
            per_tenant=per_tenant, per_shard=shard_win.report(t_end),
            seed=run_seed, **mut_kw)
        # REPRO_SANITIZE=1: offered == admitted + shed, completed == admitted
        sanitize.check_open_report(report)
        return report
