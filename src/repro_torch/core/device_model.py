"""Device model: converts measured per-query I/O + compute counts into
latency/QPS, using the paper's own fio-measured constants (§5.1) — this
container has no NVMe SSD, so wall-clock timing is derived, not faked.

SSD (paper Table/§5): 4 KB random read: 819K IOPS, 3200 MB/s;
16 KB: 318K IOPS, 4962 MB/s; 48 search workers; DIRECT_IO (no page cache).

Sequential execution (baseline): per-step latency = t_issue + pages/step
service + compute. Pipeline search overlaps the two: max(io, compute) per
step (§4.3.2, Fig. 9) — while its speculative reads add pages (Finding 5).

Concurrency (serving layer): `concurrent_latency_us(queue_depth, ...)`
generalizes the fixed-48-worker model to an arbitrary number of in-flight
queries. Per-page service time inflates linearly with queue depth
(closed-loop queueing knee: latency flat until the device's internal
parallelism is covered, then ∝ depth, so throughput saturates at the
IOPS/bandwidth ceiling). At queue_depth == workers it reproduces
`query_latency_us` exactly.

Sharding (distributed serving): with `shard_pages`/`shard_depths` the same
model runs per shard device — each shard serves its slice of a batch at its
own queue depth, and a query's page service is the max over its shards'
completion times (shards are parallel devices; the slowest one gates).

`HopperDevice` holds the H100's spec-sheet peaks, the yardstick for the
page kernels' bounds (kernels/csrc/). A copy of src/repro/core/device_model.py
with its TPU table replaced by that entry: the port imports nothing of
`repro`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class HopperDevice:
    """Peak constants of one NVIDIA Hopper card, from NVIDIA's H100 SXM data
    sheet: SPEC figures, not measured, and assuming the card's full 700 W
    power limit. They price the least time a kernel could take (its bound)
    from the bytes it moves and the operations it does; a measured time is
    always set beside them, never replaced by them."""
    name: str
    peak_flops_bf16: float     # FLOP/s, dense, tensor cores
    peak_flops_f32: float      # FLOP/s, outside the tensor cores
    hbm_bw: float              # bytes/s, device memory
    smem_per_block: int        # shared memory one block may use (bytes)

    def bound_s(self, nbytes: float, flops: float) -> tuple:
        """(seconds, "bytes" | "operations"): the larger of the memory time
        of `nbytes` and the time of `flops` f32 operations outside the
        tensor cores (the page kernels' arithmetic)."""
        t_mem, t_ops = nbytes / self.hbm_bw, flops / self.peak_flops_f32
        return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


H100_SXM = HopperDevice("H100 SXM", peak_flops_bf16=989e12,
                        peak_flops_f32=67e12, hbm_bw=3.35e12,
                        smem_per_block=232448)


@dataclasses.dataclass(frozen=True)
class SSDModel:
    workers: int = 48
    issue_us: float = 12.0          # submission + completion overhead per batch
    # NVMe internal parallelism: queue depths below this complete at the
    # same per-read latency (flat region before the queueing knee)
    device_parallelism: int = 8
    # page-size dependent service rates (measured in the paper)
    iops_4k: float = 819e3
    bw_4k: float = 3.2e9
    iops_16k: float = 318e3
    bw_16k: float = 4.962e9
    # compute (per-worker core): ns per float op in distance kernels
    ns_per_dim_full: float = 0.8    # SIMD L2 per dimension
    ns_per_sub_adc: float = 1.2     # ADC table lookup per subspace
    # writes (streaming updates: flush/compaction rewrites): the paper only
    # measures the read path, so the write service time is modeled as a
    # multiple of the read service — NVMe steady-state random-write
    # throughput runs well below read throughput once the FTL is folding
    write_penalty: float = 2.0

    def _rates(self, page_bytes: int) -> tuple:
        """(IOPS, bandwidth) at this page size; 8K interpolates between the
        paper's two measured points."""
        if page_bytes <= 4096:
            return self.iops_4k, self.bw_4k
        if page_bytes <= 8192:
            return ((self.iops_4k + self.iops_16k) / 2,
                    (self.bw_4k + self.bw_16k) / 2)
        return self.iops_16k, self.bw_16k

    def read_service_us(self, page_bytes: int) -> float:
        """Raw device service time of ONE read — 1/IOPS or the byte time,
        whichever binds — before any queueing or worker amortization. This
        is the utilization unit: issued reads x this, over elapsed time, is
        the fraction of the device's saturation capacity actually used."""
        iops, bw = self._rates(page_bytes)
        return max(1.0 / iops, page_bytes / bw) * 1e6

    def write_service_us(self, page_bytes: int) -> float:
        """Raw device service time of ONE page rewrite (streaming updates:
        append flushes and compaction re-packs) — the read unit scaled by
        `write_penalty`. Background update I/O priced in this unit shares
        the device with query reads, so compaction visibly taxes serving."""
        return self.read_service_us(page_bytes) * self.write_penalty

    def page_service_us(self, page_bytes: int) -> float:
        """Mean device service time per page at saturation, amortized
        across workers (queue-theoretic throughput view) — exactly the
        pre-refactor fixed-concurrency model, independent of the
        device_parallelism floor below."""
        return self.read_service_us(page_bytes) * self.workers

    def concurrent_page_service_us(self, page_bytes: int,
                                   queue_depth: float) -> float:
        """Per-page service time with `queue_depth` in-flight queries: flat
        below `device_parallelism` (the device absorbs that much concurrency
        at the knee latency, device_parallelism x the raw per-read time),
        then grows ∝ depth (each page waits behind depth-1 peers), so
        throughput saturates at the IOPS/bandwidth ceiling."""
        per_read = self.read_service_us(page_bytes)
        return per_read * max(queue_depth, float(self.device_parallelism))

    def _compute_us(self, full_evals, pq_evals, mem_evals, d, pq_m):
        return (full_evals * d * self.ns_per_dim_full
                + pq_evals * pq_m * self.ns_per_sub_adc
                + mem_evals * d * self.ns_per_dim_full) / 1e3

    def query_latency_us(self, *, hops, pages, full_evals, pq_evals,
                         mem_evals, d, pq_m, page_bytes, pipeline=False):
        """All args per-query numpy arrays (B,). Returns (B,) microseconds.
        Fixed-concurrency view: the device is saturated by `workers`."""
        return self.concurrent_latency_us(
            self.workers, hops=hops, pages=pages, full_evals=full_evals,
            pq_evals=pq_evals, mem_evals=mem_evals, d=d, pq_m=pq_m,
            page_bytes=page_bytes, pipeline=pipeline)

    def concurrent_latency_us(self, queue_depth, *, hops, pages, full_evals,
                              pq_evals, mem_evals, d, pq_m, page_bytes,
                              pipeline=False, page_dedup: float = 1.0,
                              prefetch_overlap: float = 0.0,
                              shard_pages=None, shard_depths=None):
        """Per-query latency with `queue_depth` queries in flight on the
        device. `page_dedup` (<= 1) rebates the page volume when a batch
        scheduler coalesced duplicate reads (BatchedPageStore).
        `prefetch_overlap` (in [0, 1]) is the fraction of page service a
        look-ahead prefetcher issued during the previous hop's compute
        (PrefetchingPageStore): that I/O is hidden behind compute, but only
        up to the compute actually available. Pipeline search already
        overlaps I/O and compute wholesale, so the rebate is subsumed there.

        Sharded stores (ShardedPageStore) pass `shard_pages` ((B, S): reads
        each query charged on each of S shard devices) and `shard_depths`
        ((S,): queries with work on that shard, its device queue depth).
        Shards serve in parallel, so a query's page-service time is the MAX
        over its shards' completion times — the batch finishes when its
        slowest device does, and an imbalanced placement is visibly slower
        than a balanced one at equal total pages. `pages` is ignored on
        this path (the split already carries the volume); hop issue
        overhead and the dedup/prefetch rebates apply unchanged.

        Fleet serving (replica groups, repro/serving/fleet.py) adds one
        axis: `shard_pages` (B, R, S) with `shard_depths` (R, S) prices
        R full replicas of the shard set. Every (replica, shard) pair is
        its own device, so the completion time is the max over REPLICAS
        THEN SHARDS — flattening the grid to R*S parallel devices computes
        exactly that, and an imbalanced fleet (one replica overloaded at
        equal total pages) stays visibly slower than a balanced one."""
        if shard_pages is not None:
            sp = np.asarray(shard_pages, np.float64)
            if sp.ndim == 3:
                # (B, R, S) replica grid -> R*S parallel devices; max over
                # the flattened axis IS max-over-replicas-then-shards
                B, R, S = sp.shape
                sp = sp.reshape(B, R * S)
                if shard_depths is not None:
                    sd = np.asarray(shard_depths, np.float64)
                    if sd.shape != (R, S):
                        raise ValueError(
                            f"shard_depths must be ({R}, {S}) for "
                            f"shard_pages {(B, R, S)}; got {sd.shape}")
                    shard_depths = sd.reshape(R * S)
            elif sp.ndim != 2:
                raise ValueError(
                    f"shard_pages must be (B, shards) or (B, replicas, "
                    f"shards); got {sp.shape}")
            if shard_depths is None:
                depths = np.full(sp.shape[1], float(queue_depth))
            else:
                depths = np.asarray(shard_depths, np.float64).reshape(-1)
                if len(depths) != sp.shape[1]:
                    raise ValueError(
                        f"shard_depths has {len(depths)} entries for "
                        f"{sp.shape[1]} shards")
            t_shard = np.asarray([
                self.concurrent_page_service_us(page_bytes, qd)
                for qd in depths])
            page_service = (sp * page_dedup * t_shard).max(axis=1)
        else:
            t_page = self.concurrent_page_service_us(page_bytes, queue_depth)
            page_service = pages * page_dedup * t_page
        io = page_service + hops * self.issue_us
        comp = self._compute_us(full_evals, pq_evals, mem_evals, d, pq_m)
        if pipeline:
            # per-step overlap approximated at query granularity
            return np.maximum(io, comp) + np.minimum(io, comp) * 0.1
        hidden = np.minimum(io * np.clip(prefetch_overlap, 0.0, 1.0), comp)
        return io + comp - hidden

    def qps(self, latency_us: np.ndarray, *, pages, page_bytes) -> float:
        """Throughput under `workers` concurrent queries, capped by device
        IOPS/bandwidth saturation."""
        mean_lat = float(np.mean(latency_us))
        qps_workers = self.workers / (mean_lat * 1e-6)
        iops, bw = self._rates(page_bytes)
        mean_pages = float(np.mean(pages))
        qps_iops = iops / max(mean_pages, 1e-9)
        qps_bw = bw / max(mean_pages * page_bytes, 1e-9)
        return min(qps_workers, qps_iops, qps_bw)

    def device_counters(self, qps: float, *, pages, page_bytes):
        """Modeled IOPS / bandwidth at the achieved QPS (paper Table 5/7)."""
        mean_pages = float(np.mean(pages))
        iops = qps * mean_pages
        bw = iops * page_bytes
        return {"iops": iops, "bw_mbps": bw / 1e6}


def summarize(model: SSDModel, result, *, d, pq_m, page_bytes, pipeline=False):
    """Compatibility alias — the summary lives on QueryStats (one code path
    for tests, benchmarks and the serving layer)."""
    return result.summary(model, d=d, pq_m=pq_m, page_bytes=page_bytes,
                          pipeline=pipeline)
