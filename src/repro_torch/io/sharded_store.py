"""I/O layer: the sharded PageStore — the page space partitioned across S
simulated NVMe devices.

Copied into the port from src/repro/io/sharded_store.py, structure and
names kept. The shards are modelled device queues on the host, beside one
card; `kernel_arrays()` passes the inner store's tensors through.

Past one device's saturation point the only way to keep pushing the
throughput frontier is more devices (the §8 concurrency guideline at the
multi-device scale disk-ANN systems are actually compared at), and the
page is the natural sharding unit of a page-aligned layout. This module
adds the distributed half of the store stack:

  Placement         — a page -> shard map plus a replicated-page mask; the
                      routing decision every sharded access goes through.
  make_placement    — the pluggable policies:
        round-robin   page p lives on shard p % S (balanced by id).
        contiguous    equal contiguous ranges (locality-preserving — and
                      deliberately the worst case when the workload's hot
                      pages share a range: they all land on one device).
        replicated    round-robin base placement, plus the top-k hottest
                      pages of a `page_trace` profile replicated on EVERY
                      shard; a replicated access routes to the least-loaded
                      shard of the batch, so a skewed workload's hot set
                      stops pinning one device.
  profile_from_trace — per-page access counts from a (B, hops, w) trace,
                      the profile `replicated` ranks by (offline seeding).
  profile_from_counters — the same profile from a LIVE store's per-page
                      issued-read counters (`ShardedPageStore.
                      page_read_counts`), so the hot set can be seeded or
                      re-ranked online, mid-serve, with no offline trace —
                      the cold-start path for "replicated" and the window
                      signal hot-page migration re-ranks on.
  ShardedPageStore  — decorator: each shard owns its own device queue
                      accounting, `StoreCounters`, and (optionally) its own
                      slice of ONE shared byte-budgeted page-cache budget —
                      tenant-partitioned per shard when the budget is
                      multi-tenant, with `lookahead > 0` issuing LAANN-style
                      prefetch against the owning shard's queue.

The fleet extensions
--------------------
Three compositions that used to be rejected now land here: (1) per-shard
caches may be `PartitionedPageCache` slices (shard x tenant: each shard's
budget slice is itself split per tenant, so isolation holds on every
device); (2) `lookahead > 0` replays the trace with look-ahead — a hop's
future pages are admitted into (and charged on) the shard that OWNS them
before the demand access arrives, and the issued volume is reported as
`prefetch_issued`/`overlap_frac` for the device model's overlap rebate;
(3) `set_replicated(mask)` swaps the replicated hot set IN PLACE, the
store-side half of online hot-page migration (the serving layer bills the
copy I/O and invalidates stale residency via MutablePageStore).

The device-time contract
------------------------
A batch's device time is the MAX over per-shard completion times: shards
serve in parallel, so a query completes when its slowest shard does.
`replay_batch`/`coalesce` therefore return, beyond the flat accounting
every store returns, `per_query_shard_pages` ((B, S): the pages each query
charged on each shard) and `shard_depths` ((S,): queries with work on that
shard) — exactly the arguments `SSDModel.concurrent_latency_us(shard_pages=,
shard_depths=)` turns into the max-over-shards I/O term. An imbalanced
placement is visibly slower than a balanced one at equal total pages, which
is the whole point of measuring placement policies.

Counter conservation: every issued read is charged to the owning shard's
`StoreCounters`, to the roll-up `counters`, and forwarded down the stack
via the accounting-only `charge` path, so `pages_requested == cache_hits +
pages_fetched` holds at this layer and the decorator's movement mirrors the
inner store's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.io.page_cache import (POLICIES, PageCache,
                                       PartitionedPageCache,
                                       floor_capacity_pages)
from repro_torch.io.page_store import (StoreCounters, book_charged_reads,
                                       book_writes, charge_inner_reads,
                                       fetch_mirroring_inner,
                                       note_inner_writes, resolve_write)

#: build_store() / ServerConfig placement policy names.
PLACEMENTS = ("round-robin", "contiguous", "replicated")


@dataclasses.dataclass(frozen=True)
class Placement:
    """A page -> shard assignment. `page_to_shard` fixes every page's home;
    pages with `replicated[p]` set are resident on EVERY shard and route
    per access to the least-loaded shard (`route`)."""

    name: str
    shards: int
    page_to_shard: np.ndarray   # (num_pages,) int64
    replicated: np.ndarray      # (num_pages,) bool

    def route(self, page: int, shard_loads: np.ndarray) -> int:
        """Shard serving this access; `shard_loads` is the batch's running
        per-shard issued-read count (the load-balance signal a replicated
        page's routing trades on)."""
        if self.replicated[page]:
            return int(np.argmin(shard_loads))
        return int(self.page_to_shard[page])

    def describe(self) -> dict:
        counts = np.bincount(self.page_to_shard, minlength=self.shards)
        return {"policy": self.name, "shards": self.shards,
                "pages_per_shard": counts.tolist(),
                "replicated_pages": int(self.replicated.sum())}

    def extend(self, num_pages: int) -> "Placement":
        """Placement for a GROWN page space (streaming updates append
        pages): existing homes are kept, appended pages are assigned
        round-robin starting from the currently lightest shard (whatever
        the base policy — the append zone has no profile to place by), and
        none are replicated. Returns a new Placement; the original is
        frozen."""
        old = len(self.page_to_shard)
        if num_pages < old:
            raise ValueError(
                f"cannot shrink a placement: {num_pages} < {old} pages")
        if num_pages == old:
            return self
        counts = np.bincount(self.page_to_shard, minlength=self.shards)
        start = int(np.argmin(counts))
        extra = (start + np.arange(num_pages - old)) % self.shards
        return dataclasses.replace(
            self,
            page_to_shard=np.concatenate([self.page_to_shard, extra]),
            replicated=np.concatenate(
                [self.replicated, np.zeros(num_pages - old, bool)]))


def profile_from_trace(page_trace: np.ndarray, num_pages: int) -> np.ndarray:
    """Per-page access counts from a (B, hops, w) `page_trace` (-1 padded)
    — the hotness profile the `replicated` placement ranks by."""
    trace = np.asarray(page_trace)
    flat = trace[trace >= 0].astype(np.int64)
    if len(flat) and int(flat.max()) >= num_pages:
        raise ValueError(
            f"trace names page {int(flat.max())} beyond num_pages={num_pages}")
    return np.bincount(flat, minlength=num_pages)


def profile_from_counters(store) -> np.ndarray:
    """Per-page access counts from a LIVE sharded store's own counters
    (`ShardedPageStore.page_read_counts`: every page-routed issued read,
    accumulated across the store's lifetime) — the ONLINE twin of
    `profile_from_trace`. This is how a "replicated" placement escapes its
    cold start: serve a warm-up window under any placement, rank the hot
    set from what the devices actually read, and re-place — no offline
    trace required. Hot-page migration re-ranks on successive deltas of
    this profile. Returns a copy; the live counters keep counting."""
    counts = getattr(store, "page_read_counts", None)
    if counts is None:
        raise ValueError(
            "profile_from_counters needs a store that tracks live per-page "
            "read counts (ShardedPageStore.page_read_counts) — build one "
            "with build_store(shards=...), or rank an offline trace with "
            "profile_from_trace instead")
    return np.asarray(counts, np.int64).copy()


def make_placement(policy: str, num_pages: int, shards: int, *,
                   profile: Optional[np.ndarray] = None,
                   hot_frac: float = 0.25,
                   hot_pages: Optional[int] = None) -> Placement:
    """Build a placement. `replicated` needs a per-page access `profile`
    (see `profile_from_trace`); the hot set is the top `hot_pages` pages by
    count (default: `hot_frac` of the page space), restricted to pages the
    profile actually saw.

    A missing profile is an ERROR here, deliberately: a caller composing a
    store by hand configured "replicated" on purpose and must supply the
    data it ranks by. The serving layer, where a `page_profile=None`
    default can legitimately flow in, instead falls back to round-robin
    with an explicit warning (AnnServer.__init__) — never silently."""
    if shards < 1:
        raise ValueError(f"shards={shards} must be >= 1")
    if num_pages < 1:
        raise ValueError(f"num_pages={num_pages} must be >= 1")
    if policy not in PLACEMENTS:
        raise ValueError(f"unknown placement {policy!r}; "
                         f"choose from {PLACEMENTS}")
    pages = np.arange(num_pages, dtype=np.int64)
    replicated = np.zeros(num_pages, bool)
    if policy == "contiguous":
        span = -(-num_pages // shards)           # ceil division
        p2s = np.minimum(pages // span, shards - 1)
    else:
        p2s = pages % shards
    if policy == "replicated":
        if profile is None:
            raise ValueError(
                "placement='replicated' needs a per-page access `profile` "
                "(profile_from_trace over a page_trace) to rank hotness")
        profile = np.asarray(profile, np.int64).reshape(-1)
        if len(profile) != num_pages:
            raise ValueError(
                f"profile has {len(profile)} entries for {num_pages} pages")
        k = hot_pages if hot_pages is not None else max(
            1, int(round(hot_frac * num_pages)))
        if k < 1:
            raise ValueError(f"hot_pages={k} must be >= 1")
        hot = np.argsort(profile, kind="stable")[::-1][:k]
        replicated[hot[profile[hot] > 0]] = True
    return Placement(policy, shards, p2s, replicated)


def make_shard_caches(policy: str, cache_bytes: int, page_bytes: int,
                      shards: int, *, tenants: int = 1,
                      tenant_shares=None,
                      rebalance_every: int = 0) -> List[PageCache]:
    """Split ONE byte budget into per-shard caches of `policy` (even split,
    1-page floor per shard) — the shard-local residency that keeps a hot
    shard's working set from competing with a cold shard's. With
    `tenants > 1` each shard's slice is itself a `PartitionedPageCache`
    (shard x tenant grid: the floor becomes one page per (shard, tenant)
    cell), so tenant isolation holds independently on every device and the
    utility rebalance runs per shard over that shard's own access stream."""
    if policy not in POLICIES:
        raise ValueError(f"unknown cache policy {policy!r}; "
                         f"choose from {sorted(POLICIES)}")
    if tenants < 1:
        raise ValueError(f"tenants={tenants} must be >= 1")
    capacity = floor_capacity_pages(cache_bytes, page_bytes,
                                    shards * tenants,
                                    "shard x tenant cells")
    base, extra = divmod(capacity, shards)
    caps = [base + (1 if s < extra else 0) for s in range(shards)]
    if tenants == 1:
        return [POLICIES[policy](c) for c in caps]
    return [PartitionedPageCache(c, tenants, policy, shares=tenant_shares,
                                 rebalance_every=rebalance_every)
            for c in caps]


class ShardedPageStore:
    """Decorator: the page space partitioned across S simulated devices.
    Every access routes through the placement; each shard keeps its own
    `StoreCounters` (and, when `caches` is given, its own page cache), the
    roll-up lives in `counters`, and every issued read is forwarded to the
    inner store's accounting via `charge`. `replay_batch` (temporal trace,
    per-shard cache replay) and `coalesce` (order-free cross-query union)
    are the serving accounting paths — both return the per-shard split the
    device model's max-over-shards I/O term consumes."""

    def __init__(self, inner, placement: Placement,
                 caches: Optional[Sequence[PageCache]] = None,
                 lookahead: int = 0):
        if caches is not None and len(caches) != placement.shards:
            raise ValueError(
                f"{len(caches)} caches for {placement.shards} shards — "
                f"each shard owns exactly one")
        if lookahead < 0:
            raise ValueError(f"lookahead={lookahead} must be >= 0")
        if lookahead > 0 and caches is None:
            raise ValueError(
                "lookahead needs per-shard caches to hold the looked-ahead "
                "pages (a cacheless prefetch would charge reads it cannot "
                "keep)")
        self.inner = inner
        self.placement = placement
        self.shards = placement.shards
        self.caches = list(caches) if caches is not None else None
        self.lookahead = int(lookahead)
        # True when each shard cache is a PartitionedPageCache slice —
        # replay then routes accesses to (shard, tenant) cells
        self.tenant_aware = bool(self.caches) and all(
            getattr(c, "tenant_aware", False) for c in self.caches)
        self.shard_counters = [StoreCounters()
                               for _ in range(placement.shards)]
        self.counters = StoreCounters()
        self.accesses = 0
        self.prefetch_issued = 0
        # live per-page issued-read counts (profile_from_counters): the
        # online hotness signal replicated placement seeds / migration
        # re-ranks on. Counted at the routing point — every page-routed
        # DEVICE read, demand or prefetch; cache hits don't load a device
        # so they don't count toward the placement signal
        self.page_read_counts = np.zeros(inner.num_pages, np.int64)
        self.tenant_counters: Dict[int, Dict[str, int]] = {}

    @property
    def device(self):
        return self.inner.device

    @property
    def layout(self):
        return self.inner.layout

    @property
    def num_pages(self) -> int:
        return self.inner.num_pages

    # -- PageStore protocol --------------------------------------------------

    def fetch(self, page_ids: np.ndarray,
              vids: Optional[np.ndarray] = None) -> dict:
        page_ids = np.asarray(page_ids, np.int64).reshape(-1)
        self.counters.pages_requested += len(page_ids)
        if vids is not None:
            # vertex-granular requests belong to the static-vertex layer
            # BELOW the shard abstraction — pass through, mirroring the
            # inner store's movement into the roll-up only (per-shard
            # counters cover page-routed traffic; see shard_rows)
            return fetch_mirroring_inner(self.counters, self.inner,
                                         page_ids, vids)
        loads = np.zeros(self.shards, np.int64)
        charged: List[int] = []
        n_p = self.layout.n_p
        for p in page_ids:
            p = int(p)
            s = self.placement.route(p, loads)
            sc = self.shard_counters[s]
            sc.pages_requested += 1
            self.accesses += 1
            # fetch() is tenant-blind (the protocol path carries no tenant);
            # partitioned shard caches default to partition 0
            hit = (self.caches[s].access(p)
                   if self.caches is not None else False)
            if hit:
                sc.cache_hits += 1
                self.counters.cache_hits += 1
            else:
                sc.pages_fetched += 1
                sc.records_fetched += n_p
                self.counters.pages_fetched += 1
                self.counters.records_fetched += n_p
                loads[s] += 1
                self.page_read_counts[p] += 1
                charged.append(p)
        charge_inner_reads(self.inner, charged)
        lay = self.layout
        return {"vids": lay.page_vids[page_ids],
                "vecs": lay.page_vecs[page_ids],
                "nbrs": lay.page_nbrs[page_ids]}

    def charge(self, page_ids: np.ndarray) -> None:
        """Accounting-only reads from a layer above: route to the owning
        shards (replicated pages balance on the charge's own load vector),
        book per shard + roll-up, forward down."""
        page_ids = np.asarray(page_ids, np.int64).reshape(-1)
        loads = np.zeros(self.shards, np.int64)
        n_p = self.layout.n_p
        for p in page_ids:
            s = self.placement.route(int(p), loads)
            sc = self.shard_counters[s]
            book_charged_reads(sc, 1, n_p)
            loads[s] += 1
            self.page_read_counts[int(p)] += 1
        book_charged_reads(self.counters, len(page_ids), n_p)
        self.inner.charge(page_ids)

    def note_write(self, page_ids=None, *, kind: str = "data",
                   count: Optional[int] = None) -> None:
        """Device page writes split by owning device: data writes land on
        each page's placement HOME (a rewrite must reach the authoritative
        copy; replica refresh is the migration layer's separate traffic),
        while count-only journal/snapshot writes are one sequential log
        stream and bill to shard 0 — the dedicated-log-device convention
        the serving layer's background clock shares. Booked per shard +
        roll-up, forwarded down the spine."""
        pages, n = resolve_write(page_ids, count)
        if pages is not None:
            homes = self.placement.page_to_shard[pages]
            for s, c in zip(*np.unique(homes, return_counts=True)):
                book_writes(self.shard_counters[int(s)], int(c), kind)
        elif n:
            book_writes(self.shard_counters[0], n, kind)
        book_writes(self.counters, n, kind)
        note_inner_writes(self.inner, pages, kind, n)

    def kernel_arrays(self) -> tuple:
        return self.inner.kernel_arrays()

    def vertex_cache_mask(self) -> np.ndarray:
        return self.inner.vertex_cache_mask()

    def note_kernel_io(self, stats) -> None:
        # replay_batch / coalesce are this store's accounting paths
        self.inner.note_kernel_io(stats)

    # -- serving accounting paths --------------------------------------------

    def replay_batch(self, page_trace: np.ndarray,
                     tenants: Optional[np.ndarray] = None) -> dict:
        """Temporally ordered replay (QueryStats.page_trace) against the
        per-shard caches (a cold store with no caches charges every access).
        Tenant-partitioned shard caches route each access to the query's
        tenant cell on the owning shard; with `lookahead > 0` a hop's next
        `lookahead` hops' pages are admitted into the OWNING shard's cache
        before the hop's demand accesses (admit(), not access(): prefetch
        is not demand, so it moves no demand hit rates), charged on that
        shard and counted in `prefetch_issued`/`overlap_frac` for the
        device model's overlap rebate. Returns the SharedCachePageStore
        accounting contract plus the per-shard split:

          shard_requested / shard_hits / shard_issued   (S,) int
          per_query_shard_pages   (B, S) float64 — reads each query charged
                                  on each shard (feeds the max-over-shards
                                  device time)
          shard_depths            (S,) int — queries with >= 1 read on the
                                  shard (its device queue depth this batch)
        """
        trace = np.asarray(page_trace)
        if trace.ndim != 3:
            raise ValueError(
                f"page_trace must be (B, hops, w); got shape {trace.shape}")
        B, S = trace.shape[0], self.shards
        ta = self.tenant_aware
        if tenants is None:
            tns = np.zeros(B, np.int64)
        else:
            tns = np.asarray(tenants, np.int64).reshape(-1)
            if len(tns) != B:
                raise ValueError(
                    f"tenants has {len(tns)} entries for a {B}-query trace")
            if np.any(tns < 0):
                raise ValueError("tenant ids must be >= 0")
            if ta and len(tns) and \
                    int(tns.max()) >= self.caches[0].tenants:
                # validate BEFORE replaying: failing mid-loop would leave
                # the shard caches half-warmed by a rejected batch
                raise ValueError(
                    f"tenant id {int(tns.max())} out of range for "
                    f"{self.caches[0].tenants}-partition shard caches")
        per_query = np.zeros(B, np.float64)
        per_query_shard = np.zeros((B, S), np.float64)
        shard_req = np.zeros(S, np.int64)
        shard_hits = np.zeros(S, np.int64)
        shard_issued = np.zeros(S, np.int64)
        loads = np.zeros(S, np.int64)
        per_tenant: Dict[int, Dict[str, int]] = {
            int(t): {"requested": 0, "hits": 0, "issued": 0}
            for t in np.unique(tns)}
        requested = hits = issued = prefetched = 0
        charged: List[int] = []

        def resident(s: int, p: int, t: int) -> bool:
            return (p in self.caches[s].parts[t] if ta
                    else p in self.caches[s])

        for b in range(B):
            t = int(tns[b])
            tacct = per_tenant[t]
            hop_pages = [row[row >= 0] for row in trace[b]]
            for h, row in enumerate(hop_pages):
                if len(row) == 0:
                    continue
                # look-ahead against the OWNING shard's queue: the future
                # hop's page is admitted into — and gated on — the shard
                # (and tenant cell) the demand access will route to, so the
                # prefetch charge lands on the same device the demand read
                # would have
                for ahead in hop_pages[h + 1: h + 1 + self.lookahead]:
                    for p in ahead:
                        p = int(p)
                        s = self.placement.route(p, loads)
                        if resident(s, p, t):
                            continue
                        if ta:
                            self.caches[s].admit(p, t)
                        else:
                            self.caches[s].admit(p)
                        issued += 1
                        prefetched += 1
                        shard_issued[s] += 1
                        per_query[b] += 1
                        per_query_shard[b, s] += 1
                        loads[s] += 1
                        tacct["issued"] += 1
                        self.page_read_counts[p] += 1
                        charged.append(p)
                for p in row:
                    p = int(p)
                    s = self.placement.route(p, loads)
                    requested += 1
                    shard_req[s] += 1
                    tacct["requested"] += 1
                    if self.caches is None:
                        hit = False
                    elif ta:
                        hit = self.caches[s].access(p, t)
                    else:
                        hit = self.caches[s].access(p)
                    if hit:
                        hits += 1
                        shard_hits[s] += 1
                        tacct["hits"] += 1
                    else:
                        issued += 1
                        shard_issued[s] += 1
                        per_query[b] += 1
                        per_query_shard[b, s] += 1
                        loads[s] += 1
                        tacct["issued"] += 1
                        self.page_read_counts[p] += 1
                        charged.append(p)
        self.accesses += requested
        self.prefetch_issued += prefetched
        self.counters.pages_requested += requested
        self.counters.cache_hits += hits
        self.counters.pages_fetched += issued
        self.counters.records_fetched += issued * self.layout.n_p
        n_p = self.layout.n_p
        for s in range(S):
            sc = self.shard_counters[s]
            sc.pages_requested += int(shard_req[s])
            sc.cache_hits += int(shard_hits[s])
            sc.pages_fetched += int(shard_issued[s])
            sc.records_fetched += int(shard_issued[s]) * n_p
        for t, a in per_tenant.items():
            life = self.tenant_counters.setdefault(
                t, {"requested": 0, "hits": 0, "issued": 0})
            for k in life:
                life[k] += a[k]
            a["hit_rate"] = (a["hits"] / a["requested"]
                             if a["requested"] else 0.0)
        charge_inner_reads(self.inner, charged)
        return {"requested": requested, "issued": issued, "hits": hits,
                "per_query_issued": per_query,
                "prefetch_issued": prefetched,
                "overlap_frac": prefetched / issued if issued else 0.0,
                "hit_rate": hits / requested if requested else 0.0,
                "per_tenant": per_tenant,
                "shard_requested": shard_req, "shard_hits": shard_hits,
                "shard_issued": shard_issued,
                "per_query_shard_pages": per_query_shard,
                "shard_depths": (per_query_shard > 0).sum(axis=0)}

    def coalesce(self, visited_pages: np.ndarray) -> dict:
        """Order-free path (no per-shard caches needed): cross-query union
        per batch, split by shard. Each union page routes once (replicated
        pages balance on the union's load vector); a query's per-shard page
        count is its DISTINCT visited pages on that shard, so charges scale
        exactly like the single-device BatchedPageStore accounting."""
        visited = np.asarray(visited_pages, bool)
        if visited.ndim != 2:
            raise ValueError(
                f"visited_pages must be (B, num_pages); got {visited.shape}")
        B, S = visited.shape[0], self.shards
        union = np.flatnonzero(visited.any(axis=0))
        loads = np.zeros(S, np.int64)
        shard_of = np.empty(len(union), np.int64)
        for i, p in enumerate(union):
            s = self.placement.route(int(p), loads)
            shard_of[i] = s
            loads[s] += 1
        shard_issued = np.bincount(shard_of, minlength=S)
        if len(union):
            self.page_read_counts[union] += 1
        per_query_shard = np.zeros((B, S), np.float64)
        for i, p in enumerate(union):
            per_query_shard[visited[:, p], shard_of[i]] += 1
        requested = int(visited.sum())
        issued = len(union)
        shard_req = per_query_shard.sum(axis=0).astype(np.int64)
        self.counters.pages_requested += requested
        self.counters.pages_fetched += issued
        self.counters.records_fetched += issued * self.layout.n_p
        n_p = self.layout.n_p
        for s in range(S):
            sc = self.shard_counters[s]
            sc.pages_requested += int(shard_req[s])
            sc.pages_fetched += int(shard_issued[s])
            sc.records_fetched += int(shard_issued[s]) * n_p
        charge_inner_reads(self.inner, union)
        return {"requested": requested, "issued": issued, "hits": 0,
                "shard_requested": shard_req,
                "shard_hits": np.zeros(S, np.int64),
                "shard_issued": shard_issued,
                "per_query_shard_pages": per_query_shard,
                "shard_depths": (per_query_shard > 0).sum(axis=0)}

    # -- reporting -----------------------------------------------------------

    def savings(self) -> int:
        return self.counters.pages_requested - self.counters.pages_fetched

    def hit_rate(self) -> float:
        return (self.counters.cache_hits / self.accesses
                if self.accesses else 0.0)

    def tenant_hit_rates(self) -> Dict[int, float]:
        """Lifetime per-tenant replay hit rates (same contract as
        SharedCachePageStore's)."""
        return {t: (a["hits"] / a["requested"] if a["requested"] else 0.0)
                for t, a in sorted(self.tenant_counters.items())}

    def tenant_capacities(self) -> Optional[List[int]]:
        """Current per-tenant cache capacity summed across the shard
        slices (None unless the shard caches are tenant-partitioned) —
        the fleet-wide answer to "how many pages does tenant t hold"."""
        if not self.tenant_aware:
            return None
        caps = [c.capacities() for c in self.caches]
        return [sum(col) for col in zip(*caps)]

    def shard_rows(self) -> List[dict]:
        """Lifetime per-shard counter rows (placement + conservation
        audits; the serving reports add per-run depth/utilization). Covers
        page-routed traffic — vertex-granular pass-throughs mirror into the
        roll-up `counters` only, so the shard sum can undercut the roll-up
        by exactly that pass-through volume."""
        return [{"shard": s, **c.as_dict(),
                 "hit_rate": (c.cache_hits / c.pages_requested
                              if c.pages_requested else 0.0)}
                for s, c in enumerate(self.shard_counters)]

    def reset_cache(self) -> None:
        if self.caches is not None:
            for c in self.caches:
                c.reset()

    def extend_placement(self, num_pages: int) -> None:
        """Grow the page→shard map for an appended page space (streaming
        updates); see Placement.extend. The live read counters grow with
        it (appended pages start cold)."""
        self.placement = self.placement.extend(num_pages)
        grow = num_pages - len(self.page_read_counts)
        if grow > 0:
            self.page_read_counts = np.concatenate(
                [self.page_read_counts, np.zeros(grow, np.int64)])

    def set_replicated(self, replicated: np.ndarray) -> dict:
        """Swap the replicated hot set IN PLACE — the store-side half of
        online hot-page migration. Homes (`page_to_shard`) never move; only
        the every-shard-resident mask changes, so routing flips between
        "home only" and "least-loaded" per page. Returns the delta
        (`promoted` gained replication — the serving layer bills the page
        copies to the other S-1 shards and invalidates stale residency via
        MutablePageStore.invalidate; `demoted` lost it — a metadata-only
        change, their home copy was never stale)."""
        mask = np.asarray(replicated, bool).reshape(-1)
        if len(mask) != len(self.placement.page_to_shard):
            raise ValueError(
                f"replicated mask has {len(mask)} entries for "
                f"{len(self.placement.page_to_shard)} pages")
        old = self.placement.replicated
        promoted = np.flatnonzero(mask & ~old)
        demoted = np.flatnonzero(old & ~mask)
        self.placement = dataclasses.replace(self.placement,
                                             replicated=mask.copy())
        return {"promoted": promoted, "demoted": demoted}
