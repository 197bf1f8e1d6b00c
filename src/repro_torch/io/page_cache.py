"""I/O layer: stateful shared page caches, multi-tenant partitioning, and
trace-driven prefetching.

Copied into the port from src/repro/io/page_cache.py, structure and names
kept. It is host code on numpy; its only device contact is
`kernel_arrays()`, which passes the inner store's tensors through.

The static vertex mask (`CachedPageStore`, §4.1.2) is order-free: whether a
read hits depends only on which vertex is asked for, never on *when*. The
paper's page-level complexity model (§5) says the next I/O reductions are
temporal — page locality × path length — so this module adds the stateful
half of the cache design space:

  PageCache           — the replacement-policy interface (capacity in pages;
                        `access(page)` probes AND admits, returning hit).
  FIFOPageCache       — evict in admission order (scan-friendly baseline).
  LRUPageCache        — evict least-recently-used (Starling-style shared
                        page cache over the page-aligned layout).
  TwoQPageCache       — simplified 2Q: a FIFO probation queue + a ghost
                        queue + a protected LRU, so one-touch scan pages
                        cannot flush the hot set.
  PartitionedPageCache — multi-tenant: ONE byte budget split into per-tenant
                        partitions of any of the above policies (static
                        shares + optional utility-based rebalance), so a
                        noisy neighbor cannot thrash another tenant's
                        working set.
  SharedCachePageStore — decorator replaying temporally ordered page-access
                        traces (QueryStats.page_trace) against one
                        byte-budgeted cache that persists ACROSS batches;
                        only misses are charged to the inner store's device.
  PrefetchingPageStore — SharedCachePageStore + LAANN-style look-ahead: the
                        next hops' frontier pages are issued while the
                        current hop computes, so their service time can be
                        hidden (the device model's `prefetch_overlap`
                        rebate); the reads are still charged.

The trace contract
------------------
`page_trace` is a (B, max_iters, w) int32 array emitted by the search under
its `track_trace` flag (nothing is recorded when it is off). Row
(b, h) holds the DISTINCT pages query b charged to the device at hop h, in
frontier order, -1 padded on the right; hops past the query's convergence
are all -1. The charged pages are exactly the pages the scalar `page_reads`
counter booked — the trace is the same charges in TEMPORAL order, which is
what makes replacement order (LRU/FIFO/2Q) and look-ahead meaningful.
`replay_batch` walks queries in dispatch order and hops in time order;
with `tenants=` it additionally routes each query's accesses to that
query's cache partition and returns per-tenant accounting.

Policy semantics
----------------
All policies are probe-and-admit (`access` returns hit and, on a miss,
admits the page, evicting per policy). FIFO evicts in admission order and a
hit does NOT renew residency; LRU renews on hit. 2Q (Johnson & Shasha)
splits capacity into a FIFO *probation* queue (A1in, a quarter of capacity)
and a *protected* LRU (Am): new pages must survive probation; pages evicted
from probation leave an id-only *ghost* entry (A1out, several times the
capacity — ids cost pennies against the byte budget), and a later miss that
hits the ghost is promoted straight into the protected LRU. One-touch
beam-search scan pages therefore die in probation instead of flushing the
revisited hot set.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.io.page_store import (StoreCounters, book_charged_reads,
                                       book_writes, charge_inner_reads,
                                       fetch_mirroring_inner,
                                       note_inner_writes, resolve_write)


class PageCache:
    """Replacement-policy interface: a set of resident pages with a page
    capacity. `access` is probe-and-admit: it returns whether the page was
    resident and, on a miss, admits it (evicting per policy). Policies with
    `tenant_aware` set accept `access(page, tenant)` and keep per-tenant
    state (see PartitionedPageCache)."""

    name = "base"
    tenant_aware = False

    def __init__(self, capacity_pages: int):
        if capacity_pages < 1:
            raise ValueError(
                f"capacity_pages={capacity_pages} must be >= 1 "
                f"(a cache that can hold no page cannot hit)")
        self.capacity = int(capacity_pages)

    def access(self, page: int) -> bool:
        raise NotImplementedError

    def admit(self, page: int) -> None:
        """Non-demand warm path (look-ahead prefetch): admit the page
        without the demand-side accounting a subclass may keep. The base
        policies keep no stats, so admission IS probe-and-admit; stats-
        keeping caches (PartitionedPageCache) override this so prefetch
        traffic cannot inflate demand hit rates or rebalance windows."""
        self.access(page)

    def resize(self, capacity_pages: int) -> None:
        """Change capacity in place, evicting per policy if shrinking —
        what the partitioned cache's utility rebalance relies on."""
        if capacity_pages < 1:
            raise ValueError(
                f"capacity_pages={capacity_pages} must be >= 1")
        self.capacity = int(capacity_pages)
        self._shrink_to_capacity()

    def invalidate(self, page: int) -> bool:
        """Drop a (possibly) resident page because its on-disk bytes were
        rewritten (streaming updates: flush/compaction). Returns whether a
        stale copy was actually evicted. NOT a policy eviction: residency
        simply ends, and the next demand access is a charged miss."""
        raise NotImplementedError

    def _shrink_to_capacity(self) -> None:
        """Evict, per policy, until residency fits the (new) capacity."""
        raise NotImplementedError

    def __contains__(self, page: int) -> bool:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class _QueueCache(PageCache):
    """Shared body of the single-OrderedDict policies (FIFO, LRU): the
    subclass's `access` decides whether a hit renews residency; eviction is
    always from the queue front."""

    def __init__(self, capacity_pages: int):
        super().__init__(capacity_pages)
        self._q: OrderedDict = OrderedDict()

    def _shrink_to_capacity(self) -> None:
        while len(self._q) > self.capacity:
            self._q.popitem(last=False)

    def invalidate(self, page: int) -> bool:
        if page in self._q:
            del self._q[page]
            return True
        return False

    def __contains__(self, page: int) -> bool:
        return page in self._q

    def __len__(self) -> int:
        return len(self._q)

    def reset(self) -> None:
        self._q.clear()


class FIFOPageCache(_QueueCache):
    """Evict in admission order; a hit does not renew residency."""

    name = "fifo"

    def access(self, page: int) -> bool:
        if page in self._q:
            return True
        if len(self._q) >= self.capacity:
            self._q.popitem(last=False)
        self._q[page] = None
        return False


class LRUPageCache(_QueueCache):
    """Evict the least-recently-used page; a hit renews residency."""

    name = "lru"

    def access(self, page: int) -> bool:
        if page in self._q:
            self._q.move_to_end(page)
            return True
        if len(self._q) >= self.capacity:
            self._q.popitem(last=False)
        self._q[page] = None
        return False


class TwoQPageCache(PageCache):
    """Simplified 2Q (Johnson & Shasha): new pages enter a FIFO probation
    queue (A1in, a quarter of capacity); pages evicted from probation leave
    an id-only ghost entry (A1out); a miss that hits the ghost queue is
    promoted into the protected LRU (Am). One-touch beam-search scan pages
    therefore die in probation instead of flushing the revisited hot set."""

    name = "2q"

    def __init__(self, capacity_pages: int):
        super().__init__(capacity_pages)
        self._set_caps()
        self._a1in: OrderedDict = OrderedDict()
        self._ghost: OrderedDict = OrderedDict()
        self._am: OrderedDict = OrderedDict()

    def _set_caps(self) -> None:
        """Derive the queue capacities from self.capacity (construction and
        resize share this so the probation fraction cannot diverge)."""
        self._in_cap = max(1, self.capacity // 4)
        self._am_cap = max(1, self.capacity - self._in_cap)
        # ghost entries are page IDS, not pages — pennies against the byte
        # budget — so the re-use memory can run several times the capacity
        self._ghost_cap = 4 * self.capacity

    def access(self, page: int) -> bool:
        if page in self._am:
            self._am.move_to_end(page)
            return True
        if page in self._a1in:
            return True
        # miss: a ghost hit means the page proved re-use beyond probation
        if page in self._ghost:
            del self._ghost[page]
            if len(self._am) >= self._am_cap:
                self._am.popitem(last=False)
            self._am[page] = None
            return False
        if len(self._a1in) >= self._in_cap:
            old, _ = self._a1in.popitem(last=False)
            self._ghost[old] = None
            while len(self._ghost) > self._ghost_cap:
                self._ghost.popitem(last=False)
        self._a1in[page] = None
        return False

    def _shrink_to_capacity(self) -> None:
        self._set_caps()
        while len(self._a1in) > self._in_cap:
            old, _ = self._a1in.popitem(last=False)
            self._ghost[old] = None
        while len(self._am) > self._am_cap:
            self._am.popitem(last=False)
        while len(self._ghost) > self._ghost_cap:
            self._ghost.popitem(last=False)

    def invalidate(self, page: int) -> bool:
        """Evict stale BYTES (probation or protected residency). The ghost
        queue keeps its id-only entry: invalidation rewrites the page's
        content, not the evidence that the page is re-used."""
        hit = False
        if page in self._a1in:
            del self._a1in[page]
            hit = True
        if page in self._am:
            del self._am[page]
            hit = True
        return hit

    def __contains__(self, page: int) -> bool:
        return page in self._a1in or page in self._am

    def __len__(self) -> int:
        return len(self._a1in) + len(self._am)

    def reset(self) -> None:
        self._a1in.clear()
        self._ghost.clear()
        self._am.clear()


class PartitionedPageCache(PageCache):
    """Multi-tenant cache: ONE page budget split into per-tenant partitions
    of a base policy ("lru" | "fifo" | "2q"), so tenants share the byte
    budget but never each other's residency — the partition IS the
    isolation. `access(page, tenant)` routes to that tenant's partition;
    a page hot for two tenants occupies a slot in each (partitioned, not
    deduplicated, exactly like per-tenant OS page-cache cgroups).

    Static split: `shares` (fractions, default equal) sized by largest
    remainder with a 1-page floor per tenant.

    Utility-based rebalance (`rebalance_every` > 0): each tenant also
    maintains a *shadow* id-only LRU of TWICE its current capacity over its
    own access stream — a one-point probe of the tenant's hit curve (from
    its `page_trace` replay) at the doubled-capacity point; probing well
    past the current size is what sees over LRU's cyclic-workload cliff,
    where capacity + 1 still hits nothing. A real miss that the shadow
    would have served means more capacity would have converted it (marginal
    utility). Every `rebalance_every` accesses the window's highest-gain
    tenant takes `rebalance_step` pages of capacity from the lowest-gain
    tenant (ties keep the split; donors never shrink below one page). The
    shadow is LRU regardless of the partition policy — it approximates the
    stack-distance hit curve, which is the quantity the rebalance trades
    on.

    With `tenants=1` the single partition gets the whole budget and every
    access routes straight through — bit-identical to the base policy
    (tested in tests/test_page_cache.py)."""

    name = "partitioned"
    tenant_aware = True

    def __init__(self, capacity_pages: int, tenants: int,
                 policy: str = "lru",
                 shares: Optional[Sequence[float]] = None,
                 rebalance_every: int = 0,
                 rebalance_step: Optional[int] = None):
        super().__init__(capacity_pages)
        if tenants < 1:
            raise ValueError(f"tenants={tenants} must be >= 1")
        if capacity_pages < tenants:
            raise ValueError(
                f"capacity_pages={capacity_pages} cannot give each of "
                f"{tenants} tenants its 1-page floor")
        if policy not in POLICIES:
            raise ValueError(f"unknown partition policy {policy!r}; "
                             f"choose from {sorted(POLICIES)}")
        if rebalance_every < 0:
            raise ValueError(
                f"rebalance_every={rebalance_every} must be >= 0 (0 = off)")
        if shares is None:
            shares = [1.0 / tenants] * tenants
        shares = [float(s) for s in shares]
        if len(shares) != tenants:
            raise ValueError(
                f"shares has {len(shares)} entries for {tenants} tenants")
        if any(s <= 0 for s in shares):
            raise ValueError(f"shares={shares} must all be positive")
        total = sum(shares)
        # largest-remainder allocation with a 1-page floor per tenant
        raw = [s / total * capacity_pages for s in shares]
        caps = [max(1, int(f)) for f in raw]
        rem = sorted(range(tenants), key=lambda t: raw[t] - int(raw[t]),
                     reverse=True)
        r = 0
        while sum(caps) < capacity_pages:
            caps[rem[r % tenants]] += 1
            r += 1
        while sum(caps) > capacity_pages:
            t = max(range(tenants), key=lambda t: caps[t])
            caps[t] -= 1
        self.policy = policy
        self.tenants = tenants
        self.parts: List[PageCache] = [POLICIES[policy](c) for c in caps]
        self.rebalance_every = int(rebalance_every)
        self.rebalance_step = int(rebalance_step
                                  or max(1, capacity_pages // (8 * tenants)))
        self._shadow = [OrderedDict() for _ in range(tenants)]
        self._gain = [0] * tenants          # window shadow-convertible misses
        self._since = 0                     # accesses since last rebalance
        self.t_accesses = [0] * tenants     # lifetime per-tenant probes
        self.t_hits = [0] * tenants
        self.rebalances = 0                 # capacity moves actually applied

    def access(self, page: int, tenant: int = 0) -> bool:
        part = self.parts[tenant]
        hit = part.access(page)
        self.t_accesses[tenant] += 1
        self.t_hits[tenant] += hit
        if self.rebalance_every:
            sh = self._shadow[tenant]
            if page in sh:
                if not hit:
                    self._gain[tenant] += 1
                sh.move_to_end(page)
            else:
                while len(sh) >= 2 * part.capacity:
                    sh.popitem(last=False)
                sh[page] = None
            self._since += 1
            if self._since >= self.rebalance_every:
                self._rebalance()
        return hit

    def admit(self, page: int, tenant: int = 0) -> None:
        """Non-demand warm (look-ahead prefetch): admit into the tenant's
        partition WITHOUT touching `t_accesses`/`t_hits`, the shadow LRU,
        or the rebalance window — prefetch traffic is not demand, and
        counting it would skew `tenant_hit_rates()` and could flip the
        utility rebalance."""
        self.parts[tenant].access(page)

    def _rebalance(self) -> None:
        self._since = 0
        order = sorted(range(self.tenants), key=lambda t: self._gain[t])
        recipient, donor = order[-1], None
        for t in order:
            if t != recipient and self.parts[t].capacity > 1:
                donor = t
                break
        if donor is not None and self._gain[recipient] > self._gain[donor]:
            step = min(self.rebalance_step, self.parts[donor].capacity - 1)
            if step > 0:
                self.parts[donor].resize(self.parts[donor].capacity - step)
                self.parts[recipient].resize(
                    self.parts[recipient].capacity + step)
                self.rebalances += 1
        self._gain = [0] * self.tenants

    def invalidate(self, page: int) -> bool:
        """Drop stale copies from EVERY tenant's partition (a page hot for
        two tenants is resident twice) and from the shadow LRUs — a shadow
        entry for rewritten bytes would otherwise count a would-have-hit
        that could never have served the new content."""
        hit = False
        for p in self.parts:
            hit = p.invalidate(page) or hit
        for sh in self._shadow:
            sh.pop(page, None)
        return hit

    def capacities(self) -> List[int]:
        """Current per-tenant page capacities (moves under rebalance)."""
        return [p.capacity for p in self.parts]

    def tenant_hit_rates(self) -> List[float]:
        """Lifetime per-tenant hit rates — the fairness signal the overload
        benchmark reports."""
        return [h / a if a else 0.0
                for h, a in zip(self.t_hits, self.t_accesses)]

    def resize(self, capacity_pages: int) -> None:
        raise NotImplementedError(
            "resize the partitions (parts[t].resize), not the envelope — "
            "the total budget is fixed at construction")

    def __contains__(self, page: int) -> bool:
        return any(page in p for p in self.parts)

    def __len__(self) -> int:
        return sum(len(p) for p in self.parts)

    def reset(self) -> None:
        """Drop residency and rebalance window state; the current capacity
        split (including any rebalance moves) is kept."""
        for p in self.parts:
            p.reset()
        for sh in self._shadow:
            sh.clear()
        self._gain = [0] * self.tenants
        self._since = 0


POLICIES = {c.name: c for c in (LRUPageCache, FIFOPageCache, TwoQPageCache)}

#: build_store() cache_policy values that compose a stateful shared cache
#: (vs. "none" and the order-free "static-vertex" mask).
DYNAMIC_POLICIES = tuple(POLICIES)


def floor_capacity_pages(cache_bytes: int, page_bytes: int, parts: int,
                         noun: str) -> int:
    """Translate a byte budget to whole-page capacity, validating that each
    of `parts` partitions (`noun`: "tenants" | "shards") gets its 1-page
    floor — the error names the BYTES the caller configured, not just the
    derived page count."""
    capacity = cache_bytes // page_bytes
    if capacity < parts:
        raise ValueError(
            f"cache_bytes={cache_bytes} is only {capacity} page(s) of "
            f"{page_bytes} bytes — cannot give each of {parts} {noun} its "
            f"1-page floor (need cache_bytes >= {parts * page_bytes})")
    return capacity


def make_cache(policy: str, cache_bytes: int, page_bytes: int,
               tenants: int = 1,
               tenant_shares: Optional[Sequence[float]] = None,
               rebalance_every: int = 0) -> PageCache:
    """Instantiate a policy with a byte budget translated to whole pages.
    `tenants > 1` partitions the SAME budget across tenants (optionally
    with static `tenant_shares` and utility rebalance every
    `rebalance_every` accesses) — see PartitionedPageCache."""
    if policy not in POLICIES:
        raise ValueError(f"unknown cache policy {policy!r}; "
                         f"choose from {sorted(POLICIES)}")
    if cache_bytes < page_bytes:
        raise ValueError(
            f"cache_bytes={cache_bytes} holds no {page_bytes}-byte page")
    if tenants < 1:
        raise ValueError(f"tenants={tenants} must be >= 1")
    if tenants > 1:
        # validate in BYTES here: the page-floor error the partition itself
        # raises never mentions the budget the caller actually configured
        capacity = floor_capacity_pages(cache_bytes, page_bytes, tenants,
                                        "tenants")
        return PartitionedPageCache(
            capacity, tenants, policy=policy,
            shares=tenant_shares, rebalance_every=rebalance_every)
    return POLICIES[policy](cache_bytes // page_bytes)


class SharedCachePageStore:
    """Decorator: one byte-budgeted page cache shared by every query and —
    unlike `BatchedPageStore`, whose union-dedup forgets everything at the
    batch boundary — persisting ACROSS batches for the lifetime of the
    store. `replay_batch` consumes temporally ordered `page_trace`s; only
    misses are charged as device reads, so a warm cache strictly undercuts
    batch-local coalescing whenever consecutive batches share pages (entry
    pages, hot regions).

    `lookahead > 0` adds LAANN-style prefetching: while hop h computes, the
    pages hops h+1..h+lookahead will charge are issued ahead. Prefetched
    reads still cost device I/O (they move `pages_fetched` and
    `prefetch_issued`) but their service overlaps compute — the returned
    `overlap_frac` feeds `SSDModel.concurrent_latency_us(prefetch_overlap=)`.
    Replay is the oracle form of look-ahead (the trace is the prediction);
    a small cache can still evict a prefetched page before use, which is
    exactly the wasted-I/O failure mode of real look-ahead.

    Tenancy: `replay_batch(tenants=)` is the tenant-aware path. The
    PageStore-protocol `fetch` below is tenant-blind — with a partitioned
    cache it probes and warms the DEFAULT partition (tenant 0) only, so
    multi-tenant serving must account I/O through replay, not fetch."""

    def __init__(self, inner, cache: PageCache, lookahead: int = 0):
        if lookahead < 0:
            raise ValueError(f"lookahead={lookahead} must be >= 0")
        self.inner = inner
        self.cache = cache
        self.lookahead = int(lookahead)
        self.counters = StoreCounters()
        self.accesses = 0          # trace/fetch page probes
        self.prefetch_issued = 0   # look-ahead reads charged to the device
        # lifetime per-tenant replay accounting (tenant -> requested/hits/
        # issued); the partitioned cache additionally tracks residency-level
        # per-tenant hit rates, but this dict exists for ANY cache so a
        # shared (unpartitioned) cache can expose noisy-neighbor interference
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
            # vertex-granular requests belong to the static-vertex layer —
            # pass through, mirroring the inner store's counter movement
            return fetch_mirroring_inner(self.counters, self.inner,
                                         page_ids, vids)
        hit = np.fromiter((self.cache.access(int(p)) for p in page_ids),
                          bool, len(page_ids))
        self.accesses += len(page_ids)
        self.counters.cache_hits += int(hit.sum())
        misses = page_ids[~hit]
        self.counters.pages_fetched += len(misses)
        self.counters.records_fetched += len(misses) * self.layout.n_p
        charge_inner_reads(self.inner, misses)
        lay = self.layout
        return {"vids": lay.page_vids[page_ids],
                "vecs": lay.page_vecs[page_ids],
                "nbrs": lay.page_nbrs[page_ids]}

    def kernel_arrays(self) -> tuple:
        return self.inner.kernel_arrays()

    def vertex_cache_mask(self) -> np.ndarray:
        return self.inner.vertex_cache_mask()

    def note_kernel_io(self, stats) -> None:
        # replay_batch is this store's accounting path; forward only
        self.inner.note_kernel_io(stats)

    def charge(self, page_ids: np.ndarray) -> None:
        """Accounting-only reads from a layer above: book 1:1 and forward.
        Charges bypass the cache (they are already-issued device reads, not
        probes), so residency is untouched."""
        page_ids = np.asarray(page_ids, np.int64).reshape(-1)
        book_charged_reads(self.counters, len(page_ids), self.layout.n_p)
        self.inner.charge(page_ids)

    def note_write(self, page_ids=None, *, kind: str = "data",
                   count: Optional[int] = None) -> None:
        """Writes bypass the cache (invalidation is MutablePageStore's
        job; the write itself is device traffic): book 1:1, forward down."""
        pages, n = resolve_write(page_ids, count)
        book_writes(self.counters, n, kind)
        note_inner_writes(self.inner, pages, kind, n)

    # -- trace replay (the serving-path accounting) --------------------------

    def replay_batch(self, page_trace: np.ndarray,
                     tenants: Optional[np.ndarray] = None) -> dict:
        """page_trace: (B, hops, w) int32, -1 padded — each query's charged
        pages in hop order (QueryStats.page_trace). Replays queries in
        dispatch order against the shared cache; `tenants` (optional (B,)
        ints, default all 0) routes each query's accesses to that tenant's
        partition when the cache is tenant-aware, and keys the per-tenant
        accounting either way. Returns the batch's device accounting:

          requested         trace page accesses (== sum of page_reads)
          issued            reads charged to the device (demand misses +
                            look-ahead issues)
          hits              accesses served by the resident cache
          per_query_issued  (B,) float64 — reads charged while replaying
                            each query (its latency share)
          prefetch_issued   look-ahead reads within `issued`
          overlap_frac      prefetch_issued / issued (the latency-hiding
                            fraction for the device model)
          hit_rate          hits / requested
          per_tenant        {tenant: {requested, hits, issued, hit_rate}}
        """
        trace = np.asarray(page_trace)
        if trace.ndim != 3:
            raise ValueError(
                f"page_trace must be (B, hops, w); got shape {trace.shape}")
        B = trace.shape[0]
        ta = getattr(self.cache, "tenant_aware", False)
        if tenants is None:
            tns = np.zeros(B, np.int64)
        else:
            tns = np.asarray(tenants, np.int64).reshape(-1)
            if len(tns) != B:
                raise ValueError(
                    f"tenants has {len(tns)} entries for a {B}-query trace")
            if np.any(tns < 0):
                raise ValueError("tenant ids must be >= 0")
            if ta and len(tns) and int(tns.max()) >= self.cache.tenants:
                # validate BEFORE replaying: failing mid-loop would leave
                # the shared cache half-warmed by a rejected batch
                raise ValueError(
                    f"tenant id {int(tns.max())} out of range for a "
                    f"{self.cache.tenants}-partition cache")
        per_query = np.zeros(B, np.float64)
        per_tenant: Dict[int, Dict[str, int]] = {
            int(t): {"requested": 0, "hits": 0, "issued": 0}
            for t in np.unique(tns)}
        requested = hits = issued = prefetched = 0
        charged: List[int] = []     # every device read, in issue order
        for b in range(B):
            t = int(tns[b])
            tacct = per_tenant[t]
            hop_pages = [row[row >= 0] for row in trace[b]]
            for h, row in enumerate(hop_pages):
                if len(row) == 0:
                    continue
                # look-ahead: issue the next hops' pages while h computes
                # (into — and gated on — this query's own partition).
                # admit(), not access(): prefetch traffic is not demand,
                # so it must not move demand hit rates or the partitioned
                # cache's shadow/rebalance window
                for ahead in hop_pages[h + 1: h + 1 + self.lookahead]:
                    for p in ahead:
                        resident = (int(p) in self.cache.parts[t] if ta
                                    else int(p) in self.cache)
                        if not resident:
                            if ta:
                                self.cache.admit(int(p), t)
                            else:
                                self.cache.admit(int(p))
                            issued += 1
                            prefetched += 1
                            per_query[b] += 1
                            tacct["issued"] += 1
                            charged.append(int(p))
                for p in row:
                    requested += 1
                    tacct["requested"] += 1
                    hit = (self.cache.access(int(p), t) if ta
                           else self.cache.access(int(p)))
                    if hit:
                        hits += 1
                        tacct["hits"] += 1
                    else:
                        issued += 1
                        per_query[b] += 1
                        tacct["issued"] += 1
                        charged.append(int(p))
        self.accesses += requested
        self.prefetch_issued += prefetched
        self.counters.pages_requested += requested
        self.counters.cache_hits += hits
        self.counters.pages_fetched += issued
        self.counters.records_fetched += issued * self.layout.n_p
        # forward the misses' charge to the inner store: a decorator whose
        # reads never reach the device it decorates breaks every
        # cross-stack rollup (savings(), as_dict() audits)
        charge_inner_reads(self.inner, charged)
        for t, a in per_tenant.items():
            life = self.tenant_counters.setdefault(
                t, {"requested": 0, "hits": 0, "issued": 0})
            for k in life:
                life[k] += a[k]
            a["hit_rate"] = (a["hits"] / a["requested"]
                             if a["requested"] else 0.0)
        return {"requested": requested, "issued": issued, "hits": hits,
                "per_query_issued": per_query,
                "prefetch_issued": prefetched,
                "overlap_frac": prefetched / issued if issued else 0.0,
                "hit_rate": hits / requested if requested else 0.0,
                "per_tenant": per_tenant}

    def tenant_hit_rates(self) -> Dict[int, float]:
        """Lifetime per-tenant replay hit rates (every tenant this store
        has replayed), whatever the cache type."""
        return {t: (a["hits"] / a["requested"] if a["requested"] else 0.0)
                for t, a in sorted(self.tenant_counters.items())}

    def hit_rate(self) -> float:
        """Lifetime hit rate over every access this store has seen."""
        return (self.counters.cache_hits / self.accesses
                if self.accesses else 0.0)

    def reset_cache(self) -> None:
        self.cache.reset()


class PrefetchingPageStore(SharedCachePageStore):
    """SharedCachePageStore with look-ahead on by default: the named form
    `build_store(..., prefetch=k)` composes. Kept as its own class so the
    store stack reads as policy objects (isinstance tells the configuration)."""

    def __init__(self, inner, cache: PageCache, lookahead: int = 1):
        if lookahead < 1:
            raise ValueError(
                f"lookahead={lookahead} must be >= 1 for a prefetching "
                f"store (use SharedCachePageStore for pure caching)")
        super().__init__(inner, cache, lookahead=lookahead)
