"""Fleet layer: replica groups over the sharded store — load-aware
routing, per-replica admission budgets, online hot-page migration, and
hysteresis autoscaling.

The port of src/repro/serving/fleet.py. Its one device contact is the
inherited `AnnServer._execute`, once per dispatched batch, on the index's
device (with `pipeline="fused"` that batch's page schedule runs through the
`fused_page_rank` CUDA kernel); every group's store stack is built on the
same device. Everything else is host code on the virtual clock, copied from
the reference.

One `AnnServer` serves from ONE copy of the shard set; past its saturation
point the only remaining axis is more COPIES. `FleetServer` runs N replica
groups, each a full `build_store` stack over the same index (its own
per-shard caches, counters and device clocks — replicas share bytes, never
state), and routes every dispatched batch to one group:

  least-work routing   the batch goes to the group whose devices free up
                       earliest (min over groups of max(exec_free,
                       bg_free)) — least-outstanding-work, the load signal
                       the per-replica `_ShardWindow` busy clocks carry.
  round-robin          the degenerate baseline (blind rotation).

Groups serve concurrently in virtual time, so saturation goodput scales
with the group count; the device model prices each batch on the fleet's
(B, R, S) grid (`SSDModel.concurrent_latency_us` 3-D path), so completion
is the max over REPLICAS THEN SHARDS and an imbalanced fleet stays visibly
slower than a balanced one.

Per-replica admission budgets (`FleetConfig.replica_budget_qps`): the fleet
admits at most budget x routable-groups QPS through a token bucket whose
rate tracks the live group count — adding a group buys admission capacity,
draining one takes it away. Budget sheds land in the report's `shed`
column next to the AdmissionController's own.

Online hot-page migration (`MigrationConfig`): every `every_us` of virtual
time a background rebalancer diffs each group's live per-page read
counters against the last window (`profile_from_counters` deltas), ranks
the window's hottest pages, and swaps the replicated hot set in place
(`ShardedPageStore.set_replicated`). Promotions are real I/O: each
promoted page is read once from its home shard and written to the other
S-1 shards. Unlike flush/compaction — which rewrite pages the very next
query needs and therefore block dispatch — migration copies run THROTTLED
on spare device bandwidth: they land on the group's dedicated migration
clock (`_Replica.mig_free`), which gates only the NEXT rebalance (one copy
wave in flight at a time) and the run's end time, and they bill device
busy time (utilization, shard windows) without stalling foreground
dispatch. A promoted page's HOME copy never moves, so its cached bytes
stay valid; a DEMOTED page's replica copies cease to exist, so its stale
residency is dropped through `MutablePageStore.invalidate` (the
store-version half of the streaming-update subsystem, reused here) —
otherwise demotions are metadata-only. This is the replicated placement's
cold-start story at fleet scale: start from ANY base placement and let the
serving window itself discover the hot set.

Autoscaling (`AutoscaleConfig`): every `check_every_us` the fleet's window
utilization (busy device time over elapsed, averaged over routable groups)
is compared against a hysteresis band — above `util_high` one group is
added (up to `max_groups`), below `util_low` the least-loaded group starts
DRAINING: it receives no new batches, finishes what it holds, and only
then counts as dropped (drain-before-drop; never below `min_groups`). The
decision timeline is recorded for the traffic-replay acceptance check.

Mutations compose: the fleet attaches every group's store to the shared
`MutableIndex`, so a flush or compaction invalidates every group's caches,
and its device I/O is billed on EVERY group's background clock (each group
owns a full copy of the pages being rewritten).

`FleetReport` extends `OpenLoopReport` — the same schema-stable row
columns (per-tenant, per-shard, measured-step) plus the fleet outcome:
group counts, scale events, migration volume, and per-group r<N>_*
columns. `per_shard` is keyed by (group, shard) cell, so the flattened
`shards`/`shard_imbalance` columns measure imbalance across the WHOLE
fleet's devices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch import sanitize
from repro_torch.core.stats import QueryStats
from repro_torch.io import profile_from_counters
from repro_torch.mutation import Compactor, MutationMix
from repro_torch.obs import Tracer
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.ann_server import (AnnServer, OpenLoopReport,
                                      _latency_summary, _measured_step)

#: FleetConfig.routing policy names.
ROUTING_POLICIES = ("least-work", "round-robin")


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Online hot-page migration knobs (None on FleetConfig = off)."""

    every_us: float = 10_000.0   # profile window / rebalance period
    hot_frac: float = 0.25       # page-space fraction eligible for the
    #                              replicated hot set
    max_moves: int = 64          # promotion cap per run (demotions follow
    #                              the ranking and are metadata-only)
    min_reads: int = 2           # window reads a page needs to be ranked
    #                              hot (one read is noise, not heat)

    def __post_init__(self):
        if self.every_us <= 0:
            raise ValueError(f"every_us={self.every_us} must be positive")
        if not 0.0 < self.hot_frac <= 1.0:
            raise ValueError(
                f"hot_frac={self.hot_frac} must be in (0, 1]")
        if self.max_moves < 1:
            raise ValueError(f"max_moves={self.max_moves} must be >= 1")
        if self.min_reads < 1:
            raise ValueError(f"min_reads={self.min_reads} must be >= 1")


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Hysteresis autoscaling knobs (None on FleetConfig = off). `util`
    is mean group OCCUPANCY over the check window: executor service time
    plus background device time, over elapsed — ~1.0 means the routable
    groups are serving back to back."""

    check_every_us: float = 10_000.0  # occupancy sampling period
    util_high: float = 0.75      # add a group above this...
    util_low: float = 0.30       # ...drain one below this
    min_groups: int = 1
    max_groups: int = 8

    def __post_init__(self):
        if self.check_every_us <= 0:
            raise ValueError(
                f"check_every_us={self.check_every_us} must be positive")
        if not 0.0 <= self.util_low < self.util_high:
            raise ValueError(
                f"hysteresis band needs 0 <= util_low < util_high; got "
                f"[{self.util_low}, {self.util_high}]")
        if self.min_groups < 1:
            raise ValueError(
                f"min_groups={self.min_groups} must be >= 1")
        if self.max_groups < self.min_groups:
            raise ValueError(
                f"max_groups={self.max_groups} < min_groups="
                f"{self.min_groups}")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Replica-group layer config (ServerConfig still describes ONE
    group's store: shards, placement, caches, tenants, prefetch)."""

    replica_groups: int = 2      # groups at start (autoscale moves it
    #                              inside [min_groups, max_groups])
    routing: str = "least-work"  # ROUTING_POLICIES
    replica_budget_qps: float = 0.0   # admission budget PER GROUP (0 =
    #                              unbudgeted); fleet admission rate =
    #                              budget x routable groups
    migration: Optional[MigrationConfig] = None
    autoscale: Optional[AutoscaleConfig] = None

    def __post_init__(self):
        if self.replica_groups < 1:
            raise ValueError(
                f"replica_groups={self.replica_groups} must be >= 1")
        if self.routing not in ROUTING_POLICIES:
            raise ValueError(
                f"routing={self.routing!r} must be one of "
                f"{ROUTING_POLICIES}")
        if self.replica_budget_qps < 0:
            raise ValueError(
                f"replica_budget_qps={self.replica_budget_qps} must be "
                f">= 0 (0 = no budget)")
        if self.migration is not None \
                and not isinstance(self.migration, MigrationConfig):
            raise ValueError(
                f"migration={self.migration!r} must be a MigrationConfig "
                f"(or None for a static placement)")
        if self.autoscale is not None \
                and not isinstance(self.autoscale, AutoscaleConfig):
            raise ValueError(
                f"autoscale={self.autoscale!r} must be an AutoscaleConfig "
                f"(or None for a fixed fleet)")
        if self.autoscale is not None \
                and self.replica_groups > self.autoscale.max_groups:
            raise ValueError(
                f"replica_groups={self.replica_groups} starts above "
                f"autoscale.max_groups={self.autoscale.max_groups}")


class _Replica:
    """One replica group: a full store stack plus its own device clocks
    and window accounting. `exec_free` is when its executor next frees
    up; `bg_free` is its background device clock (flush / compaction /
    migration I/O); `busy_us` accumulates OCCUPANCY — executor service
    time plus background device time — the signal autoscaling reads. (Not
    raw issued-read units: a fully cache-resident group can be saturated
    on compute/issue overhead while its device sits idle, and the scaler
    must still see that. Per-DEVICE busy fractions live on the shard
    window.)"""

    def __init__(self, rid: int, store, window, born_us: float = 0.0):
        self.rid = rid
        self.store = store
        self.window = window
        self.exec_free = born_us
        self.bg_free = born_us
        self.mig_free = born_us     # throttled migration-copy clock: gates
        #                             the next rebalance, never dispatch
        self.busy_us = 0.0
        self.busy_mark = 0.0        # busy_us at the last autoscale check
        self.active = True
        self.draining = False
        self.batches = 0
        self.completed = 0
        self.requested = 0
        self.issued = 0
        self.hits = 0
        self.mig_base: Optional[np.ndarray] = None

    @property
    def routable(self) -> bool:
        return self.active and not self.draining

    def free_at(self) -> float:
        # mig_free is deliberately absent: throttled background copies
        # never block a dispatch (see the module docstring)
        return max(self.exec_free, self.bg_free)

    def row(self, elapsed_us: float) -> dict:
        return {
            "batches": self.batches, "completed": self.completed,
            "issued": self.issued,
            "hit_rate": (round(self.hits / self.requested, 4)
                         if self.requested else 0.0),
            "utilization": (round(self.busy_us / elapsed_us, 4)
                            if elapsed_us > 0 else 0.0),
            "state": ("active" if self.routable else
                      "draining" if self.active else "dropped")}


@dataclasses.dataclass
class FleetReport(OpenLoopReport):
    """OpenLoopReport plus the fleet outcome. `per_shard` is keyed by
    "r<g>.s<s>" cells, so the inherited shard columns aggregate across
    every device in the fleet."""

    groups: int = 0              # groups configured at start
    groups_final: int = 0        # routable groups at the end of the run
    groups_added: int = 0        # autoscale activations
    groups_dropped: int = 0      # drained-and-dropped groups
    migrations: int = 0          # rebalancer runs that moved pages
    promoted_pages: int = 0      # pages gaining replication (summed over
    #                              groups — each group copies its own)
    demoted_pages: int = 0
    mig_pages_read: int = 0      # migration copy I/O (read home copy...)
    mig_pages_written: int = 0   # ...write S-1 replicas
    mig_io_us: float = 0.0       # background device time it consumed
    shed_budget: int = 0         # arrivals shed by the per-replica
    #                              admission budget (within `shed`)
    per_replica: Optional[dict] = None  # {rid: _Replica.row()}
    timeline: Optional[list] = None     # autoscale samples: (t_us,
    #                              routable_groups, window_util, event)

    def row(self) -> dict:
        row = super().row()
        row.update({
            "groups": self.groups,
            "groups_final": self.groups_final,
            "groups_added": self.groups_added,
            "groups_dropped": self.groups_dropped,
            "migrations": self.migrations,
            "promoted_pages": self.promoted_pages,
            "mig_pages_written": self.mig_pages_written,
            "shed_budget": self.shed_budget,
        })
        if self.per_replica:
            for rid, r in sorted(self.per_replica.items()):
                row[f"r{rid}_completed"] = r["completed"]
                row[f"r{rid}_util"] = r["utilization"]
        return row


class FleetServer(AnnServer):
    """N replica groups over one index. The inherited `self.store` is the
    KERNEL-side store (search arrays only — every group shares the same
    bytes); each group's I/O replays against its OWN store stack, so cache
    state, counters and device clocks never leak between groups."""

    def __init__(self, index, cfg=None, model=None, server_cfg=None,
                 fleet_cfg: Optional[FleetConfig] = None,
                 page_profile: Optional[np.ndarray] = None):
        super().__init__(index, cfg, model, server_cfg,
                         page_profile=page_profile)
        self.fleet_cfg = fleet_cfg or FleetConfig()
        self._page_profile = page_profile
        # the placement AnnServer actually built (it may have fallen back
        # from "replicated" to "round-robin" when no profile was given —
        # with migration on, that IS the cold start the rebalancer fixes)
        self._eff_placement = (self.store.placement.name if self._sharded
                              else "round-robin")
        self._use_vertex_cache = (self.cfg.cache_frac > 0
                                  and index.cached.any())
        self._mig_mask: Optional[np.ndarray] = None
        self.replicas: List[_Replica] = []
        self._rr_next = 0           # round-robin routing cursor
        for _ in range(self.fleet_cfg.replica_groups):
            self._activate_group(0.0)

    # -- group lifecycle -----------------------------------------------------

    def _activate_group(self, now_us: float) -> _Replica:
        """Build one replica group's store stack and put it in rotation.
        The store is mutable-wrapped whenever the index mutates OR
        migration is on (migration invalidates through MutablePageStore).
        A group added mid-run starts at the current hot-set mask — its
        image is provisioned with the replicas in place, so only FUTURE
        migrations bill copy I/O to it."""
        from repro_torch.io import build_store
        scfg = self.server_cfg
        store = build_store(
            self.index.layout,
            cached_vertices=(self.index.cached
                             if self._use_vertex_cache else None),
            batched=True,
            cache_policy=scfg.cache_policy if self._stateful else "none",
            cache_bytes=scfg.cache_bytes,
            prefetch=scfg.prefetch,
            tenants=scfg.tenants if self._stateful else 1,
            tenant_shares=scfg.tenant_shares,
            rebalance_every=scfg.cache_rebalance_every,
            shards=scfg.shards,
            placement=self._eff_placement if self._sharded
            else "round-robin",
            page_profile=self._page_profile,
            placement_hot_frac=scfg.placement_hot_frac,
            mutable=self._mutable or self.fleet_cfg.migration is not None,
            device=self.index.device)
        if self._mutable:
            self.index.attach_store(store)
        if self._sharded and self._mig_mask is not None:
            store.set_replicated(self._mig_mask)
        r = _Replica(len(self.replicas), store,
                     self._shard_window(store), born_us=now_us)
        self.replicas.append(r)
        return r

    def _routable(self) -> List[_Replica]:
        return [r for r in self.replicas if r.routable]

    def _route(self, routable: List[_Replica]) -> _Replica:
        """Pick the serving group: least outstanding work (the group whose
        devices free up earliest), or blind rotation."""
        if self.fleet_cfg.routing == "round-robin":
            r = routable[self._rr_next % len(routable)]
            self._rr_next += 1
            return r
        return min(routable, key=lambda r: (r.free_at(), r.rid))

    # -- the fleet open loop -------------------------------------------------

    def serve_fleet(self, queries: np.ndarray, rate_qps: float,
                    duration_us: float, seed: int = 0,
                    tenants: Optional[np.ndarray] = None,
                    arrivals: Optional[np.ndarray] = None,
                    mutation_mix: Optional[MutationMix] = None,
                    insert_pool: Optional[np.ndarray] = None,
                    rng: Optional[np.random.Generator] = None,
                    tracer: Optional[Tracer] = None) -> FleetReport:
        """The open-loop contract of `AnnServer.serve_open_loop` (same
        arrival/admission/batcher semantics, one seeded rng end to end)
        run against the replica groups: every dispatched batch routes to
        one group, groups serve concurrently in virtual time, and the
        migration / autoscale hooks run on the virtual clock between
        dispatches. Returns a `FleetReport`.

        Latency attribution follows the single-server contract — every
        completed query satisfies ``queue_us + service_us +
        interference_us == latency_us`` — with the fleet's queue phase
        defined against the *background-free counterfactual*: queue is
        the wait until the fleet would have dispatched with every
        group's background/migration clock idle, and interference is
        the extra wait the bg/migration work actually caused on the
        routed group.

        Pass a `repro_torch.obs.Tracer` to record spans (pid = replica group
        id; admission instants land on pid 0's admission track, device
        and query spans on the routed group's tracks, background and
        migration spans on each billed group's own tracks)."""
        if rate_qps <= 0:
            raise ValueError(f"rate_qps={rate_qps} must be positive")
        if duration_us <= 0:
            raise ValueError(
                f"duration_us={duration_us} must be positive")
        fcfg = self.fleet_cfg
        mm = mutation_mix if (mutation_mix is not None
                              and mutation_mix.mutating) else None
        if mm is not None:
            if not self._mutable:
                raise ValueError(
                    "mutation_mix with insert/delete arrivals needs a "
                    "FleetServer over a MutableIndex")
            if mm.insert_frac > 0 and (insert_pool is None
                                       or len(insert_pool) == 0):
                raise ValueError(
                    "insert_frac > 0 needs a non-empty insert_pool")
        queries = np.asarray(queries, np.float32)
        d = queries.shape[1]
        scfg = self.server_cfg
        tenant_of = self._tenant_map(queries, tenants)
        multi_tenant = tenants is not None or scfg.tenants > 1

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
        if mm is not None:
            kinds = gen.choice(
                3, size=n,
                p=[mm.read_frac, mm.insert_frac, mm.delete_frac])
        else:
            kinds = np.zeros(n, np.int64)
        reads = kinds == 0
        n_reads = int(reads.sum())
        qidx = (np.where(reads, np.cumsum(reads) - 1, 0)) % len(queries)
        arr_tenant = tenant_of[qidx]

        rd_us = self.model.read_service_us(self.index.layout.page_bytes)
        wr_us = self.model.write_service_us(self.index.layout.page_bytes)
        compactor = Compactor(self.index, mm) if mm is not None else None
        mu = {"inserts": 0, "deletes": 0, "flushes": 0, "compactions": 0,
              "reads": 0, "writes": 0, "io_us": 0.0, "ins_i": 0}
        mig = {"runs": 0, "promoted": 0, "demoted": 0, "reads": 0,
               "writes": 0, "io_us": 0.0,
               "next": (fcfg.migration.every_us
                        if fcfg.migration is not None else np.inf)}
        asc = fcfg.autoscale
        scale = {"added": 0, "dropped": 0, "last_t": 0.0,
                 "next": asc.check_every_us if asc is not None else np.inf}
        timeline: List[tuple] = []
        # per-replica admission budget: one bucket whose rate tracks the
        # ROUTABLE group count (10 ms of burst at the current rate)
        budget_on = fcfg.replica_budget_qps > 0
        bud = {"tokens": 0.0, "t": 0.0, "shed": 0}
        if budget_on:
            bud["tokens"] = max(
                1.0, fcfg.replica_budget_qps * len(self._routable()) * 0.01)

        def budget_rate() -> float:
            return fcfg.replica_budget_qps * max(1, len(self._routable()))

        def budget_take(t: float) -> bool:
            """Refill to `t` at the live fleet rate, then take one token;
            False = shed by budget (the arrival never reaches the
            AdmissionController)."""
            if not budget_on:
                return True
            rate = budget_rate()
            burst = max(1.0, rate * 0.01)
            bud["tokens"] = min(
                burst, bud["tokens"] + (t - bud["t"]) * rate / 1e6)
            bud["t"] = t
            if bud["tokens"] >= 1.0:
                bud["tokens"] -= 1.0
                return True
            bud["shed"] += 1
            return False

        def bg_run(acct, t: float, kind: str) -> None:
            """Flush/compaction I/O: every ACTIVE group owns a full copy
            of the rewritten pages, so the same device work lands on each
            group's background clock and shard window."""
            if not acct:
                return
            us = (acct["pages_read"] * rd_us
                  + acct["pages_written"] * wr_us)
            mu[kind] += 1
            mu["reads"] += acct["pages_read"]
            mu["writes"] += acct["pages_written"]
            for r in self.replicas:
                if not r.active:
                    continue
                bg_start = max(r.bg_free, t)
                r.bg_free = bg_start + us
                r.busy_us += us
                mu["io_us"] += us
                r.window.add_background(acct["read_pages"], rd_us)
                r.window.add_background(acct["written_pages"], wr_us)
                if tracer:
                    tracer.span(kind, "bg", bg_start, us, pid=r.rid,
                                track="background",
                                args={"pages_read": int(acct["pages_read"]),
                                      "pages_written":
                                          int(acct["pages_written"])})

        def maybe_migrate(now: float) -> None:
            mcfg = fcfg.migration
            if mcfg is None or now < mig["next"] or not self._sharded:
                return
            if any(r.active and r.mig_free > now for r in self.replicas):
                return      # one copy wave in flight at a time; retry
            mig["next"] = now + mcfg.every_us
            num_pages = self.index.layout.num_pages
            window = np.zeros(num_pages, np.int64)
            for r in self.replicas:
                if not r.active:
                    continue
                counts = profile_from_counters(r.store)[:num_pages]
                base = (r.mig_base if r.mig_base is not None
                        else np.zeros(0, np.int64))
                delta = counts.copy()
                delta[:len(base)] -= base[:len(delta)]
                window[:len(delta)] += np.maximum(delta, 0)
                r.mig_base = counts
            hot_ids = np.flatnonzero(window >= mcfg.min_reads)
            if len(hot_ids) == 0:
                return
            k = max(1, int(round(mcfg.hot_frac * num_pages)))
            order = hot_ids[np.argsort(window[hot_ids],
                                       kind="stable")[::-1]]
            target = np.zeros(num_pages, bool)
            target[order[:k]] = True
            S = scfg.shards
            moved = False
            for r in self.replicas:
                if not r.active:
                    continue
                cur = r.store.placement.replicated
                promote = np.flatnonzero(target & ~cur[:num_pages])
                if len(promote) > mcfg.max_moves:
                    # cap the copy volume per run: hottest first, the rest
                    # keep their current (non-replicated) routing
                    ranked = promote[np.argsort(window[promote],
                                                kind="stable")[::-1]]
                    keep = np.zeros(num_pages, bool)
                    keep[ranked[:mcfg.max_moves]] = True
                    mask = (cur[:num_pages] & target) | keep
                else:
                    mask = target
                delta = r.store.set_replicated(mask)
                promoted, demoted = delta["promoted"], delta["demoted"]
                if len(promoted) == 0 and len(demoted) == 0:
                    continue
                moved = True
                mig["promoted"] += len(promoted)
                mig["demoted"] += len(demoted)
                if len(promoted):
                    # copy I/O: read the home copy once, write S-1 replicas
                    io = len(promoted) * (rd_us + (S - 1) * wr_us)
                    mig["reads"] += len(promoted)
                    mig["writes"] += len(promoted) * (S - 1)
                    mig["io_us"] += io
                    mig_start = max(r.mig_free, now)
                    r.mig_free = mig_start + io
                    r.busy_us += io
                    if tracer:
                        tracer.span("migration", "bg", mig_start, io,
                                    pid=r.rid, track="migration",
                                    args={"promoted": len(promoted),
                                          "demoted": len(demoted)})
                    r.window.add_background(promoted, rd_us)
                    r.window.add_broadcast_writes(promoted, wr_us)
                    # the copy pulled the page's bytes through memory onto
                    # every shard — leave them RESIDENT there (non-demand
                    # admit, the prefetch path's API), so promotion warms
                    # the new shards' caches instead of starting them cold
                    caches = getattr(r.store, "caches", None)
                    if caches is not None:
                        for shard_cache in caches:
                            for p in promoted:
                                shard_cache.admit(int(p))
                # only DEMOTED pages have stale residency (their replica
                # copies cease to exist; a cached entry filled from one
                # points at a dead copy) — dropped through the mutable
                # store's versioned invalidate. A promoted page's home
                # copy never moved: its cached bytes stay valid, and the
                # new replica shards warm up organically.
                if len(demoted):
                    r.store.invalidate(demoted)
            if moved:
                mig["runs"] += 1
            self._mig_mask = target

        def maybe_autoscale(now: float) -> None:
            if asc is None or now < scale["next"]:
                return
            dt = now - scale["last_t"]
            scale["next"] = now + asc.check_every_us
            scale["last_t"] = now
            routable = self._routable()
            if dt <= 0 or not routable:
                return
            util = float(np.mean([
                (r.busy_us - r.busy_mark) / dt for r in routable]))
            for r in self.replicas:
                r.busy_mark = r.busy_us
            event = ""
            if util > asc.util_high and len(routable) < asc.max_groups:
                self._activate_group(now)
                scale["added"] += 1
                event = "add"
            elif util < asc.util_low and len(routable) > asc.min_groups:
                victim = min(routable, key=lambda r: r.free_at())
                victim.draining = True
                event = "drain"
            timeline.append((round(now, 1), len(self._routable()),
                             round(util, 4), event))

        def reap_drained(now: float) -> None:
            for r in self.replicas:
                if r.active and r.draining and r.free_at() <= now:
                    r.active = False       # drained: nothing in flight
                    scale["dropped"] += 1

        def ingest(j: int, executor_idle: bool = False) -> None:
            t = float(arr[j])
            if tracer:
                tracer.instant("arrival", "admission", t, pid=0, qid=j,
                               args={"kind": int(kinds[j])})
            if kinds[j] == 0:
                if budget_take(t):
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

        est_service: Optional[float] = None
        lat_out, stats_out, batch_sizes = [], [], []
        que_out: List[float] = []
        svc_out: List[float] = []
        int_out: List[float] = []
        qidx_out, tenant_out = [], []
        requested_total = issued_total = hits_total = 0
        overlap_w = 0.0
        degraded_n = 0
        t_end = 0.0

        i = 0
        mb = scfg.max_batch
        pend = ac.pending
        while i < n or pend:
            if not pend:
                idle = min(r.free_at() for r in self._routable()) \
                    <= float(arr[i])
                ingest(i, executor_idle=idle)
                i += 1
                continue
            t0 = pend[0][0]
            deadline = t0 + scfg.max_wait_us
            if scfg.slo_p99_us is not None:
                budget = scfg.slo_p99_us - (est_service or 0.0)
                deadline = min(deadline, t0 + max(budget, 0.0))
            while i < n and len(pend) < mb and arr[i] <= deadline:
                ingest(i)
                i += 1
            t_fill = pend[mb - 1][0] if len(pend) >= mb else np.inf
            routable = self._routable()
            earliest = min(r.free_at() for r in routable)
            exec_earliest = min(r.exec_free for r in routable)
            dispatch = max(earliest, min(deadline, t_fill), t0)
            # background-free counterfactual: when would this batch have
            # dispatched if every group's bg/migration clock were idle?
            # The gap between it and the real dispatch is the batch's
            # attributed interference (exec_earliest <= earliest and
            # rep.exec_free <= rep.free_at(), so nobg <= dispatch).
            nobg = max(exec_earliest, min(deadline, t_fill), t0)
            while i < n and arr[i] <= dispatch:
                ingest(i)
                i += 1
            # virtual-clock hooks run before the batch starts: migration
            # and scaling decisions are made on the state at dispatch time
            maybe_migrate(dispatch)
            maybe_autoscale(dispatch)
            reap_drained(dispatch)
            routable = self._routable()
            rep = self._route(routable)
            dispatch = max(dispatch, rep.free_at())
            nobg = max(nobg, rep.exec_free)
            level = ac.pressure_level()
            batch = ac.take_batch(mb)
            b_times = np.asarray([t for t, _, _ in batch])
            b_items = [it for _, it, _ in batch]
            b_tenants = np.asarray([tn for _, _, tn in batch], np.int64)
            stats = self._execute(queries[qidx[b_items]],
                                  self._level_cfg(level),
                                  collect=bool(tracer))
            stats.tenants = b_tenants
            lat, acct = self._batch_times_us(
                stats, len(batch), d, store=rep.store,
                lift=(rep.rid, len(self.replicas)))
            requested_total += acct["requested"]
            issued_total += acct["issued"]
            hits_total += acct["hits"]
            overlap_w += acct["overlap_frac"] * acct["issued"]
            rep.window.add(acct)
            rep.requested += acct["requested"]
            rep.issued += acct["issued"]
            rep.hits += acct["hits"]
            rep.busy_us += float(lat.max())     # executor occupancy
            rep.batches += 1
            rep.completed += len(batch)
            if level > 0:
                degraded_n += len(batch)
            done = dispatch + lat
            rep.exec_free = dispatch + float(lat.max())
            t_end = max(t_end, rep.exec_free)
            lat_out.extend((done - b_times).tolist())
            queue_b = np.maximum(nobg - b_times, 0.0)
            inter_b = (dispatch - b_times) - queue_b
            que_out.extend(queue_b.tolist())
            int_out.extend(inter_b.tolist())
            svc_out.extend(lat.tolist())
            if tracer:
                self._trace_batch(tracer, rep.rid, dispatch, lat, acct,
                                  stats, b_times, b_items, queue_b,
                                  inter_b, level, rd_us, d,
                                  store=rep.store)
            qidx_out.extend(qidx[b_items].tolist())
            tenant_out.extend(b_tenants.tolist())
            batch_sizes.append(len(batch))
            stats_out.append(stats)
            mean_lat = float(lat.mean())
            est_service = (mean_lat if est_service is None
                           else 0.5 * est_service + 0.5 * mean_lat)
            if compactor is not None:
                bg_run(compactor.after_batch(), rep.exec_free,
                       "compactions")

        reap_drained(np.inf)        # drain-before-drop bookkeeping only
        for r in self.replicas:
            # the run ends when the last device is quiet — background
            # migration/compaction I/O counts (same contract as the
            # single-server loop's mu["free"])
            t_end = max(t_end, r.bg_free, r.mig_free)
        completed = len(lat_out)
        shed_budget = bud["shed"]
        lat_arr = np.asarray(lat_out)
        per_tenant = (self._per_tenant_report(tenant_out, lat_arr, ac)
                      if multi_tenant else None)
        per_shard = {}
        for r in self.replicas:
            rows = r.window.report(t_end)
            if rows:
                for s, row in rows.items():
                    per_shard[f"r{r.rid}.s{s}"] = row
        per_replica = {r.rid: r.row(t_end) for r in self.replicas}
        mut_kw = {}
        if mm is not None:
            mut_kw = dict(
                inserts=mu["inserts"], deletes=mu["deletes"],
                flushes=mu["flushes"], compactions=mu["compactions"],
                bg_pages_read=mu["reads"], bg_pages_written=mu["writes"],
                bg_io_us=mu["io_us"],
                bg_util=mu["io_us"] / t_end if t_end > 0 else 0.0,
                overlap_ratio=self.index.overlap_ratio())
        que_arr = np.asarray(que_out, np.float64)
        svc_arr = np.asarray(svc_out, np.float64)
        int_arr = np.asarray(int_out, np.float64)
        # both report paths price latency columns off the same histogram
        # (empty histograms report the finite 0.0 default, schema intact)
        _, mean_lat_us, p50, p99 = _latency_summary(lat_arr)
        if completed == 0:
            all_stats = self._empty_open_report(
                rate_qps, duration_us, ac, per_tenant).stats
            mean_batch = pages_q = issued_q = 0.0
        else:
            all_stats = QueryStats.concat(stats_out)
            mean_batch = float(np.mean(batch_sizes))
            pages_q = float(all_stats.page_reads.mean())
            issued_q = issued_total / completed
        # REPRO_SANITIZE=1: every completed query's phases must sum back
        # to its reported latency (the fleet conservation contract)
        sanitize.check_attribution(que_arr, svc_arr, int_arr, lat_arr)
        slo = scfg.slo_p99_us
        report = FleetReport(
            rate_qps=rate_qps, duration_us=duration_us, offered=n_reads,
            completed=completed, elapsed_us=t_end,
            qps=completed / (t_end * 1e-6) if t_end > 0 else 0.0,
            mean_latency_us=mean_lat_us, p50_latency_us=p50,
            p99_latency_us=p99,
            mean_queue_us=float(que_arr.mean()) if completed else 0.0,
            mean_service_us=float(svc_arr.mean()) if completed else 0.0,
            mean_interference_us=(float(int_arr.mean())
                                  if completed else 0.0),
            attribution={"queue_us": que_arr, "service_us": svc_arr,
                         "interference_us": int_arr,
                         "latency_us": lat_arr.astype(np.float64)},
            mean_batch_size=mean_batch, pages_per_query=pages_q,
            issued_pages_per_query=issued_q,
            cache_hit_rate=(hits_total / requested_total
                            if requested_total else 0.0),
            overlap_frac=(overlap_w / issued_total
                          if issued_total else 0.0),
            slo_p99_us=slo,
            slo_violation_frac=(float(np.mean(lat_arr > slo))
                                if slo is not None and completed
                                else 0.0),
            measured_step_us=_measured_step(all_stats),
            stats=all_stats,
            query_indices=np.asarray(qidx_out, np.int64),
            offered_qps=n_reads / (duration_us * 1e-6),
            admitted=ac.admitted, shed=ac.shed + shed_budget,
            degraded=degraded_n,
            per_tenant=per_tenant,
            per_shard=per_shard or None,
            seed=run_seed,
            groups=self.fleet_cfg.replica_groups,
            groups_final=len(self._routable()),
            groups_added=scale["added"],
            groups_dropped=scale["dropped"],
            migrations=mig["runs"],
            promoted_pages=mig["promoted"],
            demoted_pages=mig["demoted"],
            mig_pages_read=mig["reads"],
            mig_pages_written=mig["writes"],
            mig_io_us=mig["io_us"],
            shed_budget=shed_budget,
            per_replica=per_replica,
            timeline=timeline or None,
            **mut_kw)
        # REPRO_SANITIZE=1: the fleet keeps the same admission conservation
        # as the single server (budget drops count as shed)
        sanitize.check_open_report(report)
        return report
