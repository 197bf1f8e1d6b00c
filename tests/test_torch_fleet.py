"""The port's `FleetServer` held against the live JAX package's.

On the tie-free fixture of tests/test_torch_search.py (every distance exact
in float32), the same fleet run goes through the reference's FleetServer
over the JAX DiskIndex and through the port's over the same index carried
across, with the same seed: the report rows must be equal column for
column (the measured `measured_step_us` aside), and so must the
per-replica, per-shard and per-tenant rows, the autoscale timeline, the
migration volume, every per-query search counter, the query order and the
per-query latency attribution. The runs are tests/test_fleet.py's: three
groups under least-work routing, round-robin routing, migration on, the
autoscale ramp, the replica budget, and a streaming fleet window over a
MutableIndex carried across by `mutable_from_reference`; then a traced
run's Chrome JSON, and the config validation of both packages.
"""
import numpy as np
import pytest
import torch
from test_torch_search import _reference_index, tie_free  # noqa: F401
from test_torch_serving import _assert_same_report, _strip

import repro.mutation as rm
import repro.obs as ro
import repro.serving as rsv
import repro_torch.mutation as pm
import repro_torch.obs as po
import repro_torch.serving as psv
from repro import sanitize as rs
from repro.core import PRESETS, get_preset
from repro_torch import sanitize as ps
from repro_torch.convert import (config_from_reference, index_from_reference,
                                 mutable_from_reference)

PKGS = {"ref": (rsv, rm, ro, rs), "port": (psv, pm, po, ps)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def indexes(tie_free):
    ref = _reference_index(tie_free, PRESETS["baseline"])
    return {"ref": ref, "port": index_from_reference(ref, "cpu"),
            "cfg": get_preset("baseline", L=32),
            "queries": tie_free[0].queries}


def _fleet(pkg, idx, cfg, groups=2, migration=None, autoscale=None,
           budget=0.0, routing="least-work", cache_pages=64, **scfg_kw):
    """tests/test_fleet.py's fleet: two shards, LRU of `cache_pages` pages,
    prefetch 1, batches of 8, in package `pkg`."""
    sv = PKGS[pkg][0]
    scfg = sv.ServerConfig(
        max_batch=8, shards=2, cache_policy="lru",
        cache_bytes=cache_pages * idx.layout.page_bytes, prefetch=1,
        **scfg_kw)
    if pkg == "port":
        cfg = config_from_reference(cfg)
    mig = None if migration is None else sv.MigrationConfig(**migration)
    asc = None if autoscale is None else sv.AutoscaleConfig(**autoscale)
    return sv.FleetServer(idx, cfg, server_cfg=scfg, fleet_cfg=sv.FleetConfig(
        replica_groups=groups, routing=routing, replica_budget_qps=budget,
        migration=mig, autoscale=asc))


RAMP = np.concatenate([np.linspace(0.0, 3_000.0, 400),
                       np.linspace(3_100.0, 30_000.0, 30)])

# name -> (fleet kwargs, serve_fleet kwargs)
RUNS = {
    "groups3-least-work": (dict(groups=3),
                           dict(rate_qps=100_000, duration_us=4_000,
                                seed=2)),
    "round-robin": (dict(groups=2, routing="round-robin"),
                    dict(rate_qps=100_000, duration_us=2_000, seed=2)),
    # a cache of 4 pages, so that the small index's pages are read often
    # enough to rank as hot
    "migration": (dict(groups=2, cache_pages=4,
                       migration=dict(every_us=400.0, hot_frac=0.2,
                                      max_moves=32)),
                  dict(rate_qps=50_000, duration_us=4_000, seed=4)),
    "autoscale-ramp": (dict(groups=1, autoscale=dict(
        check_every_us=500.0, util_high=0.6, util_low=0.2, min_groups=1,
        max_groups=4)),
        dict(rate_qps=10_000, duration_us=30_000.0, seed=2,
             arrivals=RAMP)),
    "budget": (dict(groups=2, budget=5_000.0),
               dict(rate_qps=100_000, duration_us=3_000, seed=2)),
}


def _assert_same_fleet(got, want):
    _assert_same_report(got, want)
    assert got.per_replica == want.per_replica
    assert got.timeline == want.timeline
    for f in ("groups", "groups_final", "groups_added", "groups_dropped",
              "migrations", "promoted_pages", "demoted_pages",
              "mig_pages_read", "mig_pages_written", "mig_io_us",
              "shed_budget"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", sorted(RUNS))
def test_fleet_rows_equal_the_reference(indexes, name):
    fkw, skw = RUNS[name]
    reps, srvs = {}, {}
    for pkg in ("ref", "port"):
        srvs[pkg] = _fleet(pkg, indexes[pkg], indexes["cfg"], **fkw)
        reps[pkg] = srvs[pkg].serve_fleet(indexes["queries"], **skw)
    _assert_same_fleet(reps["port"], reps["ref"])
    want = reps["ref"]
    assert want.completed > 0
    # each run exercises what it names
    if name == "migration":
        assert want.migrations >= 1 and want.promoted_pages > 0
        for a, b in zip(srvs["port"].replicas, srvs["ref"].replicas):
            np.testing.assert_array_equal(a.store.placement.replicated,
                                          b.store.placement.replicated)
    if name == "autoscale-ramp":
        events = [s[3] for s in want.timeline]
        assert "add" in events and "drain" in events
    if name == "budget":
        assert want.shed_budget > 0
    if name == "groups3-least-work":
        assert all(r["completed"] > 0 for r in want.per_replica.values())


def test_fleet_ids_equal_the_facade(indexes):
    """Routing across groups does not change a query's results
    (tests/test_fleet.py:74, on the port)."""
    fkw, skw = RUNS["groups3-least-work"]
    rep = _fleet("port", indexes["port"], indexes["cfg"],
                 **fkw).serve_fleet(indexes["queries"], **skw)
    want = indexes["port"].search(indexes["queries"],
                                  config_from_reference(indexes["cfg"]))
    np.testing.assert_array_equal(rep.stats.ids, want.ids[rep.query_indices])


def test_streaming_fleet_window_equals_the_reference(indexes):
    """A mutating fleet window over a MutableIndex, with the sanitizer
    armed: same rows, and both indexes end in the same state."""
    pool = np.random.default_rng(8).integers(0, 8, (96, 32)).astype(
        np.float32)
    ref_idx = rm.MutableIndex(indexes["ref"], rm.MutationConfig(
        flush_threshold=8, growth_chunk=64, insert_L=8, compaction_pages=8))
    idxs = {"ref": ref_idx, "port": mutable_from_reference(ref_idx, "cpu")}
    reps = {}
    for pkg in ("ref", "port"):
        _, mut, _, san = PKGS[pkg]
        mix = mut.MutationMix(insert_frac=0.2, delete_frac=0.1,
                              compaction="threshold", threshold=0.05,
                              max_pages=8)
        srv = _fleet(pkg, idxs[pkg], indexes["cfg"], groups=2,
                     cache_pages=4, migration=dict(every_us=400.0,
                                                   hot_frac=0.2,
                                                   max_moves=32))
        prev = san.set_enabled(True)
        try:
            reps[pkg] = srv.serve_fleet(indexes["queries"], rate_qps=30_000,
                                        duration_us=6_000, seed=9,
                                        mutation_mix=mix, insert_pool=pool)
        finally:
            san.set_enabled(prev)
        versions = [r.store.page_version.max() for r in srv.replicas]
        reps[pkg].versions = versions
    _assert_same_fleet(reps["port"], reps["ref"])
    want = reps["ref"]
    assert want.inserts > 0 and want.flushes > 0
    assert reps["port"].versions == want.versions
    for f in ("graph", "deleted", "vectors"):
        np.testing.assert_array_equal(getattr(idxs["port"], f),
                                      getattr(idxs["ref"], f))
    assert idxs["port"].free_pages == idxs["ref"].free_pages


def test_traced_fleet_chrome_json_equals_the_reference(indexes):
    docs, reps = {}, {}
    fkw, skw = RUNS["migration"]
    for pkg in ("ref", "port"):
        tracer = PKGS[pkg][2].Tracer()
        reps[pkg] = _fleet(pkg, indexes[pkg], indexes["cfg"],
                           **fkw).serve_fleet(indexes["queries"],
                                              tracer=tracer, **skw)
        docs[pkg] = tracer.to_chrome()
    _assert_same_fleet(reps["port"], reps["ref"])
    assert po.validate_chrome_trace(docs["port"]) == []
    assert _strip(docs["port"]) == _strip(docs["ref"])
    assert any(e.get("name") == "migration"
               for e in docs["port"]["traceEvents"])


# the config-validation cases of tests/test_fleet.py:36-70, each checked
# against both packages: (config class, kwargs, message)
INVALID = [
    ("FleetConfig", dict(replica_groups=0), "replica_groups=0"),
    ("FleetConfig", dict(routing="random"), "routing='random'"),
    ("FleetConfig", dict(replica_budget_qps=-1.0),
     "replica_budget_qps=-1.0"),
    ("FleetConfig", dict(migration=3), "must be a MigrationConfig"),
    ("FleetConfig", dict(autoscale="yes"), "must be an AutoscaleConfig"),
    ("FleetConfig", dict(replica_groups=9, autoscale=4), "above"),
    ("MigrationConfig", dict(every_us=0), "every_us=0"),
    ("MigrationConfig", dict(hot_frac=1.5), "hot_frac=1.5"),
    ("MigrationConfig", dict(max_moves=0), "max_moves=0"),
    ("MigrationConfig", dict(min_reads=0), "min_reads=0"),
    ("AutoscaleConfig", dict(check_every_us=0), "check_every_us=0"),
    ("AutoscaleConfig", dict(util_low=0.8, util_high=0.5),
     "hysteresis band"),
    ("AutoscaleConfig", dict(min_groups=0), "min_groups=0"),
    ("AutoscaleConfig", dict(min_groups=2, max_groups=1),
     "max_groups=1 < min_groups=2"),
]


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("cls,kw,msg", INVALID,
                         ids=[f"{c}-{m}" for c, _, m in INVALID])
def test_fleet_configs_reject_invalid(pkg, cls, kw, msg):
    sv = PKGS[pkg][0]
    kw = dict(kw)
    if isinstance(kw.get("autoscale"), int):    # max_groups for "above"
        kw["autoscale"] = sv.AutoscaleConfig(max_groups=kw["autoscale"])
    with pytest.raises(ValueError, match=msg):
        getattr(sv, cls)(**kw)
