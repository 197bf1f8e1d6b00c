"""The port's mutation and durability layer held against the live JAX
package (src/repro/mutation/).

On the tie-free fixture of tests/test_torch_search.py (integer vectors,
queries and PQ centroids, so every distance is exact in float32), the same
op script — integer inserts, deletes (no-ops among them), flushes and
compactions — runs on the reference's MutableIndex over the JAX DiskIndex
and on the port's over the same index carried across: after every flush
and compaction the whole mutable state, the attached store's counters and
every search counter must be equal bit for bit.

On the durability fixture of tests/test_durability.py (deep-like, n = 256):
the two packages' journals are equal byte for byte, a journal the reference
wrote recovers in the port to the reference's state, a reference index's
state carries across through `mutable_from_reference`, and the port's own
kill / recover / resume sweep is bit-identical to its uninterrupted run.
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_search import COUNTERS, _reference_index, tie_free  # noqa: F401

import repro.mutation as rm
import repro_torch.mutation as pm
from repro.core import PRESETS, build_index, get_preset, make_dataset
from repro.core.vamana import build_vamana as jax_build_vamana
from repro_torch.convert import (config_from_reference, index_from_reference,
                                 mutable_from_reference)

MCFG = dict(flush_threshold=8, growth_chunk=64, insert_L=8)
GC = 4   # the durability sweep's group commit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mcfg(pkg):
    return pkg.MutationConfig(**MCFG)


def _tie_free_script(d, n_ops=60, seed=5):
    """Integer inserts (exact distances), deletes of disk vids, of fresh
    delta vids, of vids already deleted or out of range (no-ops), and
    flushes and compactions among them."""
    rng = np.random.default_rng(seed)
    ops, next_vid = [], 1024
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45:
            ops.append(("insert",
                        rng.integers(0, 8, d).astype(np.float32)))
            next_vid += 1
        elif r < 0.70:
            ops.append(("delete", int(rng.integers(next_vid + 4))))
        elif r < 0.75:
            ops.append(("delete", -1 if rng.random() < 0.5 else 10**6))
        elif r < 0.88:
            ops.append(("flush",))
        else:
            ops.append(("compact", int(rng.integers(1, 6))))
    ops += [("flush",), ("compact", 64)]
    return ops


def _do(idx, op):
    if op[0] == "insert":
        return idx.insert(op[1])
    if op[0] == "delete":
        return idx.delete(op[1])
    if op[0] == "flush":
        return idx.flush()
    return idx.compact(op[1])


def _assert_same_state(got, want, where):
    lay_g, lay_w = got.layout, want.layout
    for f in ("page_vids", "page_vecs", "page_nbrs", "vid2page", "vid2slot"):
        np.testing.assert_array_equal(getattr(lay_g, f), getattr(lay_w, f),
                                      err_msg=f"{where}: layout.{f}")
    assert lay_g.num_pages == lay_w.num_pages, where
    for f in ("graph", "vectors", "deleted", "cached"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{where}: {f}")
    np.testing.assert_array_equal(got.pq.codes, want.pq.codes,
                                  err_msg=f"{where}: codes")
    assert got.free_pages == want.free_pages, where
    assert got.dirty_pages == want.dirty_pages, where
    assert got.append_pages == want.append_pages, where
    assert got.pending_tombstones == want.pending_tombstones, where
    for f in ("n_disk", "next_vid", "medoid", "flushes", "compactions",
              "ops_applied"):
        assert getattr(got, f) == getattr(want, f), (where, f)
    assert got.overlap_ratio() == want.overlap_ratio(), where
    assert got._rev == want._rev, where


def _assert_same_search(got, want, queries, cfg, where):
    w = want.search(queries, cfg)
    g = got.search(queries, config_from_reference(cfg))
    for f in COUNTERS:
        a, b = getattr(g, f), getattr(w, f)
        assert a.dtype == b.dtype, (where, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {f}")


@pytest.mark.parametrize("preset", ["baseline", "pagesearch"])
def test_op_script_bit_identical_on_tie_free_fixture(tie_free, preset):
    cfg = PRESETS[preset]
    ref_base = _reference_index(tie_free, cfg)
    want = rm.MutableIndex(ref_base, _mcfg(rm))
    got = pm.MutableIndex(index_from_reference(ref_base, "cpu"), _mcfg(pm))
    assert got._rev == want._rev
    queries = tie_free[0].queries
    ref_store, port_store = want.page_store(), got.page_store()
    script = _tie_free_script(ref_base.layout.page_vecs.shape[-1])
    checked = 0
    for i, op in enumerate(script):
        w, g = _do(want, op), _do(got, op)
        where = f"op {i} {op[0]}"
        if op[0] in ("insert", "delete"):
            assert g == w, where
            continue
        assert g.keys() == w.keys(), where
        for key in w:
            np.testing.assert_array_equal(g[key], w[key],
                                          err_msg=f"{where}: {key}")
        _assert_same_state(got, want, where)
        _assert_same_search(got, want, queries, cfg, where)
        assert port_store.counters.as_dict() == ref_store.counters.as_dict()
        assert (port_store.page_version == ref_store.page_version).all()
        checked += 1
    assert want.flushes >= 3 and want.compactions >= 3 and checked > 6


def test_device_mirrors_follow_the_host_state(tie_free):
    """The port's wiring search reads device mirrors of `vectors` and
    `graph`; after flushes, compactions and a restore they equal the host
    arrays they mirror."""
    ref_base = _reference_index(tie_free, PRESETS["baseline"])
    idx = pm.MutableIndex(index_from_reference(ref_base, "cpu"), _mcfg(pm))
    script = _tie_free_script(32, seed=9)
    snap = None
    for i, op in enumerate(script):
        _do(idx, op)
        if i == len(script) // 2:
            snap = idx.snapshot()
        if idx._dev_vectors is not None:
            np.testing.assert_array_equal(idx._dev_vectors.numpy(),
                                          idx.vectors)
            np.testing.assert_array_equal(idx._dev_graph.numpy(),
                                          idx.graph.astype(np.int64))
    assert idx._dev_vectors is not None
    idx.restore(snap)
    assert idx._dev_vectors is None
    idx.flush()
    idx.insert(np.ones(32, np.float32))
    idx.flush()
    np.testing.assert_array_equal(idx._dev_graph.numpy(),
                                  idx.graph.astype(np.int64))


def test_compaction_drops_the_stale_code_tile(tie_free):
    """A compaction rewrites pages in place; the page kernels' code tile
    memoized on the store must follow it."""
    from repro_torch.core.search_kernel import _page_codes
    ref_base = _reference_index(tie_free, PRESETS["baseline"])
    idx = pm.MutableIndex(index_from_reference(ref_base, "cpu"), _mcfg(pm))
    store = idx.page_store()
    rng = np.random.default_rng(3)
    for _ in range(20):
        idx.insert(rng.integers(0, 8, 32).astype(np.float32))
    idx.flush()
    for v in range(0, 40, 3):
        idx.delete(v)
    _page_codes(store, idx.pq)
    assert idx.compact(64)["compacted_pages"] > 0
    tile = _page_codes(store, idx.pq).numpy()
    vids = idx.layout.page_vids
    want = idx.pq.codes[np.clip(vids, 0, None)]
    want[vids < 0] = 0
    np.testing.assert_array_equal(tile, want)


def test_build_store_mutable_journal_and_crash():
    """build_store(mutable=, journal=, crash=) wraps the stack as the
    reference does, with the same refusal of journal=/crash= alone."""
    from repro.core.pages import build_layout
    from repro.io import build_store as ref_build_store
    from repro_torch.io import build_store
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    g = rng.integers(0, 64, (64, 4)).astype(np.int32)
    lay = build_layout(x, g, page_bytes=256)
    for kw in (dict(mutable=True), dict(mutable=True, batched=True,
                                        cache_policy="lru", cache_bytes=1024),
               dict(mutable=True, shards=2)):
        st = build_store(lay, device="cpu", **kw)
        assert isinstance(st, pm.MutablePageStore)
        assert type(st.inner).__name__ == type(
            ref_build_store(lay, **kw).inner).__name__
    j, cp = pm.MutationJournal(), pm.CrashPoint(kill_at=2)
    st = build_store(lay, device="cpu", mutable=True, journal=j, crash=cp)
    st.note_write([1])
    with pytest.raises(pm.CrashError):
        st.note_write([2, 3])
    assert [k for _, k, _ in j.replay()] == ["intent", "intent"]
    for kw in (dict(journal=pm.MutationJournal()),
               dict(crash=pm.CrashPoint())):
        with pytest.raises(ValueError) as e_port:
            build_store(lay, device="cpu", **kw)
        with pytest.raises(ValueError) as e_ref:
            ref_build_store(lay, **kw)
        assert str(e_port.value) == str(e_ref.value)


# -- the durability fixture ---------------------------------------------------


def _script(d, n_ops=40, seed=17):
    """tests/test_durability.py's op trace."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.50:
            ops.append(("insert", rng.normal(size=d).astype(np.float32)))
        elif r < 0.75:
            ops.append(("delete", int(rng.integers(300))))
        elif r < 0.90:
            ops.append(("flush",))
        else:
            ops.append(("compact", 4))
    return ops


def _apply(idx, script, start=0):
    for op in script[start:]:
        _do(idx, op)


def _state(idx, queries):
    st = idx.search(queries)
    return {"ids": np.asarray(st.ids).copy(),
            "dists": np.asarray(st.dists).copy(),
            "tombstones": set(idx.pending_tombstones),
            "free": list(idx.free_pages),
            "dirty": set(idx.dirty_pages),
            "n_disk": idx.n_disk, "next_vid": idx.next_vid,
            "delta": len(idx.delta), "ops": idx.ops_applied,
            "overlap": idx.overlap_ratio()}


def _assert_identical(got, ref):
    assert np.array_equal(got["ids"], ref["ids"])
    assert np.array_equal(got["dists"], ref["dists"])
    for key in ("tombstones", "free", "dirty", "n_disk", "next_vid",
                "delta", "ops", "overlap"):
        assert got[key] == ref[key], key


@dataclasses.dataclass
class Harness:
    ref_base: object     # the JAX DiskIndex
    base: object         # the port's DiskIndex over the same arrays
    script: list
    queries: np.ndarray
    ref_live: object     # the reference's durable run, finished
    ref_journal: object
    port: dict           # final state of the port's uninterrupted run
    boundaries: int      # killable I/O boundaries of the port's durable run


@pytest.fixture(scope="module")
def dur():
    ds = make_dataset("deep-like", n=256, nq=8, seed=11)
    G, med, _ = jax_build_vamana(ds.vectors, R=8, L=16, batch=128, seed=11)
    ref_base = build_index(ds, get_preset("baseline"), graph=G,
                           medoid_id=med)
    base = index_from_reference(ref_base, "cpu")
    script = _script(ref_base.layout.page_vecs.shape[-1])
    rj = rm.MutationJournal(rm.JournalConfig(GC))
    ref_live = rm.MutableIndex(ref_base, _mcfg(rm), journal=rj)
    _apply(ref_live, script)
    plain = pm.MutableIndex(base, _mcfg(pm))
    _apply(plain, script)
    port = _state(plain, ds.queries)
    cp = pm.CrashPoint()
    durable = pm.MutableIndex(base, _mcfg(pm),
                              journal=pm.MutationJournal(pm.JournalConfig(GC)),
                              crash=cp)
    _apply(durable, script)
    _assert_identical(_state(durable, ds.queries), port)
    assert cp.boundaries > len(script) // 4
    return Harness(ref_base, base, script, ds.queries, ref_live, rj, port,
                   cp.boundaries)


def _records_equal(a, b):
    assert len(a) == len(b)
    for (sa, ka, pa), (sb, kb, pb) in zip(a, b):
        assert (sa, ka) == (sb, kb)
        if isinstance(pa, np.ndarray):
            assert isinstance(pb, np.ndarray) and pa.dtype == pb.dtype
            np.testing.assert_array_equal(pa, pb)
        else:
            assert pa == pb


def test_journal_records_equal_the_reference(dur):
    pj = pm.MutationJournal(pm.JournalConfig(GC))
    idx = pm.MutableIndex(dur.base, _mcfg(pm), journal=pj)
    _apply(idx, dur.script)
    _records_equal(pj.replay(), dur.ref_journal.replay())
    assert bytes(pj._log) == bytes(dur.ref_journal._log)
    assert (pj.seq, pj.commits, pj.pages_written) == (
        dur.ref_journal.seq, dur.ref_journal.commits,
        dur.ref_journal.pages_written)


def test_port_recovers_a_journal_the_reference_wrote(dur):
    """The reference's durable medium, replayed by the port's `recover`,
    gives the reference's final state; and the other way round."""
    pj = pm.MutationJournal(pm.JournalConfig(GC))
    pj._log = bytearray(dur.ref_journal._log)
    rec = pm.recover(dur.base, pj, _mcfg(pm))
    # the reference's buffered tail died with it: replay the same prefix
    want = rm.recover(dur.ref_base, dur.ref_journal, _mcfg(rm))
    _assert_same_state(rec, want, "recovered")
    assert rec.last_recovery_us == want.last_recovery_us
    ids_w = want.search(dur.queries)
    ids_g = rec.search(dur.queries)
    np.testing.assert_array_equal(ids_g.ids, ids_w.ids)
    np.testing.assert_allclose(ids_g.dists, ids_w.dists, rtol=1e-6)
    # and a port-written journal recovers in the reference
    idx = pm.MutableIndex(dur.base, _mcfg(pm), journal=pj)
    _apply(idx, dur.script[:25])
    rj = rm.MutationJournal(rm.JournalConfig(GC))
    rj._log = bytearray(pj._log)
    _assert_same_state(pm.recover(dur.base, pj, _mcfg(pm)),
                       rm.recover(dur.ref_base, rj, _mcfg(rm)), "port log")


def test_mutable_from_reference_carries_the_state(dur):
    got = mutable_from_reference(dur.ref_live, "cpu")
    _assert_same_state(got, dur.ref_live, "live")
    assert got.journal is None and got.device.type == "cpu"
    # a snapshot taken mid-script carries across too, and both resume alike
    ref = rm.MutableIndex(dur.ref_base, _mcfg(rm))
    _apply(ref, dur.script[:20])
    snap = ref.snapshot()
    port = pm.MutableIndex(dur.base, _mcfg(pm))
    port.restore(snap)
    _assert_same_state(port, ref, "snapshot")
    _apply(ref, dur.script, 20)
    _apply(port, dur.script, 20)
    _assert_same_state(port, ref, "resumed")


def _kill_recover_resume(dur, k):
    j = pm.MutationJournal(pm.JournalConfig(GC))
    idx = pm.MutableIndex(dur.base, _mcfg(pm), journal=j,
                          crash=pm.CrashPoint(kill_at=k))
    with pytest.raises(pm.CrashError):
        _apply(idx, dur.script)
    rec = pm.recover(dur.base, j, _mcfg(pm))
    assert rec.ops_applied <= len(dur.script)
    assert rec.last_recovery_us > 0
    _apply(rec, dur.script, rec.ops_applied)
    return _state(rec, dur.queries)


def _sample(boundaries):
    picks = {1, boundaries // 4, boundaries // 2, 3 * boundaries // 4,
             boundaries - 1, boundaries}
    return sorted(p for p in picks if p >= 1)


def test_crash_recover_resume_sampled(dur):
    for k in _sample(dur.boundaries):
        _assert_identical(_kill_recover_resume(dur, k), dur.port)


@pytest.mark.slow
def test_crash_recover_resume_every_boundary(dur):
    for k in range(1, dur.boundaries + 1):
        _assert_identical(_kill_recover_resume(dur, k), dur.port)


def test_snapshot_seeds_recovery(dur):
    j = pm.MutationJournal(pm.JournalConfig(GC))
    idx = pm.MutableIndex(dur.base, _mcfg(pm), journal=j)
    _apply(idx, dur.script[:20])
    snap = idx.snapshot()
    assert j.log_bytes == 0 and snap["ops_applied"] == 20
    _apply(idx, dur.script, 20)
    _assert_identical(_state(idx, dur.queries), dur.port)
    rec = pm.recover(dur.base, j, _mcfg(pm), snapshot=snap)
    _apply(rec, dur.script, rec.ops_applied)
    _assert_identical(_state(rec, dur.queries), dur.port)


def test_rev_matches_the_reference_construction(dur):
    """The port builds the reverse adjacency from one sort by target; its
    sets equal the reference's edge-by-edge construction."""
    got = pm.MutableIndex(dur.base, _mcfg(pm))
    want = rm.MutableIndex(dur.ref_base, _mcfg(rm))
    assert got._rev == want._rev
    assert sum(map(len, got._rev)) <= int((dur.base.graph >= 0).sum())
