"""Records longer than a page (core/pages.py): DiskANN's multi-sector node
layout, the builder's skip of page shuffle at one record a page, reads
priced at the layout's page, and a GIST-shaped search (960-d float32,
R = 64: 4,100 B a record, two 4 KB sectors) held against the benchmark's
plain reference (bench/reference/search.py through bench/check.py)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.pages import build_layout as jax_layout
from repro_torch.core.builder import build_index
from repro_torch.core.dataset import make_dataset
from repro_torch.core.device_model import SSDModel
from repro_torch.core.pages import build_layout
from repro_torch.core.presets import get_preset
from repro_torch.obs import Tracer
from repro_torch.serving.ann_server import AnnServer

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

GIST = "gist1m-octopusann"
SECTOR = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _diskann(d: int, vec_bytes: int, R: int, sector: int, n: int) -> dict:
    """DiskANN's disk arithmetic (PQFlashIndex): a node is the vector, its
    degree and R ids; nodes that fit share a sector, a longer node takes
    ceil(node / sector) sectors to itself."""
    node = d * vec_bytes + 4 + 4 * R
    per_sector = sector // node
    if per_sector > 0:
        n_p, sectors = per_sector, 1
    else:
        n_p, sectors = 1, (node + sector - 1) // sector
    pages = (n + n_p - 1) // n_p
    return {"record_bytes": node, "n_p": n_p, "sectors_per_page": sectors,
            "page_bytes": sectors * sector, "disk_bytes": pages * sectors
            * sector, "num_pages": pages}


@pytest.mark.parametrize("d, vec_bytes, R, sector", [
    (960, 4, 64, 4096),     # GIST1M at R = 64: 4,100 B, two sectors
    (960, 4, 16, 4096),     # the tiny bench cells' R = 16: 3,908 B fits
    (960, 4, 64, 8192),     # an 8 KB sector holds the same record
    (2000, 4, 64, 4096),    # 8,260 B: three sectors
    (96, 4, 64, 4096),      # DEEP1M: six records a page
    (128, 1, 64, 4096),     # SIFT1M: ten
    (16, 4, 8, 64),         # 100 B against 64 B: two sectors
])
def test_layout_follows_diskann_sectors(d, vec_bytes, R, sector):
    n = 37
    rng = np.random.default_rng(d + R)
    x = rng.normal(size=(n, d)).astype(np.float32)
    g = rng.integers(-1, n, (n, R)).astype(np.int32)
    want = _diskann(d, vec_bytes, R, sector, n)
    got = build_layout(x, g, page_bytes=sector, vec_bytes_per_dim=vec_bytes)
    for f, v in want.items():
        assert getattr(got, f) == v, f
    ref = jax_layout(x, g, page_bytes=sector, vec_bytes_per_dim=vec_bytes)
    for f in ("n_p", "num_pages", "record_bytes", "mapping_bytes"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("vid2page", "vid2slot", "page_vids", "page_vecs", "page_nbrs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    # the JAX package departs only where a record outgrows its sector
    fits = want["sectors_per_page"] == 1
    assert (got.page_bytes == ref.page_bytes) == fits
    assert (got.disk_bytes == ref.disk_bytes) == fits


@pytest.fixture(scope="module")
def gist_small():
    """A 960-d index of 300 vectors at R = 64 on a random graph (the
    layout, builder and device model read no graph quality)."""
    ds = make_dataset("gist-like", n=300, nq=8, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    g = rng.integers(0, ds.n, (ds.n, 64)).astype(np.int32)
    g[g == np.arange(ds.n)[:, None]] = -1
    return ds, g


@pytest.mark.parametrize("shuffle", [True, False])
def test_one_record_a_page_skips_the_shuffle(gist_small, shuffle):
    ds, g = gist_small
    cfg = get_preset("baseline", page_shuffle=shuffle)
    idx = build_index(ds, cfg, R=64, graph=g, medoid_id=0, device="cpu")
    lay, st = idx.layout, idx.build_stats
    assert (lay.n_p, lay.sectors_per_page, lay.page_bytes) == (1, 2, 8192)
    assert st["page_shuffle_skipped"] is shuffle
    assert st["sectors_per_page"] == 2 and st["disk_bytes"] == 300 * 8192
    assert lay.mapping_bytes == 0 and "shuffle_s" not in st
    np.testing.assert_array_equal(lay.page_vids[:, 0], np.arange(ds.n))


def test_shuffle_still_runs_where_pages_hold_several():
    ds = make_dataset("deep-like", n=300, nq=8, seed=3, device="cpu")
    g = np.random.default_rng(3).integers(0, ds.n, (ds.n, 16)).astype(
        np.int32)
    idx = build_index(ds, get_preset("octopusann"), R=16, graph=g,
                      medoid_id=0, device="cpu")
    st = idx.build_stats
    assert idx.layout.n_p > 1 and st["page_shuffle_skipped"] is False
    assert idx.layout.mapping_bytes == 8 * ds.n and "shuffle_s" in st


def test_modelled_reads_take_the_8k_rate(gist_small):
    """A GIST node read is priced at SSDModel._rates' middle point (8 KB),
    by QueryStats.summary's caller and by the server."""
    ds, g = gist_small
    cfg = get_preset("diskann")
    idx = build_index(ds, cfg, R=64, graph=g, medoid_id=0, device="cpu")
    model = SSDModel()
    pb = idx.layout.page_bytes
    assert pb == 8192 and model._rates(pb) == (
        (model.iops_4k + model.iops_16k) / 2, (model.bw_4k + model.bw_16k) / 2)
    assert model.read_service_us(pb) > model.read_service_us(SECTOR)
    srv = AnnServer(idx, model=model)
    assert srv._shard_window().page_bytes == pb
    stats = srv._execute(ds.queries)
    lat, acct = srv._batch_times_us(stats, 4, ds.d)
    dedup = acct["issued"] / acct["requested"]
    kw = dict(hops=stats.hops.astype(np.float64),
              pages=stats.visited_pages.sum(axis=1).astype(np.float64),
              full_evals=stats.full_evals.astype(np.float64),
              pq_evals=stats.pq_evals.astype(np.float64),
              mem_evals=stats.mem_evals.astype(np.float64),
              d=ds.d, pq_m=cfg.pq_m, page_dedup=dedup)
    np.testing.assert_allclose(
        lat, model.concurrent_latency_us(4, page_bytes=pb, **kw))
    assert np.all(lat > model.concurrent_latency_us(4, page_bytes=SECTOR,
                                                    **kw))


def _knn_graph(x: np.ndarray, R: int) -> np.ndarray:
    """Each vector's R nearest others: a graph the search can walk, built
    in a second where Vamana at 960-d takes minutes on the CPU."""
    sq = np.sum(x * x, 1)
    d = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    np.fill_diagonal(d, np.inf)
    return np.argsort(d, axis=1, kind="stable")[:, :R].astype(np.int32)


def test_gist_search_matches_the_reference():
    """DiskIndex.search on a 2,000-vector gist-like index (the benchmark's
    data and search configuration, R = 64) against the plain reference:
    ids, distances, hops, page reads and MemGraph hops; each read is two
    sectors in the call's span."""
    from bench import check, data, harness
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.engine import SearchConfig
    from repro_torch.core.vamana import medoid
    config = json.loads((ROOT / "bench" / "configs" /
                         f"{GIST}.json").read_text())
    config["n"] = 2000
    R = config["vamana"]["R"]
    assert (R, config["search"]["page_bytes"]) == (64, SECTOR)
    cfg = SearchConfig(**config["search"])
    x, model = data.make_base(config["dataset"], config["n"],
                              config["data_seed"])
    ds = Dataset(config["dataset"], x, x[:0], np.zeros((0, 10), np.int32),
                 "float")
    index = build_index(ds, cfg, R=R, graph=_knn_graph(x, R),
                        medoid_id=medoid(x), seed=config["build_seed"],
                        device="cpu")
    lay = index.layout
    assert (lay.n_p, lay.sectors_per_page, lay.page_bytes,
            lay.record_bytes) == (1, 2, 8192, config["record_bytes"])
    assert lay.disk_bytes == 2000 * 8192 and lay.mapping_bytes == 0
    queries = model.queries(11, 40)
    tracer = Tracer(clock="host")
    st = index.search(queries, cfg, batch=16, tracer=tracer)
    rows = np.arange(len(queries))
    ans = {"rows": rows, "ids": st.ids, "dists": st.dists}
    ans.update({c: getattr(st, c) for c in check.COUNTS})
    prog = harness.program_arrays(index, config)
    rx = check.ref_index(x, prog, config)
    assert check.compare_sample(rx, config["search"], queries, ans, rows) \
        == {"id_mismatch": 0.0, "count_mismatch": 0.0}
    assert check.start_mismatch(rx, prog) == 0
    assert check.codebook_gap(rx, prog) == 0.0
    assert check.dist_err_max(x, queries, st.ids, st.dists) \
        <= config["limits"]["dist_err_max"]
    assert st.mem_hops.min() > 0 and st.page_reads.min() > 0
    call = tracer.spans[0].args
    assert call["page_bytes"] == 8192 and call["sectors_per_page"] == 2
    assert call["sectors_read"] == 2 * int(st.page_reads.sum())
