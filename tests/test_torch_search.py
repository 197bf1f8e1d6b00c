"""The port's search held against the live JAX package (the parity contract
of ROADMAP.md A4), on the same index carried across by
`repro_torch.convert.index_from_reference`.

(a) On a tie-free fixture, whose vectors, queries and PQ centroids are small
    integers so that every distance in the search is exact in float32, the
    port's `ids`, `dists`, `hops`, `page_reads` and `cache_hits` (and every
    other counter) equal the JAX output bit for bit, for every preset.
(b) On the conftest fixture (deep-like, n=2048), where sums taken in
    another order may move a distance by an ulp: at least 63 of 64 query
    rows have identical ids, dists agree to rtol 1e-6 where the ids agree,
    and mean page_reads and mean hops are each within 3%.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PRESETS, get_preset, recall_at_k
from repro.core.cache import sssp_cache
from repro.core.dataset import Dataset
from repro.core.engine import DiskIndex as JaxDiskIndex
from repro.core.memgraph import MemGraph as JaxMemGraph
from repro.core.page_shuffle import shuffle_order
from repro.core.pages import build_layout, records_per_page
from repro.core.pq import PQ as JaxPQ
from repro.core.pq import encode as jax_encode
from repro.core.search_kernel import query_luts as jax_query_luts
from repro_torch.convert import config_from_reference, index_from_reference
from repro_torch.core.builder import build_index
from repro_torch.core.dataset import Dataset as PortDataset
from repro_torch.core.engine import SearchConfig
from repro_torch.core.memgraph import build_memgraph
from repro_torch.core.search_kernel import measure_step_us, query_luts
from repro_torch.core.vamana import build_vamana


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast, and the
    test workers sharing a few cores do not oversubscribe them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

COUNTERS = ("ids", "dists", "hops", "page_reads", "cache_hits",
            "n_read_records", "n_eff", "full_evals", "pq_evals", "mem_hops",
            "mem_evals")


@pytest.fixture(scope="module")
def tie_free():
    """Integer data 0..7 in 32 dims and integer PQ centroids; the graph and
    the MemGraph's graph come from the port's builder (any graph will do:
    both packages search the same one)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 8, (1024, 32)).astype(np.float32)
    q = rng.integers(0, 8, (32, 32)).astype(np.float32)
    ds = Dataset("tie-free", x, q, np.zeros((32, 10), np.int32), "float")
    graph, med, _ = build_vamana(x, R=16, L=32, batch=256, seed=0,
                                 device="cpu")
    cent = rng.integers(0, 8, (16, 256, 2)).astype(np.float32)
    pq = JaxPQ(centroids=cent, codes=jax_encode(x, cent), m=16, dsub=2)
    mg = build_memgraph(x, frac=0.01, seed=0, device="cpu")
    memgraph = JaxMemGraph(sample_ids=mg.sample_ids, vectors=mg.vectors,
                           graph=mg.graph, medoid=mg.medoid, build_s=0.0)
    return ds, graph, med, pq, memgraph


def _reference_index(fixture, cfg):
    """The JAX DiskIndex a build of `cfg` would give, from the fixture's
    graph, PQ and MemGraph (layout, shuffle and cache by the reference's
    own numpy builders)."""
    ds, graph, med, pq, memgraph = fixture
    n_p, _ = records_per_page(cfg.page_bytes, ds.d, 4, graph.shape[1],
                              cfg.all_in_storage, cfg.pq_m)
    perm = (shuffle_order(graph, med, n_p)["perm"] if cfg.page_shuffle
            else None)
    layout = build_layout(ds.vectors, graph, page_bytes=cfg.page_bytes,
                          perm=perm, all_in_storage=cfg.all_in_storage,
                          pq_m=cfg.pq_m)
    cached = (sssp_cache(graph, med, cfg.cache_frac) if cfg.cache_frac > 0
              else None)
    return JaxDiskIndex(layout, pq, graph, med, cfg,
                        memgraph=memgraph if cfg.memgraph_frac > 0 else None,
                        cached=cached)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bit_identical_on_tie_free_fixture(tie_free, preset):
    cfg = PRESETS[preset]
    ref_idx = _reference_index(tie_free, cfg)
    queries = tie_free[0].queries
    want = ref_idx.search(queries, cfg)
    got = index_from_reference(ref_idx, "cpu").search(
        queries, config_from_reference(cfg))
    assert want.page_reads.sum() > 0
    for field in COUNTERS:
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("preset", ["baseline", "pagesearch", "dynamicwidth",
                                    "pipeline"])
def test_tolerance_on_conftest_fixture(base_index, small_dataset, preset):
    cfg = get_preset(preset)
    q = small_dataset.queries
    want = base_index.search(q, cfg)
    got = index_from_reference(base_index, "cpu").search(
        q, config_from_reference(cfg))
    same = np.all(got.ids == want.ids, axis=1)
    assert same.sum() >= 63, f"{same.sum()}/64 rows identical"
    np.testing.assert_allclose(got.dists[same], want.dists[same], rtol=1e-6)
    for field in ("page_reads", "hops"):
        w = float(getattr(want, field).mean())
        g = float(getattr(got, field).mean())
        assert abs(g - w) <= 0.03 * w, (field, g, w)


def test_fused_pipeline_changes_only_the_clock(base_index, small_dataset):
    """pipeline="fused" gives the results of pipeline=True, plus a
    measured step time per query (here from the plain versions)."""
    idx = index_from_reference(base_index, "cpu")
    cfg = config_from_reference(get_preset("pipeline", L=32))
    q = small_dataset.queries[:12]
    a = idx.search(q, cfg)
    b = idx.search(q, cfg.replace(pipeline="fused"), batch=5)
    for field in ("ids", "dists", "page_reads", "hops"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.measured_step_us is None
    assert b.measured_step_us.shape == (12,)
    assert b.measured_step_us[b.page_reads > 0].min() > 0
    assert b.page_trace.shape[0] == 12


def test_query_luts_are_the_reference_luts_in_kernel_layout(base_index,
                                                            small_dataset):
    """The port lays the fused schedule's LUTs out (M, 256, Q), as its page
    kernels read them; the values are the reference's (Q, M, 256) ones."""
    cent = np.asarray(base_index.pq.centroids, np.float32)
    q = small_dataset.queries[:8]
    want = np.asarray(jax_query_luts(jnp.asarray(cent), jnp.asarray(q)))
    got = query_luts(torch.as_tensor(cent), torch.as_tensor(q)).numpy()
    assert got.shape == (cent.shape[0], 256, 8)
    np.testing.assert_allclose(got, want.transpose(1, 2, 0), rtol=1e-6,
                               atol=1e-6)


def test_measured_schedule_is_range_checked_on_the_host(base_index,
                                                        small_dataset):
    """measure_step_us checks its schedule's page ids on the host, so the
    timed kernel call needs no device round trip for it."""
    idx = index_from_reference(base_index, "cpu")
    store = idx.page_store(use_cache=False)
    trace = np.full((1, 2, 3), -1, np.int32)
    trace[0, 1, 0] = store.layout.num_pages
    with pytest.raises(IndexError, match="outside"):
        measure_step_us(store, idx.pq, small_dataset.queries[:1], trace)


def test_port_build_reaches_reference_recall(small_dataset, base_index):
    """A port-built index (port Vamana with the conftest graph's settings,
    port PQ) against the JAX-built conftest index, both searched by their
    own package: recall@10 within 0.01."""
    ds = PortDataset(small_dataset.name, small_dataset.vectors,
                     small_dataset.queries, small_dataset.gt,
                     small_dataset.dtype_tag)
    G, med, _ = build_vamana(ds.vectors, R=16, L=32, batch=512, seed=1,
                             device="cpu")
    idx = build_index(ds, SearchConfig(), graph=G, medoid_id=med,
                      device="cpu")
    cfg = get_preset("baseline")
    want = recall_at_k(base_index.search(ds.queries, cfg).ids, ds.gt, 10)
    got = recall_at_k(idx.search(ds.queries).ids, ds.gt, 10)
    assert abs(got - want) <= 0.01, (got, want)
    assert idx.build_stats.keys() >= {"pq_build_s", "layout_s",
                                      "overlap_ratio", "n_p", "disk_bytes",
                                      "memory_bytes"}
