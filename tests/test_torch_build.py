"""The port's builders against the JAX package's.

The numpy-only builders (layout, SSSP cache, page shuffle, dataset) must give
the reference's arrays exactly. PQ k-means is seeded differently (the
reference draws from `jax.random`), so PQ is held two ways: `encode` and
`lut` agree exactly given the same centroids here, and a port-built index
reaches the recall of a JAX-built one (tests/test_torch_search.py). The
Vamana build must repeat itself exactly.
"""
import numpy as np
import pytest
import torch

from repro.core import pq as jax_pq
from repro.core.cache import sssp_cache as jax_sssp
from repro.core.page_shuffle import shuffle_order as jax_shuffle
from repro.core.pages import build_layout as jax_layout
from repro.core.vamana import medoid as jax_medoid
from repro_torch.core import pq as port_pq
from repro_torch.core.cache import sssp_cache
from repro_torch.core.dataset import make_dataset
from repro_torch.core.page_shuffle import shuffle_order
from repro_torch.core.pages import build_layout
from repro_torch.core.vamana import build_vamana, medoid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast, and the
    test workers sharing a few cores do not oversubscribe them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_encode_and_lut_exact_given_centroids():
    """Integer-valued data and centroids make every distance exact, so the
    argmin (first minimum on ties in both) must pick the same code."""
    rng = np.random.default_rng(0)
    x = rng.integers(-4, 5, (600, 32)).astype(np.float32)
    cent = rng.integers(-4, 5, (8, 256, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        port_pq.encode(x, cent, block=256, device="cpu"),
        jax_pq.encode(x, cent, block=256))
    codes = jax_pq.encode(x, cent)
    ref = jax_pq.PQ(centroids=cent, codes=codes, m=8, dsub=4)
    port = port_pq.PQ(centroids=cent, codes=codes, m=8, dsub=4)
    q = rng.normal(size=32).astype(np.float32)
    np.testing.assert_allclose(port.lut(q), ref.lut(q), rtol=1e-6)
    np.testing.assert_array_equal(port.lut(np.round(q)), ref.lut(np.round(q)))
    np.testing.assert_allclose(port.adc(q, np.arange(50)),
                               ref.adc(q, np.arange(50)), rtol=1e-5)


def test_dataset_identical(small_dataset):
    ds = make_dataset("deep-like", n=2048, nq=64, seed=1, device="cpu")
    np.testing.assert_array_equal(ds.vectors, small_dataset.vectors)
    np.testing.assert_array_equal(ds.queries, small_dataset.queries)
    # ground truth by another matmul: the same neighbours, near ties aside
    assert np.mean(ds.gt[:, :10] == small_dataset.gt[:, :10]) >= 0.99
    assert medoid(ds.vectors) == jax_medoid(small_dataset.vectors)


@pytest.fixture(scope="module")
def port_graph(small_dataset):
    """A port-built graph over the conftest vectors (the numpy builders
    take any graph)."""
    return build_vamana(small_dataset.vectors, R=16, L=32, batch=512,
                        seed=1, device="cpu")


@pytest.mark.parametrize("shuffle,ais", [(False, False), (True, False),
                                         (False, True)])
def test_layout_cache_shuffle_identical(small_dataset, port_graph, shuffle,
                                        ais):
    G, med, _ = port_graph
    perm = None
    if shuffle:
        perm = shuffle_order(G, med, 9)["perm"]
        np.testing.assert_array_equal(perm, jax_shuffle(G, med, 9)["perm"])
    got = build_layout(small_dataset.vectors, G, perm=perm,
                       all_in_storage=ais)
    want = jax_layout(small_dataset.vectors, G, perm=perm, all_in_storage=ais)
    for f in ("n_p", "num_pages", "record_bytes", "mapping_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("vid2page", "vid2slot", "page_vids", "page_vecs", "page_nbrs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(sssp_cache(G, med, 0.05),
                                  jax_sssp(G, med, 0.05))


def test_repeated_build_same_graph():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(384, 16)).astype(np.float32)
    a = build_vamana(x, R=8, L=16, batch=128, seed=3, device="cpu")
    b = build_vamana(x, R=8, L=16, batch=128, seed=3, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
    assert a[0].dtype == np.int32 and a[0].shape == (384, 8)
    assert np.all((a[0] >= -1) & (a[0] < 384))
    assert not np.any(a[0] == np.arange(384)[:, None])


def test_train_pq_shapes_and_determinism():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(700, 32)).astype(np.float32)
    a = port_pq.train_pq(x, m=8, sample=512, iters=4, seed=2, device="cpu")
    b = port_pq.train_pq(x, m=8, sample=512, iters=4, seed=2, device="cpu")
    assert a.centroids.shape == (8, 256, 4) and a.codes.shape == (700, 8)
    assert a.codes.dtype == np.uint8
    np.testing.assert_array_equal(a.centroids, b.centroids)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(
        a.codes, port_pq.encode(x, a.centroids, device="cpu"))
    assert torch.isfinite(torch.as_tensor(a.centroids)).all()
