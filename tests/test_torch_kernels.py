"""The port's page kernels against the JAX package's.

On the CPU the port's wrappers take their plain PyTorch versions; these are
held against the reference's pure-jnp oracles (src/repro/kernels/ref.py) and
its Pallas kernels in interpret mode, on the same numpy inputs, with the
shape sweeps and tolerances of tests/test_kernels.py and
tests/test_fused_pipeline.py. The hand-written CUDA kernels run only on a
card: tests/test_torch_cuda.py holds them against the plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_search import fused_page_rank as pallas_fused
from repro.kernels.fused_search import page_adc as pallas_adc
from repro.kernels.page_scan import page_scan as pallas_scan
from repro.kernels.ref import fused_page_rank_ref as jax_fused_ref
from repro.kernels.ref import page_scan_ref as jax_scan_ref
from repro_torch import kernels as ops
from repro_torch.core.searchutils import dedup_merge_topL
from repro_torch.kernels import ref
from repro_torch.kernels.ops import _pad_ids


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast, and the
    test workers sharing a few cores do not oversubscribe them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

SCAN_SHAPES = [(16, 8, 128, 4, 1), (64, 8, 128, 8, 4), (32, 16, 256, 6, 8),
               (8, 8, 512, 3, 2), (128, 8, 128, 16, 16)]
FUSED_SHAPES = [(16, 8, 128, 16, 4, 1), (64, 8, 128, 16, 8, 4),
                (32, 16, 256, 8, 6, 8), (8, 8, 128, 4, 3, 2),
                (128, 8, 128, 16, 16, 16)]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 0.3)}


def _case(rng, n_pages, n_p, d, m, w, q):
    """numpy inputs of one schedule: pages, codes, ids, queries, luts."""
    return (rng.normal(size=(n_pages, n_p, d)).astype(np.float32),
            rng.integers(0, 256, (n_pages, n_p, m)).astype(np.uint8),
            rng.integers(0, n_pages, w).astype(np.int32),
            rng.normal(size=(q, d)).astype(np.float32),
            (rng.normal(size=(q, m, 256)) ** 2).astype(np.float32))


def _torch(arrays, dtype=torch.float32, device="cpu"):
    """The port's tensors of one schedule; its LUT is laid out (M, 256, Q),
    the reference's (Q, M, 256)."""
    pages, codes, ids, qs, lut = arrays
    return (torch.as_tensor(pages).to(device=device, dtype=dtype),
            torch.as_tensor(codes).to(device),
            torch.as_tensor(ids).to(device),
            torch.as_tensor(qs).to(device=device, dtype=dtype),
            torch.as_tensor(lut.transpose(1, 2, 0).copy()).to(device))


def _jax(arrays, dtype=jnp.float32):
    pages, codes, ids, qs, lut = arrays
    return (jnp.asarray(pages, dtype), jnp.asarray(codes), jnp.asarray(ids),
            jnp.asarray(qs, dtype), jnp.asarray(lut))


@pytest.mark.parametrize("n_pages,n_p,d,w,q", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_page_scan_plain_matches_reference(n_pages, n_p, d, w, q, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _case(np.random.default_rng(n_pages + d), n_pages, n_p, d, 4, w,
                   q)
    pages, _, ids, qs, _ = _torch(arrays, tdt)
    jpages, _, jids, jqs, _ = _jax(arrays, jdt)
    got = ops.page_scan(pages, ids, qs).numpy()
    assert got.shape == (w, n_p, q) and got.dtype == np.float32
    for want in (jax_scan_ref(jpages, jids, jqs),
                 pallas_scan(jpages, jids, jqs, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=tol,
                                   atol=tol * d)


@pytest.mark.parametrize("n_pages,n_p,d,m,w,q", FUSED_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_plain_matches_reference(n_pages, n_p, d, m, w, q, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _case(np.random.default_rng(n_pages + d + w), n_pages, n_p, d,
                   m, w, q)
    exact, adc = ops.fused_page_rank(*_torch(arrays, tdt))
    for want_exact, want_adc in (
            jax_fused_ref(*_jax(arrays, jdt)),
            pallas_fused(*_jax(arrays, jdt), interpret=True)):
        np.testing.assert_allclose(exact.numpy(), np.asarray(want_exact),
                                   rtol=tol, atol=tol * d)
        np.testing.assert_allclose(adc.numpy(), np.asarray(want_adc),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n_pages,n_p,m,w,q", [(16, 8, 16, 4, 1),
                                               (32, 16, 8, 6, 8),
                                               (8, 6, 16, 5, 3)])
def test_page_adc_plain_matches_pallas(n_pages, n_p, m, w, q):
    arrays = _case(np.random.default_rng(n_pages + m + w), n_pages, n_p, 8,
                   m, w, q)
    _, codes, ids, _, lut = _torch(arrays)
    _, jcodes, jids, _, jlut = _jax(arrays)
    got = ops.page_adc(codes, ids, lut).numpy()
    want = np.asarray(pallas_adc(jcodes, jids, jlut, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_duplicate_ids_score_identically():
    """A page staged twice scores identically both times, and the fused
    pass equals the split pair on the same schedule."""
    arrays = list(_case(np.random.default_rng(7), 32, 8, 128, 16, 6, 8))
    arrays[2] = np.array([3, 3, 0, 31, 7, 3], np.int32)
    pages, codes, ids, qs, lut = _torch(arrays)
    exact, adc = ops.fused_page_rank(pages, codes, ids, qs, lut)
    np.testing.assert_array_equal(exact[0].numpy(), exact[1].numpy())
    np.testing.assert_array_equal(adc[0].numpy(), adc[5].numpy())
    np.testing.assert_allclose(exact.numpy(),
                               ops.page_scan(pages, ids, qs).numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(adc.numpy(),
                               ops.page_adc(codes, ids, lut).numpy(),
                               rtol=1e-5, atol=1e-4)


def test_bucket_size_and_pad_ids():
    assert [ops.bucket_size(n) for n in (1, 3, 4, 5, 8, 9, 16, 17)] == \
        [4, 4, 4, 8, 8, 16, 16, 32]
    with pytest.raises(ValueError):
        ops.bucket_size(0)
    ids = torch.tensor([5, 2, 9], dtype=torch.int32)
    padded = _pad_ids(ids, 8)
    assert padded.dtype == torch.int32
    assert padded.tolist() == [5, 2, 9, 0, 0, 0, 0, 0]
    assert _pad_ids(padded, 8) is padded


@pytest.mark.parametrize("w", [1, 3, 5, 7, 9])
def test_wrappers_slice_back_odd_widths(w):
    """The schedule is padded to its bucket with page 0, and the padded
    steps are sliced away: each wrapper returns exactly w rows equal to the
    plain version on the unpadded schedule."""
    arrays = _case(np.random.default_rng(w), 16, 8, 128, 8, w, 4)
    pages, codes, ids, qs, lut = _torch(arrays)
    exact, adc = ops.fused_page_rank(pages, codes, ids, qs, lut)
    scan = ops.page_scan(pages, ids, qs)
    split_adc = ops.page_adc(codes, ids, lut)
    for out in (exact, adc, scan, split_adc):
        assert out.shape == (w, 8, 4)
    np.testing.assert_array_equal(scan.numpy(),
                                  ref.page_scan_ref(pages, ids, qs).numpy())
    np.testing.assert_array_equal(split_adc.numpy(),
                                  ref.page_adc_ref(codes, ids, lut).numpy())


def test_wrappers_refuse_mixed_devices():
    arrays = _case(np.random.default_rng(1), 8, 8, 16, 4, 3, 2)
    pages, codes, ids, qs, lut = _torch(arrays)
    with pytest.raises(ValueError, match="all on the CPU"):
        ops.page_scan(pages.to("meta"), ids, qs)


def test_cpu_calls_launch_nothing():
    ops.reset_launches()
    arrays = _case(np.random.default_rng(2), 8, 8, 16, 4, 3, 2)
    ops.fused_page_rank(*_torch(arrays))
    ops.pq_adc(torch.zeros((5, 4), dtype=torch.uint8), torch.ones((4, 256)))
    dedup_merge_topL(torch.tensor([[3, 1, 3]]), torch.ones((1, 3, 2)),
                     torch.zeros((1, 3, 2), dtype=torch.bool), 2)
    assert ops.launches == {"page_scan": 0, "page_adc": 0,
                            "fused_page_rank": 0, "pq_adc": 0,
                            "dedup_merge_topL": 0}
