"""The port's hand-written CUDA kernels against their plain versions, on the
card. Every test here is marked `cuda` and skips with a reason where there
is no CUDA device; this file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as ops
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda

# (P, n_p, d, M, W, Q): the CPU sweeps' shapes, a ragged query tile, a
# width that needs padding, and the main path's (deep-like, R=64)
SHAPES = [(16, 8, 128, 16, 4, 1), (64, 8, 128, 16, 8, 4),
          (32, 16, 256, 8, 6, 8), (8, 8, 128, 4, 3, 2),
          (128, 8, 128, 16, 16, 16), (64, 9, 96, 16, 37, 300),
          (4096, 6, 96, 16, 256, 256)]
TOLS = {torch.float32: 1e-5, torch.bfloat16: 0.3}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    return torch.device("cuda")


def _case(seed, n_pages, n_p, d, m, w, q, dtype, device):
    rng = np.random.default_rng(seed)
    pages = torch.as_tensor(rng.normal(size=(n_pages, n_p, d))
                            .astype(np.float32)).to(device, dtype)
    codes = torch.as_tensor(rng.integers(0, 256, (n_pages, n_p, m))
                            .astype(np.uint8)).to(device)
    ids = torch.as_tensor(rng.integers(0, n_pages, w).astype(np.int32)
                          ).to(device)
    qs = torch.as_tensor(rng.normal(size=(q, d)).astype(np.float32)
                         ).to(device, dtype)
    lut = torch.as_tensor((rng.normal(size=(q, m, 256)) ** 2)
                          .astype(np.float32).transpose(1, 2, 0).copy()
                          ).to(device)                       # (M, 256, Q)
    return pages, codes, ids, qs, lut


@pytest.mark.parametrize("n_pages,n_p,d,m,w,q", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernels_match_plain(card, n_pages, n_p, d, m, w, q, dtype):
    pages, codes, ids, qs, lut = _case(n_pages + w, n_pages, n_p, d, m, w,
                                       q, dtype, card)
    before = dict(ops.launches)
    exact, adc = ops.fused_page_rank(pages, codes, ids, qs, lut)
    scan = ops.page_scan(pages, ids, qs)
    split_adc = ops.page_adc(codes, ids, lut)
    torch.cuda.synchronize()
    assert all(ops.launches[k] == before[k] + 1 for k in before)
    want_exact, want_adc = ref.fused_page_rank_ref(pages, codes, ids, qs, lut)
    tol = TOLS[dtype]
    for got in (exact, scan):
        assert got.shape == (w, n_p, q) and got.dtype == torch.float32
        torch.testing.assert_close(got, want_exact, rtol=tol, atol=tol * d)
    for got in (adc, split_adc):
        torch.testing.assert_close(got, want_adc, rtol=1e-4, atol=1e-3)


def test_duplicate_pages_score_identically(card):
    pages, codes, _, qs, lut = _case(7, 32, 8, 128, 16, 6, 8, torch.float32,
                                     card)
    ids = torch.tensor([3, 3, 0, 31, 7, 3], dtype=torch.int32, device=card)
    exact, adc = ops.fused_page_rank(pages, codes, ids, qs, lut)
    torch.testing.assert_close(exact[0], exact[1], rtol=0, atol=0)
    torch.testing.assert_close(adc[0], adc[5], rtol=0, atol=0)


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    pages, codes, ids, qs, lut = _case(1, 16, 8, 64, 8, 5, 4, torch.float32,
                                       card)
    with pytest.raises(IndexError):
        ops.page_scan(pages, ids + 16, qs)
    with pytest.raises(TypeError):
        ops.page_scan(pages.double(), ids, qs.double())
    with pytest.raises(TypeError):
        ops.page_adc(codes.int(), ids, lut)
    with pytest.raises(ValueError):
        ops.page_scan(pages.transpose(1, 2), ids, qs)
    with pytest.raises(ValueError):
        ops.fused_page_rank(pages, codes, ids, qs, lut.cpu())
    with pytest.raises(ValueError):
        ops.fused_page_rank(pages, codes, ids, qs[:-1].contiguous(), lut)
    with pytest.raises(ValueError):
        ops.page_adc(codes, ids, lut.permute(2, 0, 1).contiguous())


def test_checked_ids_skip_only_the_range_check(card):
    """ids_checked=True (the caller checked the range on the host) gives
    the same result as the checked call."""
    pages, codes, ids, qs, lut = _case(3, 16, 8, 64, 8, 5, 4, torch.float32,
                                       card)
    exact, adc = ops.fused_page_rank(pages, codes, ids, qs, lut)
    got = ops.fused_page_rank(pages, codes, ids, qs, lut, ids_checked=True)
    torch.testing.assert_close(got[0], exact, rtol=0, atol=0)
    torch.testing.assert_close(got[1], adc, rtol=0, atol=0)
    torch.testing.assert_close(ops.page_scan(pages, ids, qs, ids_checked=True),
                               exact, rtol=0, atol=0)
    torch.testing.assert_close(ops.page_adc(codes, ids, lut, ids_checked=True),
                               adc, rtol=0, atol=0)
