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
# width that needs padding, and the main path's (deep-like, R=64); then the
# edges of the kernels' block of 48 stacked records x 64 queries: schedules
# shorter than a block and not a multiple of it (W = 4, 12 before the
# bucket), Q = 1 and Q not a multiple of 64 (65 also takes the scalar
# path), n_p in {1, 6, 9, 16}, d in {96, 100, 256} (bf16 at d = 100 takes
# the scalar path; d = 256 is staged in two rounds of 128), d = 130
# (a second round of 2 columns, padded to 4), and M = 6 (codes staged byte
# by byte)
SHAPES = [(16, 8, 128, 16, 4, 1), (64, 8, 128, 16, 8, 4),
          (32, 16, 256, 8, 6, 8), (8, 8, 128, 4, 3, 2),
          (128, 8, 128, 16, 16, 16), (64, 9, 96, 16, 37, 300),
          (4096, 6, 96, 16, 256, 256),
          (64, 1, 96, 16, 4, 65), (64, 6, 96, 16, 12, 1),
          (64, 6, 100, 16, 4, 300), (64, 9, 100, 8, 12, 65),
          (64, 16, 256, 16, 12, 300), (64, 1, 256, 16, 12, 1),
          (64, 16, 96, 16, 4, 64), (64, 9, 256, 16, 12, 65),
          (64, 6, 130, 16, 12, 300), (64, 6, 96, 6, 12, 64)]
TOLS = {torch.float32: 1e-5, torch.bfloat16: 0.3}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])


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
@DTYPES
def test_kernels_match_plain(card, n_pages, n_p, d, m, w, q, dtype):
    pages, codes, ids, qs, lut = _case(n_pages + w, n_pages, n_p, d, m, w,
                                       q, dtype, card)
    page_kernels = ("page_scan", "page_adc", "fused_page_rank")
    before = {k: ops.launches[k] for k in page_kernels}
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


@DTYPES
def test_duplicate_pages_inside_one_block_match_plain(card, dtype):
    """Page 5 fills most of the first block of 48 stacked records (n_p = 6),
    and pages repeat across the block's edge."""
    pages, codes, _, qs, lut = _case(11, 16, 6, 96, 16, 12, 300, dtype, card)
    ids = torch.tensor([5, 5, 5, 2, 5, 9, 2, 5, 5, 5, 0, 5], dtype=torch.int32,
                       device=card)
    exact, adc = ops.fused_page_rank(pages, codes, ids, qs, lut)
    want_exact, want_adc = ref.fused_page_rank_ref(pages, codes, ids, qs, lut)
    tol = TOLS[dtype]
    torch.testing.assert_close(exact, want_exact, rtol=tol, atol=tol * 96)
    torch.testing.assert_close(adc, want_adc, rtol=1e-4, atol=1e-3)
    for a, b in ((0, 1), (0, 7), (3, 6)):
        torch.testing.assert_close(exact[a], exact[b], rtol=0, atol=0)
        torch.testing.assert_close(adc[a], adc[b], rtol=0, atol=0)


@pytest.mark.parametrize("n_pages,n_p,d,m,w,q", SHAPES)
@DTYPES
def test_fused_exact_is_page_scan_bit_for_bit(card, n_pages, n_p, d, m, w, q,
                                              dtype):
    """Both kernels score the exact half with the one routine of
    common.cuh, in the same order, so their outputs are equal."""
    pages, codes, ids, qs, lut = _case(n_pages + w, n_pages, n_p, d, m, w,
                                       q, dtype, card)
    exact, adc = ops.fused_page_rank(pages, codes, ids, qs, lut)
    torch.testing.assert_close(exact, ops.page_scan(pages, ids, qs), rtol=0,
                               atol=0)
    torch.testing.assert_close(adc, ops.page_adc(codes, ids, lut), rtol=0,
                               atol=0)


def _shifted(t, by: int):
    """A contiguous copy of t whose data starts `by` elements past a
    16-byte boundary."""
    buf = torch.zeros(t.numel() + by, dtype=t.dtype, device=t.device)
    buf[by:].copy_(t.reshape(-1))
    return buf[by:].view(t.shape)


@DTYPES
def test_unaligned_tensors_take_the_scalar_path(card, dtype):
    """Pages, queries or a LUT off a 16-byte boundary are read by the
    scalar instantiations, and codes off a 4-byte boundary byte by byte:
    the same sums in the same order as the aligned paths, so the same
    bits."""
    pages, codes, ids, qs, lut = _case(13, 32, 6, 96, 16, 12, 64, dtype, card)
    exact, adc = ops.fused_page_rank(pages, codes, ids, qs, lut)
    pages_u, qs_u, lut_u = _shifted(pages, 1), _shifted(qs, 1), \
        _shifted(lut, 1)
    codes_u = _shifted(codes, 1)
    assert pages_u.data_ptr() % 16 and qs_u.data_ptr() % 16
    assert codes_u.data_ptr() % 4
    fused = ops.fused_page_rank(pages_u, codes_u, ids, qs_u, lut_u)
    for got in (ops.page_scan(pages_u, ids, qs_u), fused[0]):
        torch.testing.assert_close(got, exact, rtol=0, atol=0)
    for got in (ops.page_adc(codes_u, ids, lut_u), fused[1]):
        torch.testing.assert_close(got, adc, rtol=0, atol=0)


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


# (N, M, block_n): tests/test_kernels.py's sweep, the largest M the kernel
# takes, an M that takes the byte loads, and the smoke's microbench shape
PQ_SHAPES = [(100, 8, 64), (512, 16, 128), (1000, 16, 512), (4096, 32, 512),
             (7, 16, 8), (3000, 64, 512), (999, 24, 256), (65536, 16, 512)]


def _pq_case(seed, n, m, device):
    rng = np.random.default_rng(seed)
    codes = torch.as_tensor(rng.integers(0, 256, (n, m)).astype(np.uint8))
    lut = torch.as_tensor((rng.normal(size=(m, 256)) ** 2)
                          .astype(np.float32))
    return codes.to(device), lut.to(device)


@pytest.mark.parametrize("n,m,block", PQ_SHAPES)
def test_pq_adc_matches_plain(card, n, m, block):
    codes, lut = _pq_case(n + m, n, m, card)
    before = ops.launches["pq_adc"]
    got = ops.pq_adc(codes, lut, block_n=block)
    torch.cuda.synchronize()
    assert ops.launches["pq_adc"] == before + 1
    assert got.shape == (n,) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref.pq_adc_ref(codes, lut), rtol=1e-5,
                               atol=0)


def test_pq_adc_unaligned_codes_take_byte_loads(card):
    """Codes whose rows are not 16-byte aligned are read byte by byte: the
    same result as an aligned copy."""
    codes, lut = _pq_case(5, 777, 16, card)
    buf = torch.zeros(777 * 16 + 3, dtype=torch.uint8, device=card)
    buf[3:].copy_(codes.reshape(-1))
    shifted = buf[3:].view(777, 16)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    torch.testing.assert_close(ops.pq_adc(shifted, lut),
                               ops.pq_adc(codes, lut), rtol=0, atol=0)


@pytest.mark.parametrize("n,block", [(100, 64), (513, 512), (7, 8), (65, 64),
                                     (1_000_000, 512)])
def test_pq_adc_pad_tail_is_inf(card, n, block):
    from repro_torch.kernels.pq_adc import pq_adc
    codes, lut = _pq_case(n, n, 16, card)
    out = pq_adc(codes, lut, block_n=block, keep_pad=True)
    assert out.shape[0] % block == 0 and out.shape[0] >= n
    torch.testing.assert_close(out[:n], ref.pq_adc_ref(codes, lut),
                               rtol=1e-5, atol=0)
    assert torch.isinf(out[n:]).all() and (out[n:] > 0).all()
    guarded = pq_adc(codes, lut, block_n=block, nvalid=n // 2)
    assert torch.isinf(guarded[n // 2:]).all()
    torch.testing.assert_close(guarded[:n // 2], out[:n // 2], rtol=0,
                               atol=0)


def test_pq_adc_raises_on_what_the_kernel_does_not_take(card):
    codes, lut = _pq_case(2, 64, 16, card)
    with pytest.raises(TypeError):
        ops.pq_adc(codes.int(), lut)
    with pytest.raises(TypeError):
        ops.pq_adc(codes, lut.double())
    with pytest.raises(ValueError, match=r"\(M, 256\)"):
        ops.pq_adc(codes, lut[:8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.pq_adc(codes.t().contiguous().t(), lut)
    with pytest.raises(ValueError, match="1 to 64 subspaces"):
        big, big_lut = _pq_case(3, 8, 65, card)
        ops.pq_adc(big, big_lut)
    with pytest.raises(ValueError, match="all on the CPU"):
        ops.pq_adc(codes, lut.cpu())


def _integer_index(device):
    """A small port index whose vectors, queries and PQ centroids are
    small integers, so every distance is exact in float32 on either
    device: the card's search and the CPU's must agree bit for bit."""
    from repro_torch import build_index, get_preset
    from repro_torch.convert import index_from_reference
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.pq import PQ, encode
    rng = np.random.default_rng(0)
    x = rng.integers(0, 8, (1024, 32)).astype(np.float32)
    q = rng.integers(0, 8, (32, 32)).astype(np.float32)
    ds = Dataset("tie-free", x, q, np.zeros((32, 10), np.int32), "float")
    idx = build_index(ds, get_preset("baseline"), R=16, L_build=32,
                      device="cpu")
    cent = rng.integers(0, 8, (16, 256, 2)).astype(np.float32)
    idx.pq = PQ(centroids=cent, codes=encode(x, cent, device="cpu"), m=16,
                dsub=2)
    return ds, idx, index_from_reference(idx, device)


def _rows(reps):
    return [{k: v for k, v in r.row().items() if k != "measured_step_us"}
            for r in reps]


def test_fused_server_on_the_card_equals_the_cpu(card):
    """A pipeline="fused" AnnServer over a frozen and over a journaled
    MutableIndex: the card's rows equal the CPU port's, and each window
    launched the fused_page_rank kernel."""
    from repro_torch import get_preset
    from repro_torch.mutation import (JournalConfig, MutableIndex,
                                      MutationConfig, MutationJournal,
                                      MutationMix)
    from repro_torch.serving import AnnServer, ServerConfig
    ds, cpu_idx, gpu_idx = _integer_index(card)
    cfg = get_preset("pipeline", L=32, pipeline="fused")
    pool = np.random.default_rng(1).integers(0, 8, (64, 32)).astype(
        np.float32)
    mix = MutationMix(insert_frac=0.2, delete_frac=0.1,
                      compaction="threshold", threshold=0.05)
    out = {}
    for name, base in (("cpu", cpu_idx), ("card", gpu_idx)):
        ops.reset_launches()
        closed = AnnServer(base, cfg, server_cfg=ServerConfig(max_batch=8))
        rep_c = closed.serve_closed_loop(ds.queries, workers=8, rounds=2)
        mut = MutableIndex(base, MutationConfig(flush_threshold=8,
                                                insert_L=8),
                           journal=MutationJournal(JournalConfig(4)))
        srv = AnnServer(mut, cfg, server_cfg=ServerConfig(max_batch=8))
        rep_o = srv.serve_open_loop(ds.queries, rate_qps=8000.0,
                                    duration_us=15_000.0, seed=3,
                                    mutation_mix=mix, insert_pool=pool)
        torch.cuda.synchronize()
        out[name] = (rep_c, rep_o, dict(ops.launches))
        assert rep_o.flushes > 0 and rep_c.measured_step_us > 0
    (c_c, c_o, c_l), (g_c, g_o, g_l) = out["cpu"], out["card"]
    assert _rows([g_c, g_o]) == _rows([c_c, c_o])
    np.testing.assert_array_equal(g_o.stats.ids, c_o.stats.ids)
    np.testing.assert_array_equal(g_o.stats.dists, c_o.stats.dists)
    assert c_l["fused_page_rank"] == 0 and g_l["fused_page_rank"] > 0
