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


# dedup_merge_topL (csrc/merge_topl.cu) against its plain version: every
# caller's (N, L, K, F) at the benchmark's shapes, as in
# tests/test_torch_searchutils.py: deep's, gist's and sift's disk hops, the
# MemGraph hop, the Vamana build's search and candidate merges; then the
# wider launches: an OctopusANN hop on an R = 128 graph (NP = 8,192) and
# one of a pipelined width of 64 on an R = 160 graph (NP = 16,384)
MERGE_SHAPES = [(2368, 96, 2, 2), (2272, 160, 2, 2), (616, 96, 2, 2),
                (128, 32, 1, 1), (189, 125, 1, 1), (439, 439, 1, 1),
                (4416, 96, 2, 2), (10_880, 128, 2, 2)]
MERGE_EDGES = ("sentinel", "inf", "one_run")


def _merge_rows(seed, b, n, k, f, kinds=()):
    """b rows of candidates, as numpy. Rows tie as in
    tests/test_torch_searchutils.py: ids from n // 4 values, a quarter
    SENTINEL; keys from 4 levels, a quarter INF; random flags. Every other
    row is search-like instead: ids from 8 n values, keys continuous. Row i
    < len(kinds) is an edge row: all SENTINEL, all keys INF, or one id the
    whole row long."""
    from repro_torch.core.searchutils import INF, SENTINEL
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(2, n // 4), (b, n))
    ids[rng.random((b, n)) < 0.25] = SENTINEL
    keys = rng.integers(0, 4, (b, n, k)).astype(np.float32)
    keys[rng.random((b, n, k)) < 0.25] = np.float32(INF)
    flags = rng.random((b, n, f)) < 0.5
    ids[1::2] = rng.integers(0, 8 * n, (b // 2, n))
    keys[1::2] = rng.random((b // 2, n, k)).astype(np.float32) * 100
    for i, kind in enumerate(kinds):
        if kind == "sentinel":
            ids[i] = SENTINEL
        elif kind == "inf":
            keys[i] = np.float32(INF)
        else:
            ids[i] = 12345
    return ids, keys, flags


def _merge_both(arrays, L, device):
    """The merge of `arrays` by dedup_merge_topL on the CPU (the plain
    version) and on `device`."""
    from repro_torch.core import searchutils as tsu
    cpu = [torch.as_tensor(a) for a in arrays]
    want = tsu.dedup_merge_topL(*cpu, L)
    got = tsu.dedup_merge_topL(*(t.to(device) for t in cpu), L)
    return got, want


def _assert_same_bits(got, want):
    """Each output equal in dtype, shape and every byte, padded slots
    included."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.cpu().numpy().view(np.uint8),
                                      w.numpy().view(np.uint8))


@pytest.mark.parametrize("b", [1, 3, 256])
@pytest.mark.parametrize("n,L,k,f", MERGE_SHAPES)
def test_merge_kernel_equals_plain_bit_for_bit(card, n, L, k, f, b):
    """B = 1 is a tied row; B = 3 the three edge rows alone, whose padded
    slots carry their runs' suffix min and OR; B = 256 both kinds of row
    and the edges."""
    arrays = _merge_rows(n + L + b, b, n, k, f,
                         MERGE_EDGES if b >= len(MERGE_EDGES) else ())
    _assert_same_bits(*_merge_both(arrays, L, card))


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 255, 256, 257, 4095, 4096,
                               4097, 8192, 8193, 16_383, 16_384])
def test_merge_kernel_every_padded_length(card, n):
    """Widths below, at and above the powers of two the kernel pads its
    sorts to, from one thread up to the widest block of each launch."""
    arrays = _merge_rows(n, 4, n, 2, 1)
    for L in sorted({1, (n + 1) // 2, n}):
        _assert_same_bits(*_merge_both(arrays, L, card))


@pytest.mark.parametrize("n,L,k,f", [(616, 96, 2, 2), (4416, 96, 2, 2),
                                     (10_880, 128, 2, 2)])
def test_merge_kernel_replays_in_a_cuda_graph(card, n, L, k, f):
    """Captured once on static buffers, the kernel merges new inputs on
    every replay, as it does inside the captured hops; the wider launches
    opt in to their shared memory inside the capture."""
    from repro_torch.core import searchutils as tsu
    bufs = [torch.as_tensor(a).to(card)
            for a in _merge_rows(1, 16, n, k, f)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tsu.dedup_merge_topL(*bufs, L)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tsu.dedup_merge_topL(*bufs, L)
    for seed in (2, 3):
        arrays = _merge_rows(seed, 16, n, k, f, MERGE_EDGES)
        for buf, a in zip(bufs, arrays):
            buf.copy_(torch.as_tensor(a))
        graph.replay()
        torch.cuda.synchronize()
        want = tsu.dedup_merge_topL(*(torch.as_tensor(a) for a in arrays),
                                    L)
        _assert_same_bits(out, want)


def test_merge_kernel_counts_its_launches(card):
    """One launch a call on the card; none on the CPU."""
    from repro_torch.core import searchutils as tsu
    arrays = [torch.as_tensor(a) for a in _merge_rows(4, 3, 128, 1, 1)]
    before = ops.launches["dedup_merge_topL"]
    tsu.dedup_merge_topL(*(a.to(card) for a in arrays), 32)
    torch.cuda.synchronize()
    assert ops.launches["dedup_merge_topL"] == before + 1
    tsu.dedup_merge_topL(*arrays, 32)
    assert ops.launches["dedup_merge_topL"] == before + 1


def test_merge_kernel_raises_on_what_it_does_not_take(card):
    ids, keys, flags = (torch.as_tensor(a).to(card)
                        for a in _merge_rows(5, 2, 64, 2, 2))
    with pytest.raises(TypeError):
        ops.dedup_merge_topL(ids.int(), keys, flags, 8, sentinel=1, inf=1.0)
    with pytest.raises(TypeError):
        ops.dedup_merge_topL(ids, keys.double(), flags, 8, sentinel=1, inf=1.0)
    with pytest.raises(TypeError):
        ops.dedup_merge_topL(ids, keys, flags.int(), 8, sentinel=1, inf=1.0)
    with pytest.raises(ValueError, match="1 or 2 key and flag columns"):
        ops.dedup_merge_topL(ids, torch.cat([keys, keys], 2), flags, 8,
                       sentinel=1, inf=1.0)
    with pytest.raises(ValueError, match="L <= N"):
        ops.dedup_merge_topL(ids, keys, flags, 65, sentinel=1, inf=1.0)
    with pytest.raises(ValueError, match="L <= N"):
        ops.dedup_merge_topL(ids, keys, flags, 0, sentinel=1, inf=1.0)
    wide = [torch.as_tensor(a).to(card)
            for a in _merge_rows(6, 1, 16_385, 1, 1)]
    with pytest.raises(ValueError, match="N <= 16384"):
        ops.dedup_merge_topL(*wide, 8, sentinel=1, inf=1.0)
    with pytest.raises(ValueError, match="do not match"):
        ops.dedup_merge_topL(ids, keys[:, :32].contiguous(), flags, 8, sentinel=1,
                       inf=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.dedup_merge_topL(ids.t().contiguous().t(), keys, flags, 8, sentinel=1,
                       inf=1.0)
    with pytest.raises(ValueError, match="all on the CPU"):
        ops.dedup_merge_topL(ids, keys.cpu(), flags, 8, sentinel=1, inf=1.0)


def _integer_index(device, preset="baseline", R=16, L_build=32):
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
    idx = build_index(ds, get_preset(preset), R=R, L_build=L_build,
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
    assert c_l["dedup_merge_topL"] == 0 and g_l["dedup_merge_topL"] > 0


def test_search_of_an_r128_graph_on_the_card_equals_the_cpu(card,
                                                           monkeypatch):
    """OctopusANN on an R = 128 graph, a common DiskANN build: each disk hop
    merges L + 32 (1 + n_p + R) > 4,096 candidates, one of the merge
    kernel's wider launches, and the card's results equal the CPU's."""
    from repro_torch import get_preset
    from repro_torch.kernels import ops as kernel_ops
    ds, cpu_idx, gpu_idx = _integer_index(card, "starling", R=128,
                                          L_build=128)
    widths = []
    merge = kernel_ops.dedup_merge_topL

    def spy(ids, *a, **kw):
        widths.append(ids.shape[1])
        return merge(ids, *a, **kw)

    monkeypatch.setattr(kernel_ops, "dedup_merge_topL", spy)
    cfg = get_preset("octopusann")
    want = cpu_idx.search(ds.queries, cfg)
    widths.clear()
    ops.reset_launches()
    got = gpu_idx.search(ds.queries, cfg)
    assert max(widths) > 4096 and ops.launches["dedup_merge_topL"] > 0
    for name in ("ids", "dists", "hops", "page_reads"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


def test_fleet_on_the_card_equals_the_facade(card):
    """A pipeline="fused" FleetServer (two groups of two replicated
    shards, migration and autoscaling on): the ids equal the facade's on
    the card, the rows equal the CPU port's, and the window launched
    fused_page_rank."""
    from repro_torch import get_preset
    from repro_torch.io import profile_from_trace
    from repro_torch.serving import (AutoscaleConfig, FleetConfig,
                                     FleetServer, MigrationConfig,
                                     ServerConfig)
    ds, cpu_idx, gpu_idx = _integer_index(card)
    cfg = get_preset("pipeline", L=32, pipeline="fused")
    st = cpu_idx.search(ds.queries, cfg)      # a fused search keeps traces
    profile = profile_from_trace(st.page_trace, cpu_idx.layout.num_pages)
    out = {}
    for name, base in (("cpu", cpu_idx), ("card", gpu_idx)):
        ops.reset_launches()
        srv = FleetServer(
            base, cfg, server_cfg=ServerConfig(
                max_batch=8, shards=2, placement="replicated",
                cache_policy="lru", cache_bytes=8 * base.layout.page_bytes),
            fleet_cfg=FleetConfig(
                replica_groups=2, migration=MigrationConfig(every_us=400.0),
                autoscale=AutoscaleConfig(check_every_us=500.0,
                                          max_groups=4)),
            page_profile=profile)
        rep = srv.serve_fleet(ds.queries, rate_qps=50_000.0,
                              duration_us=4_000.0, seed=4)
        torch.cuda.synchronize()
        out[name] = (rep, dict(ops.launches))
    (c_rep, c_l), (g_rep, g_l) = out["cpu"], out["card"]
    want = gpu_idx.search(ds.queries, cfg)
    np.testing.assert_array_equal(g_rep.stats.ids,
                                  want.ids[g_rep.query_indices])
    assert _rows([g_rep]) == _rows([c_rep])
    assert g_rep.per_replica == c_rep.per_replica
    assert c_l["fused_page_rank"] == 0 and g_l["fused_page_rank"] > 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "rwkv6-3b", "jamba-v0.1-52b",
                                  "whisper-small", "qwen2-vl-2b"])
def test_lm_decode_matches_prefill_on_the_card(card, arch):
    """One smoke config of each family (dense, moe, ssm, hybrid, audio,
    vlm), float32 with TF32 off: decode after a half prefill gives the full
    prefill's logits on the card (the reference's 2e-2 in bfloat16 caches,
    1e-4 in float32 caches), and the card's full prefill is the CPU's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import decode_vs_prefill
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, 32))
    frames = (rng.normal(0, 0.1, (2, cfg.num_frames, cfg.d_model)).astype(
        np.float32) if cfg.frontend == "audio_stub" else None)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
        _, full_cpu = decode_vs_prefill(params, cfg, toks, frames)
        params = params.to(card)
        lg, full = decode_vs_prefill(params, cfg, toks, frames)
        lg32, full32 = decode_vs_prefill(params, cfg, toks, frames,
                                         cache_dtype=torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert lg.device.type == "cuda" and torch.isfinite(lg).all()
    np.testing.assert_allclose(lg.cpu().numpy(), full.cpu().numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lg32.cpu().numpy(), full32.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(full.cpu().numpy(), full_cpu.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_init_params_draws_on_the_card(card):
    """`init_params` puts the model on the card by default, drawn there
    from a card generator, and refuses a generator on another device."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    cfg = get_smoke_config("tinyllama-1.1b")
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0))
    assert params.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in params.parameters())
    with pytest.raises(ValueError, match="generator is on cpu"):
        init_params(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("compress,accum", [(False, 1), (False, 2),
                                            (True, 1)],
                         ids=["plain", "accum2", "compress"])
def test_train_step_on_the_card_equals_the_cpu(card, compress, accum):
    """The launcher's first step of the tinyllama smoke config on the card
    equals the CPU's, float32 with TF32 off: the parameters at rtol 1e-4,
    atol 1e-5, but for int8 codes that round the other way (at most 1e-3
    of them), which may move by the lr (chip_smoke.py [train] (c))."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import first_step, step_difference
    cfg = get_smoke_config("tinyllama-1.1b")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = first_step(cfg, card, compress, accum)
        cpu = first_step(cfg, "cpu", compress, accum)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert gpu[0].device.type == "cuda"
    r = step_difference(gpu, cpu, 1e-4, 1e-5)
    np.testing.assert_allclose(r["loss_a"], r["loss_b"], rtol=1e-5)
    assert r["max_excess_over_tol"] <= 0, r
    assert r["code_flips"] <= 1e-3 * r["elements"], r
    if not compress:
        assert r["code_flips"] == 0


def test_checkpoint_of_card_tensors_round_trips(card, tmp_path):
    """save/restore of a model, its optimizer state and a bfloat16 tensor
    on the card give back the same bits, on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.training import checkpoint, optim
    cfg = get_smoke_config("kimi-k2-1t-a32b")        # bfloat16 `m`
    opt = optim.for_model(cfg)

    def model(seed):
        return init_params(cfg, torch.Generator(device=card).manual_seed(
            seed), dtype=torch.float32)

    src = model(0)
    state = optim.init_state(src, opt)
    state["mu"]["embed"]["table"]["m"].normal_()
    extra = torch.randn(5, 3, device=card).to(torch.bfloat16)
    checkpoint.save(tmp_path, 7, (src, state, extra))
    dst = model(1)
    (got, got_state, got_extra), step = checkpoint.restore(
        tmp_path, (dst, optim.init_state(dst, opt), torch.zeros(
            5, 3, dtype=torch.bfloat16, device=card)))
    assert step == 7 and got is dst
    for (n, a), (_, b) in zip(src.named_parameters(),
                              got.named_parameters()):
        assert b.device.type == "cuda"
        assert torch.equal(a, b), n
    want = state["mu"]["embed"]["table"]["m"]
    back = got_state["mu"]["embed"]["table"]["m"]
    assert back.dtype == torch.bfloat16 and back.device.type == "cuda"
    assert torch.equal(back, want)
    assert got_state["step"].dtype == torch.int32
    assert got_extra.dtype == torch.bfloat16 and torch.equal(got_extra, extra)


# ---------------------------------------------------------------------------
# the mesh code on the card: a one-rank NCCL mesh in this process, and ranks
# that share the one card over gloo (NCCL refuses two ranks on one device),
# each call killed after RANK_TIMEOUT s (chip_smoke.py [mesh] at full width)

RANK_TIMEOUT = 120


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def test_one_rank_nccl_mesh_changes_nothing(card):
    """The tinyllama smoke config under a context on a one-rank NCCL mesh:
    the loss and the gradients bit for bit those of parallel=None, on the
    same card (the embedding's backward may add in another order: its
    leaves within rtol 1e-5 and 2**-20 of their largest magnitude), and
    the LM server's greedy tokens the same."""
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params, loss_fn
    from repro_torch.parallel import ParallelContext
    from repro_torch.serving.engine import LMServer
    from repro_torch.training.accumulate import value_and_grad
    from repro_torch.training.tree import tree_items
    mesh = make_local_mesh()
    try:
        assert dist.get_backend() == "nccl"
        ctx = ParallelContext(mesh)
        cfg = get_smoke_config("tinyllama-1.1b")
        params = init_params(cfg, torch.Generator(device=card).manual_seed(
            0), dtype=torch.float32)
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (2, 32),
                                         device=card)}
        (loss, _), grads = value_and_grad(
            lambda p, b: loss_fn(p, cfg, b, parallel=ctx), params, batch)
        (loss0, _), grads0 = value_and_grad(
            lambda p, b: loss_fn(p, cfg, b), params, batch)
        assert float(loss) == float(loss0)
        want = dict(tree_items(grads0))
        for path, g in tree_items(grads):
            w = want[path]
            tol = 1e-5 * w.abs() + 2.0 ** -20 * float(w.abs().max())
            assert bool(((g - w).abs() <= tol).all()), path
        prompts = np.random.default_rng(0).integers(1, cfg.vocab_size,
                                                    (4, 8))
        np.testing.assert_array_equal(
            LMServer(params, cfg, max_len=32, parallel=ctx).generate(
                prompts, new_tokens=8),
            LMServer(params, cfg, max_len=32).generate(prompts,
                                                       new_tokens=8))
    finally:
        dist.destroy_process_group()


def _moe_rank(rank, world, shape, quant):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import ParallelContext, comm
    _tf32_off()
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    ctx = ParallelContext(mesh, gather_quant=quant)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = MOE.init_moe(gen, cfg, torch.float32)
    x = torch.randn((4, 32, cfg.d_model), device="cuda", generator=gen)
    y, aux = MOE.apply_moe(p, x, cfg, parallel=ctx)
    if quant and ctx.moe_weight_axes(cfg)["d_ff"]:
        p = dict(p, **{k: p[k].to(torch.float8_e4m3fn).float()
                       for k in ("wi", "wg", "wo")})
    shards = x.chunk(shape[0])
    y_loc, _ = MOE.apply_moe(p, shards[mesh.get_local_rank("data")], cfg)
    aux_loc = torch.stack([MOE.apply_moe(p, xs, cfg)[1]
                           for xs in shards]).mean()
    return (float((y.to_local() - y_loc).abs().max()),
            float((aux.to_local() - aux_loc).abs()), y.to_local().is_cuda,
            comm.transport(mesh.get_group("model"), y.device))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "fp8-gather"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["model2",
                                                         "data2-model2"])
def test_expert_parallel_moe_on_the_card(card, tmp_path, shape, quant):
    """The qwen2-moe smoke layer in 2 or 4 ranks on the card equals the
    local path on each rank's data shard (fp8-rounded expert weights where
    gather_quant gathers them) within 1e-5."""
    from repro_torch.launch.mesh import run_in_processes
    for err, aux_err, on_card, how in run_in_processes(
            _moe_rank, shape[0] * shape[1], shape, quant,
            store_dir=tmp_path, timeout=RANK_TIMEOUT):
        assert on_card and how == "gloo-host"
        assert err <= 1e-5 and aux_err <= 1e-5, (err, aux_err)


def _pipe_and_psum_rank(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.pipeline import gpipe
    from repro_torch.training.compression import compressed_psum, quantize
    _tf32_off()
    pod = init_device_mesh("cuda", (world,), mesh_dim_names=("pod",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((world, 64, 64), device="cuda", generator=gen) / 8
    x = torch.randn((16, 64), device="cuda", generator=gen)
    y = gpipe(lambda w_s, h: torch.tanh(h @ w_s), w, x, 4, axis="pod",
              mesh=pod)
    seq = x
    for w_s in w:
        seq = torch.tanh(seq @ w_s)

    def grad(r):
        return torch.randn((64, 48), device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(10 + r))
    s = compressed_psum(grad(rank), pod.get_group("pod"))
    codes = [quantize(grad(r)) for r in range(world)]
    want = (sum(q.to(torch.int32) for q, _ in codes).float()
            * torch.stack([sc for _, sc in codes]).max())
    return float((y - seq).abs().max()), bool(torch.equal(s, want))


def test_gpipe_and_compressed_psum_on_the_card(card, tmp_path):
    """4 ranks on the card: gpipe of 4 stages equals the sequential stack
    within 1e-5; compressed_psum equals the sum of the int8 codes times
    the max scale bit for bit."""
    from repro_torch.launch.mesh import run_in_processes
    for err, psum_equal in run_in_processes(
            _pipe_and_psum_rank, 4, store_dir=tmp_path,
            timeout=RANK_TIMEOUT):
        assert err < 1e-5 and psum_equal, (err, psum_equal)


def _transport_rank(rank, world):
    import torch.distributed as dist
    from repro_torch.parallel import comm
    t = torch.full((3, 2), float(rank + 1), device="cuda")
    f8 = t.to(torch.float8_e4m3fn)
    return (comm.transport(None, t.device),
            comm.all_reduce(t).cpu().numpy(),
            comm.all_reduce(t, op="max").cpu().numpy(),
            comm.all_gather(t, dim=1).cpu().numpy(),
            comm.all_gather(f8, dim=0).float().cpu().numpy(),
            comm.ring_shift(t).cpu().numpy(),
            comm.all_reduce(t).is_cuda, dist.get_backend())


def test_gloo_host_transport_round_trips_card_tensors(card, tmp_path):
    """Under gloo, CUDA tensors go through host memory ("gloo-host") and
    come back on the card with the collective's result."""
    from repro_torch.launch.mesh import run_in_processes
    out = run_in_processes(_transport_rank, 2, store_dir=tmp_path,
                           timeout=RANK_TIMEOUT)
    for rank, (how, s, m, g, g8, ring, on_card, backend) in enumerate(out):
        assert how == "gloo-host" and backend == "gloo" and on_card
        np.testing.assert_array_equal(s, np.full((3, 2), 3.0))
        np.testing.assert_array_equal(m, np.full((3, 2), 2.0))
        np.testing.assert_array_equal(
            g, np.concatenate([np.full((3, 2), 1.0), np.full((3, 2), 2.0)],
                              axis=1))
        np.testing.assert_array_equal(
            g8, np.concatenate([np.full((3, 2), 1.0), np.full((3, 2), 2.0)]))
        np.testing.assert_array_equal(ring, np.full((3, 2), 2.0 - rank))


@pytest.mark.parametrize("batch,seq", [(8, 128), (2, 64)])
def test_dry_run_record_equals_the_real_step_on_the_card(card, batch, seq):
    """The dry run's record of the tinyllama smoke config's training step
    (float32, AdamW, remat "none"), traced on fake "cuda" tensors of a
    one-rank fake mesh, against the real step on the card: its FLOPs equal
    FlopCounterMode's around the real step, and its argument bytes the
    real parameters', optimizer state's and batch's, exactly; both peaks
    are positive."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    r = dryrun.hold_against_real_step(
        "tinyllama-1.1b", cfg=get_smoke_config("tinyllama-1.1b"),
        batch=batch, seq=seq, device=card)
    assert r["dry_flops"] == r["real_flops"] > 0
    assert r["dry_argument_bytes"] == r["real_argument_bytes"] > 0
    assert r["dry_peak_bytes"] > 0 and r["real_peak_bytes"] > 0


def test_dry_run_cell_on_fake_card_tensors(card, tmp_path):
    """`python -m repro_torch.launch.dryrun` on fake "cuda" tensors of a
    256-rank fake group: a decode cell's record is ok."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    tag = f"cuda-test-{tmp_path.name}"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "decode_32k", "--force", "--tag", tag],
        cwd=root, env=dict(__import__("os").environ,
                           PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    out = root / "build" / f"dryrun_{tag}"
    try:
        rec = json.loads((out / "single" /
                          "tinyllama-1.1b__decode_32k.json").read_text())
    finally:
        import shutil
        shutil.rmtree(out, ignore_errors=True)
    assert rec["ok"] and rec["n_devices"] == 256 and rec["flops"] > 0


_FOLD_ON_CARD = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_ranks

out = {}
shape = ShapeConfig("t", "train", 64, 8)
for world, dims in ((1, (1, 1)), (8, (2, 4))):
    init_fake_ranks(world)
    mesh = DeviceMesh("cuda", torch.arange(world).reshape(dims),
                      mesh_dim_names=("data", "model"))
    for arch in ("tinyllama-1.1b", "rwkv6-3b"):
        cell = dryrun.build_cell(arch, "t", mesh, device="cuda",
                                 cfg=get_smoke_config(arch), shape=shape)
        for fold in (True, False):
            rec = dryrun.count_step(cell, fold_loops=fold)
            out[f"{world}/{arch}/{fold}"] = rec["flops"]
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_dry_run_counts_on_fake_card_tensors():
    """On fake "cuda" tensors (whose backward runs on the card's autograd
    thread): a folded scan counts the FLOPs of the whole loop, and the
    tinyllama smoke config's train step under "fsdp" on 8 ranks computes
    nothing twice (8 x its per-device FLOPs = one device's)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: fake \"cuda\" tensors need the "
                    "CUDA build of torch")
    root = Path(__file__).resolve().parent.parent
    p = subprocess.run([sys.executable, "-c", _FOLD_ON_CARD], cwd=root,
                       env=dict(os.environ, PYTHONPATH=str(root / "src")),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    for world in (1, 8):
        for arch in ("tinyllama-1.1b", "rwkv6-3b"):
            assert (got[f"{world}/{arch}/True"]
                    == got[f"{world}/{arch}/False"]), (world, arch)
    assert got["8/tinyllama-1.1b/True"] * 8 == got["1/tinyllama-1.1b/True"]


# ---------------------------------------------------------------------------
# serving, moves and gradients on ranks that share the card


def _serve_rank(rank, world, arch):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.parallel import ParallelContext, comm
    from repro_torch.serving.engine import LMServer
    _tf32_off()
    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.float32)
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (4, 8)).astype(np.int32)
    one = LMServer(params, cfg, max_len=16).generate(prompts, 6)
    comm.reset_host_stats()
    srv = LMServer(params, cfg, max_len=16,
                   parallel=ParallelContext(mesh, profile="tp"))
    got = srv.generate(prompts, 6)
    on_card = all(p.to_local().is_cuda for p in srv.params.parameters())
    return got, one, on_card, sorted(comm.host_stats["transports"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b",
                                  "qwen2-moe-a2.7b"])
def test_lm_server_on_two_ranks_sharing_the_card(card, tmp_path, arch):
    """`LMServer` on a (data 1, model 2) mesh of 2 processes that share the
    card over gloo gives the one-device server's greedy tokens; its
    parameters' blocks stay on the card, and every collective goes
    through host memory ("gloo-host")."""
    from repro_torch.launch.mesh import run_in_processes
    for got, one, on_card, how in run_in_processes(
            _serve_rank, 2, arch, store_dir=tmp_path, timeout=RANK_TIMEOUT):
        np.testing.assert_array_equal(got, one)
        assert on_card and how == ["gloo-host"], (on_card, how)


def _moves_rank(rank, world):
    """Every pair of placements of card tensors through `redistribute`
    (the block path under "gloo-host"), beside DTensor's own redistribute
    of the same tensors on the CPU."""
    import itertools
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.parallel import comm
    opts = (Shard(0), Shard(1), Replicate(), Partial())
    meshes = {d: init_device_mesh(d, (2, 2), mesh_dim_names=("data",
                                                              "model"))
              for d in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(0)
    full, gfull = torch.randn((8, 5), generator=gen), torch.randn(
        (8, 5), generator=gen)

    def make(t, pl, scale, dev):
        x = distribute_tensor(t.to(dev), meshes[dev], [
            Replicate() if p.is_partial() else p for p in pl])
        if any(p.is_partial() for p in pl):
            x = DTensor.from_local(x.to_local() * (1 + scale * rank),
                                   meshes[dev], pl, run_check=False,
                                   shape=t.shape, stride=t.stride())
        return x

    bad = []
    for src in itertools.product(opts, repeat=2):
        for dst in itertools.product(opts, repeat=2):
            if any(b.is_partial() and not a.is_partial()
                   for a, b in zip(src, dst)):
                continue                   # refused (the CPU tests)
            res = []
            for dev in ("cuda", "cpu"):
                x = make(full, src, 0.37, dev).detach().requires_grad_(True)
                moves = comm.host_stats["dtensor_moves"]
                y = x.redistribute(meshes[dev], dst)
                y.backward(make(gfull, dst, 0.11, dev))
                # the card's moves go through the block path, the CPU's not
                routed = comm.host_stats["dtensor_moves"] > moves
                res.append((y.to_local().detach().cpu(), x.grad.to_local()
                            .cpu(), y.to_local().is_cuda == (dev == "cuda")
                            and ((routed or src == dst) if dev == "cuda"
                                 else not routed)))
            (y, g, ok), (y0, g0, ok0) = res
            if not (ok and ok0 and torch.equal(y, y0) and torch.equal(g, g0)):
                bad.append((str(src), str(dst)))
    return bad


def test_block_redistribute_of_card_tensors_equals_the_cpus(card, tmp_path):
    """On a (2, 2) mesh of 4 processes sharing the card: DTensor's
    `redistribute` of card tensors (through `api._dtensor_move`, the
    "gloo-host" block path) gives, for every pair of
    placements of {Shard(0), Shard(1), Replicate, Partial}, the bits of
    DTensor's own redistribute of the same tensors on the CPU, forward and
    backward, on a shape whose dim 1 splits unevenly."""
    from repro_torch.launch.mesh import run_in_processes
    for bad in run_in_processes(_moves_rank, 4, store_dir=tmp_path,
                                timeout=RANK_TIMEOUT):
        assert bad == []


def _grads_rank(rank, world, arch):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import place_model
    from repro_torch.models import init_params, loss_fn
    from repro_torch.parallel import ParallelContext, comm
    from repro_torch.parallel import sharding as sh
    from repro_torch.serving.engine import place_batch, whole
    from repro_torch.training.accumulate import value_and_grad
    from repro_torch.training.tree import tree_items
    _tf32_off()
    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    cfg = get_smoke_config(arch)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.float32)
    tokens = torch.randint(1, cfg.vocab_size, (2, 16), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    (loss0, _), grads0 = value_and_grad(
        lambda p, b: loss_fn(p, cfg, b), model, {"tokens": tokens})
    ctx = ParallelContext(mesh, profile="2d")
    comm.reset_host_stats()
    placed = place_model(model, sh.param_pspecs(ctx, cfg, model), mesh)
    with implicit_replication():
        (loss, _), grads = value_and_grad(
            lambda p, b: loss_fn(p, cfg, b, parallel=ctx), placed,
            place_batch(ctx, cfg, {"tokens": tokens}))
        want = dict(tree_items(grads0))
        worst = max(float(((whole(g) - want[path]).abs()
                           / (GRAD_ATOL + GRAD_RTOL * want[path].abs()))
                          .max()) for path, g in tree_items(grads))
        return (float(whole(loss)), float(loss0), worst,
                sorted(comm.host_stats["transports"]))


GRAD_RTOL, GRAD_ATOL, LOSS_RTOL = 2e-4, 2e-5, 1e-5


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b"])
def test_loss_and_gradients_on_two_ranks_sharing_the_card(card, tmp_path,
                                                          arch):
    """`loss_fn` and its gradients on a (data 1, model 2) mesh under "2d",
    2 processes sharing the card, equal one device's within
    tests/test_torch_train_grads.py's tolerances (loss rtol 1e-5;
    gradients rtol 2e-4, atol 2e-5), every move through host memory."""
    from repro_torch.launch.mesh import run_in_processes
    for loss, loss0, worst, how in run_in_processes(
            _grads_rank, 2, arch, store_dir=tmp_path, timeout=RANK_TIMEOUT):
        assert abs(loss - loss0) <= LOSS_RTOL * abs(loss0), (loss, loss0)
        assert worst <= 1.0 and how == ["gloo-host"], (worst, how)
