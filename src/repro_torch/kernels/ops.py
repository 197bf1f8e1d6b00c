"""Wrappers of the kernels, with the reference's bucketing semantics.

Each page-kernel wrapper pads the page-id schedule up to a power-of-two
bucket with page 0 (always a valid page) and slices the result back, as
src/repro/kernels/ops.py does; `pq_adc` pads its length to a bucket. On
the TPU the buckets bounded recompiles; here they keep the launch shapes,
and so the kernels' work, the same as the reference's for the same input.

Dispatch is by the device of the tensors: a tensor on the CPU takes the
plain version in ref.py; a CUDA tensor launches the hand-written kernel of
csrc/ (built on first use by _build.py) or raises. There is no fallback from
one to the other. `launches` counts the kernel launches of each wrapper, so
a run can show that its path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (_check, _on_card, _raise_on, _stream,
                                         launches)
from repro_torch.kernels.pq_adc import pq_adc_padded
from repro_torch.kernels.ref import (dedup_merge_topL_ref,
                                     fused_page_rank_ref, page_adc_ref,
                                     page_scan_ref)

_MIN_BUCKET = 4     # smallest width bucket (floor of the power-of-two ladder)


def bucket_size(n: int, floor: int = _MIN_BUCKET) -> int:
    """Next power of two >= n (>= floor)."""
    if n < 1:
        raise ValueError(f"bucket_size needs n >= 1, got {n}")
    b = floor
    while b < n:
        b *= 2
    return b


def _pad_ids(page_ids, bucket: int):
    """Pad a page-id schedule to its bucket with id 0."""
    w = page_ids.shape[0]
    if w == bucket:
        return page_ids
    return torch.cat([page_ids, page_ids.new_zeros(bucket - w)])


def _check_ids(ids, num_pages: int) -> None:
    lo, hi = torch.stack(torch.aminmax(ids)).tolist()   # one device sync
    if lo < 0 or hi >= num_pages:
        raise IndexError(f"page ids span [{lo}, {hi}], outside the "
                         f"{num_pages} pages")


_VEC_TYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_scan_args(pages, ids, q) -> None:
    _check("pages", pages, _VEC_TYPES, 3)
    _check("q", q, (pages.dtype,), 2)
    _check("page_ids", ids, (torch.int32,), 1)
    if q.shape[1] != pages.shape[2]:
        raise ValueError(f"q width {q.shape[1]} != page width "
                         f"{pages.shape[2]}")


def _check_adc_args(page_codes, ids, lut) -> None:
    _check("page_codes", page_codes, (torch.uint8,), 3)
    _check("lut", lut, (torch.float32,), 3)
    _check("page_ids", ids, (torch.int32,), 1)
    if lut.shape[:2] != (page_codes.shape[2], 256):
        raise ValueError(f"lut {tuple(lut.shape)} is not (M, 256, Q) for "
                         f"{page_codes.shape[2]} subspaces of 256 codes")


def launch_page_scan(pages, ids, q, out=None):
    """The page_scan kernel on an already padded, checked int32 schedule.
    out (W, n_p, Q) f32 is made here unless given; the kernel computes the
    norms itself."""
    _, n_p, d = pages.shape
    w, nq = ids.shape[0], q.shape[0]
    if out is None:
        out = torch.empty((w, n_p, nq), dtype=torch.float32,
                          device=pages.device)
    fn = getattr(_build.library("page_scan"),
                 f"page_scan_{_SUFFIX[pages.dtype]}")
    _raise_on(fn(pages.data_ptr(), ids.data_ptr(), q.data_ptr(),
                 out.data_ptr(), w, n_p, d, nq, _stream(pages)), "page_scan")
    return out


def launch_page_adc(page_codes, ids, lut, out=None):
    """The page_adc kernel on an already padded, checked int32 schedule and
    an (M, 256, Q) LUT. out (W, n_p, Q) f32 is made here unless given."""
    _, n_p, m = page_codes.shape
    w, nq = ids.shape[0], lut.shape[2]
    if out is None:
        out = torch.empty((w, n_p, nq), dtype=torch.float32,
                          device=page_codes.device)
    fn = _build.library("page_adc").page_adc_f32
    _raise_on(fn(page_codes.data_ptr(), ids.data_ptr(), lut.data_ptr(),
                 out.data_ptr(), w, n_p, m, nq, _stream(page_codes)),
              "page_adc")
    return out


def launch_fused_page_rank(pages, page_codes, ids, q, lut, out=None):
    """The fused kernel on an already padded, checked int32 schedule and an
    (M, 256, Q) LUT. out, a pair of (W, n_p, Q) f32, is made here unless
    given."""
    _, n_p, d = pages.shape
    m = page_codes.shape[2]
    w, nq = ids.shape[0], q.shape[0]
    if out is None:
        exact = torch.empty((w, n_p, nq), dtype=torch.float32,
                            device=pages.device)
        out = (exact, torch.empty_like(exact))
    fn = getattr(_build.library("fused_page_rank"),
                 f"fused_page_rank_{_SUFFIX[pages.dtype]}")
    _raise_on(fn(pages.data_ptr(), page_codes.data_ptr(), ids.data_ptr(),
                 q.data_ptr(), lut.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), w, n_p, d, m, nq,
                 _stream(pages)), "fused_page_rank")
    return out


def page_scan(pages, page_ids, q, *, ids_checked: bool = False):
    """Exact squared L2 of every record of each scheduled page to every
    query: pages (P, n_p, d) f32|bf16; page_ids (W,); q (Q, d) of the
    pages' type -> (W, n_p, Q) f32. On the card the ids are range-checked
    (one device round trip) unless the caller has checked them:
    `ids_checked=True`."""
    w = page_ids.shape[0]
    ids = _pad_ids(page_ids.to(torch.int32), bucket_size(w))
    if not _on_card(pages, ids, q):
        return page_scan_ref(pages, ids, q)[:w]
    _check_scan_args(pages, ids, q)
    if not ids_checked:
        _check_ids(ids, pages.shape[0])
    out = launch_page_scan(pages, ids, q)
    launches["page_scan"] += 1
    return out[:w]


def page_adc(page_codes, page_ids, lut, *, ids_checked: bool = False):
    """Each query's ADC distance to every record of each scheduled page:
    page_codes (P, n_p, M) uint8; page_ids (W,); lut (M, 256, Q) f32, as
    query_luts lays it out -> (W, n_p, Q) f32. `ids_checked` as in
    page_scan."""
    w = page_ids.shape[0]
    ids = _pad_ids(page_ids.to(torch.int32), bucket_size(w))
    if not _on_card(page_codes, ids, lut):
        return page_adc_ref(page_codes, ids, lut)[:w]
    _check_adc_args(page_codes, ids, lut)
    if not ids_checked:
        _check_ids(ids, page_codes.shape[0])
    out = launch_page_adc(page_codes, ids, lut)
    launches["page_adc"] += 1
    return out[:w]


def fused_page_rank(pages, page_codes, page_ids, q, lut, *,
                    ids_checked: bool = False):
    """page_scan and page_adc of one schedule in one pass:
    returns (exact, adc), each (W, n_p, Q) f32."""
    w = page_ids.shape[0]
    ids = _pad_ids(page_ids.to(torch.int32), bucket_size(w))
    if not _on_card(pages, page_codes, ids, q, lut):
        exact, adc = fused_page_rank_ref(pages, page_codes, ids, q, lut)
        return exact[:w], adc[:w]
    _check_scan_args(pages, ids, q)
    _check_adc_args(page_codes, ids, lut)
    if page_codes.shape[:2] != pages.shape[:2]:
        raise ValueError(f"page_codes {tuple(page_codes.shape)} and pages "
                         f"{tuple(pages.shape)} disagree on (P, n_p)")
    if lut.shape[2] != q.shape[0]:
        raise ValueError(f"lut {tuple(lut.shape)} holds {lut.shape[2]} "
                         f"queries, q holds {q.shape[0]}")
    if not ids_checked:
        _check_ids(ids, pages.shape[0])
    exact, adc = launch_fused_page_rank(pages, page_codes, ids, q, lut)
    launches["fused_page_rank"] += 1
    return exact[:w], adc[:w]


def pq_adc(codes, lut, block_n: int = 512):
    """ADC LUT scan over PQ codes: codes (N, M) uint8; lut (M, 256) f32 ->
    (N,) f32. Length-bucketed above the kernel's own block padding, as the
    reference is: the launch covers N's power-of-two bucket, with the true
    length as `nvalid` and the pad rows +inf, and the result is sliced to
    N. The pad is by length: no codes are copied."""
    n = codes.shape[0]
    b = bucket_size(n, floor=min(block_n, bucket_size(n)))
    return pq_adc_padded(codes, lut, b + (-b) % block_n, n)[:n]


MERGE_MAX_N = 16384   # csrc/merge_topl.cu sorts a row in one block


def dedup_merge_topL(ids, keys, flags, L: int, *, sentinel: int,
                     inf: float):
    """The search pool's merge (core/searchutils.py): ids (B, N) int,
    `sentinel` the padding id; keys (B, N, K) f32, column 0 the ranking key;
    flags (B, N, F) bool. Returns ids (B, L), keys (B, L, K) and flags
    (B, L, F): the unique ids, each one's min keys and OR'd flags, sorted
    by key column 0, `sentinel` in the slots past them. On the card one
    launch of csrc/merge_topl.cu, equal to dedup_merge_topL_ref bit for
    bit, which takes ids int64 holding int32 values, keys f32 and flags
    bool, all contiguous, K and F in {1, 2} and 1 <= L <= N <=
    MERGE_MAX_N."""
    if not _on_card(ids, keys, flags):
        return dedup_merge_topL_ref(ids, keys, flags, L, sentinel=sentinel,
                                    inf=inf)
    _check("ids", ids, (torch.int64,), 2)
    _check("keys", keys, (torch.float32,), 3)
    _check("flags", flags, (torch.bool,), 3)
    b, n = ids.shape
    k, f = keys.shape[2], flags.shape[2]
    if keys.shape[:2] != ids.shape or flags.shape[:2] != ids.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and flags "
                         f"{tuple(flags.shape)} do not match ids "
                         f"{tuple(ids.shape)}")
    if k not in (1, 2) or f not in (1, 2):
        raise ValueError(f"dedup_merge_topL takes 1 or 2 key and flag "
                         f"columns on the card, got {k} and {f}")
    if not 1 <= L <= n <= MERGE_MAX_N:
        raise ValueError(f"dedup_merge_topL takes 1 <= L <= N <= "
                         f"{MERGE_MAX_N} on the card, got L = {L}, N = {n}")
    dev = ids.device
    out = (torch.empty((b, L), dtype=torch.int64, device=dev),
           torch.empty((b, L, k), dtype=torch.float32, device=dev),
           torch.empty((b, L, f), dtype=torch.bool, device=dev))
    if b:
        fn = _build.library("merge_topl").merge_topl
        _raise_on(fn(ids.data_ptr(), keys.data_ptr(), flags.data_ptr(), b, n,
                     k, f, L, sentinel, inf, *(o.data_ptr() for o in out),
                     _stream(ids)), "merge_topl")
        launches["dedup_merge_topL"] += 1
    return out
