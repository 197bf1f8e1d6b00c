"""Wrappers of the page kernels, with the reference's bucketing semantics.

Each wrapper pads the page-id schedule up to a power-of-two bucket with
page 0 (always a valid page) and slices the result back, as
src/repro/kernels/ops.py does. On the TPU the buckets bounded recompiles;
here they keep the launch shapes, and so the kernels' work, the same as the
reference's for the same schedule.

Dispatch is by the device of the tensors: a tensor on the CPU takes the
plain version in ref.py; a CUDA tensor launches the hand-written kernel of
csrc/ (built on first use by _build.py) or raises. There is no fallback from
one to the other. `launches` counts the kernel launches of each wrapper, so
a run can show that its path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (fused_page_rank_ref, page_adc_ref,
                                     page_scan_ref)

_MIN_BUCKET = 4     # smallest width bucket (floor of the power-of-two ladder)

launches = {"page_scan": 0, "page_adc": 0, "fused_page_rank": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def _on_card(*tensors) -> bool:
    """True for CUDA tensors (all on one device), False for CPU tensors;
    raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"page kernels take tensors all on the CPU or all "
                         f"on one CUDA device, got "
                         f"{sorted(str(t.device) for t in tensors)}")
    return True


def _check(name: str, t, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_ids(ids, num_pages: int) -> None:
    lo, hi = torch.stack(torch.aminmax(ids)).tolist()   # one device sync
    if lo < 0 or hi >= num_pages:
        raise IndexError(f"page ids span [{lo}, {hi}], outside the "
                         f"{num_pages} pages")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


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


def launch_page_scan(pages, ids, q, qsq=None, out=None):
    """The page_scan kernel on an already padded, checked int32 schedule.
    qsq (Q,) f32 and out (W, n_p, Q) f32 are made here unless given."""
    _, n_p, d = pages.shape
    w, nq = ids.shape[0], q.shape[0]
    if qsq is None:
        qsq = torch.sum(torch.square(q.float()), -1)
    if out is None:
        out = torch.empty((w, n_p, nq), dtype=torch.float32,
                          device=pages.device)
    fn = getattr(_build.library("page_scan"),
                 f"page_scan_{_SUFFIX[pages.dtype]}")
    _raise_on(fn(pages.data_ptr(), ids.data_ptr(), q.data_ptr(),
                 qsq.data_ptr(), out.data_ptr(), w, n_p, d, nq,
                 _stream(pages)), "page_scan")
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


def launch_fused_page_rank(pages, page_codes, ids, q, lut, qsq=None,
                           out=None):
    """The fused kernel on an already padded, checked int32 schedule and an
    (M, 256, Q) LUT. qsq (Q,) f32 and out, a pair of (W, n_p, Q) f32, are
    made here unless given."""
    _, n_p, d = pages.shape
    m = page_codes.shape[2]
    w, nq = ids.shape[0], q.shape[0]
    if qsq is None:
        qsq = torch.sum(torch.square(q.float()), -1)
    if out is None:
        exact = torch.empty((w, n_p, nq), dtype=torch.float32,
                            device=pages.device)
        out = (exact, torch.empty_like(exact))
    fn = getattr(_build.library("fused_page_rank"),
                 f"fused_page_rank_{_SUFFIX[pages.dtype]}")
    _raise_on(fn(pages.data_ptr(), page_codes.data_ptr(), ids.data_ptr(),
                 q.data_ptr(), qsq.data_ptr(), lut.data_ptr(),
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
