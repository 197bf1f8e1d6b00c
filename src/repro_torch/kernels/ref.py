"""Plain PyTorch versions of the page kernels: what each kernel computes,
written with tensor operations. The wrappers in ops.py use them for
tensors on the CPU; on the card they are what the kernels are held
against."""
from __future__ import annotations

import torch


def page_scan_ref(pages, page_ids, q):
    """pages (P, n_p, d); page_ids (W,) int; q (Q, d).
    Returns (W, n_p, Q) f32: squared L2 from every record of every
    scheduled page to every query."""
    g = pages[page_ids.long()].float()                        # (W, n_p, d)
    qf = q.float()
    x2 = torch.sum(g * g, -1)[..., None]                      # (W, n_p, 1)
    q2 = torch.sum(qf * qf, -1)[None, None, :]                # (1, 1, Q)
    xq = torch.einsum("wnd,qd->wnq", g, qf)
    return x2 - 2.0 * xq + q2


def page_adc_ref(page_codes, page_ids, lut):
    """page_codes (P, n_p, M) uint8; page_ids (W,); lut (M, 256, Q) f32, the
    layout query_luts builds. Returns (W, n_p, Q) f32:
    sum_j lut[j, code[w, r, j], q]."""
    codes = page_codes[page_ids.long()].long()                # (W, n_p, M)
    m = codes.shape[-1]
    rows = codes + 256 * torch.arange(m, device=codes.device)  # into M*256
    flat = lut.float().reshape(m * 256, lut.shape[2])         # (M*256, Q)
    return flat[rows].sum(-2)                                 # (W, n_p, Q)


def pq_adc_ref(codes, lut):
    """codes (N, M) uint8; lut (M, 256) f32 -> (N,) f32:
    sum_j lut[j, codes[i, j]], a gather from the flat LUT and a sum."""
    m = lut.shape[0]
    rows = codes.long() + 256 * torch.arange(m, device=codes.device)
    return lut.float().reshape(m * 256)[rows].sum(-1)


def fused_page_rank_ref(pages, page_codes, page_ids, q, lut):
    """The composition of page_scan_ref and page_adc_ref over one schedule.
    Returns (exact, adc), each (W, n_p, Q) f32."""
    return (page_scan_ref(pages, page_ids, q),
            page_adc_ref(page_codes, page_ids, lut))
