"""Plain PyTorch versions of the kernels: what each kernel computes,
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


def _take(x, idx):
    """Gather rows of x (B, N, ...) by idx (B, K) along dim 1."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(shape))


def segmented_min_or(ids, keys, flags, *, inf: float):
    """ids (B, N) sorted ascending per row. Within equal-id runs: min over
    keys (per column) and OR over flags (per column), accumulated into the
    FIRST element of each run, by doubling shifts (exact for any run
    length); `inf` fills the shifted-in keys."""
    n = ids.shape[1]
    shift = 1
    while shift < n:
        same = torch.zeros_like(ids, dtype=torch.bool)
        same[:, :-shift] = ids[:, :-shift] == ids[:, shift:]
        sk = torch.full_like(keys, inf)
        sk[:, :-shift] = keys[:, shift:]
        keys = torch.where(same[..., None], torch.minimum(keys, sk), keys)
        sf = torch.zeros_like(flags)
        sf[:, :-shift] = flags[:, shift:]
        flags = torch.where(same[..., None], flags | sf, flags)
        shift *= 2
    return keys, flags


def dedup_merge_topL_ref(ids, keys, flags, L: int, *, sentinel: int,
                         inf: float):
    """The search pool's merge (core/searchutils.py `dedup_merge_topL`) in
    tensor ops: two stable sorts, the doubling segmented min/OR and the
    top-L cut. Every slot past the unique ids keeps its run's suffix min
    and OR, as the doubling leaves them."""
    order = torch.sort(ids, dim=1, stable=True).indices
    ids, keys, flags = _take(ids, order), _take(keys, order), _take(flags, order)
    keys, flags = segmented_min_or(ids, keys, flags, inf=inf)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = ids[:, 1:] != ids[:, :-1]
    rank_key = torch.where(first & (ids < sentinel), keys[..., 0],
                           torch.full_like(keys[..., 0], inf))
    order2 = torch.sort(rank_key, dim=1, stable=True).indices[:, :L]
    out_ids = torch.where(_take(rank_key, order2) < inf, _take(ids, order2),
                          torch.full_like(order2, sentinel, dtype=ids.dtype))
    return out_ids, _take(keys, order2), _take(flags, order2)
