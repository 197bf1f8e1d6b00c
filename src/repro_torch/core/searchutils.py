"""Fixed-size candidate-list primitives shared by the Vamana builder, the
MemGraph navigator and the disk-page search engine, batched over queries.

The candidate list is the DiskANN search pool: ids sorted by ranking key,
each entry carrying (expanded?, exact-distance-known?) flags. Every function
takes a leading batch dimension B written out, where the reference maps a
single-query function with `vmap`.

Every sort is stable (`torch.sort(..., stable=True)`): ties among padded
SENTINEL ids and INF keys decide which candidates survive a top-L cut, and
the reference's `jnp.argsort` is stable, so an unstable sort would change
results. `topk` is not used for the same reason.
"""
from __future__ import annotations

import torch

SENTINEL = 2 ** 30   # padding id; sorts after every real id (int32 range)
INF = 3e38           # padding key, compared in float32


def sq_dists(q, X):
    """q (..., d) against X (..., n, d) -> squared L2 (..., n)."""
    diff = q[..., None, :] - X
    return torch.sum(torch.square(diff), dim=-1)


def _take(x, idx):
    """Gather rows of x (B, N, ...) by idx (B, K) along dim 1."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(shape))


def _segmented_min_or(ids, keys, flags):
    """ids (B, N) sorted ascending per row. Within equal-id runs: min over
    keys (per column) and OR over flags (per column), accumulated into the
    FIRST element of each run, by doubling shifts (exact for any run
    length)."""
    n = ids.shape[1]
    shift = 1
    while shift < n:
        same = torch.zeros_like(ids, dtype=torch.bool)
        same[:, :-shift] = ids[:, :-shift] == ids[:, shift:]
        sk = torch.full_like(keys, INF)
        sk[:, :-shift] = keys[:, shift:]
        keys = torch.where(same[..., None], torch.minimum(keys, sk), keys)
        sf = torch.zeros_like(flags)
        sf[:, :-shift] = flags[:, shift:]
        flags = torch.where(same[..., None], flags | sf, flags)
        shift *= 2
    return keys, flags


def dedup_merge_topL(ids, keys, flags, L: int):
    """ids (B, N) int (SENTINEL padding); keys (B, N, K) f32, column 0 the
    ranking key; flags (B, N, F) bool. Returns (ids, keys, flags) of length
    L per row: unique ids, best (min) keys and OR'd flags per id, sorted by
    keys[..., 0]."""
    order = torch.sort(ids, dim=1, stable=True).indices
    ids, keys, flags = _take(ids, order), _take(keys, order), _take(flags, order)
    keys, flags = _segmented_min_or(ids, keys, flags)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = ids[:, 1:] != ids[:, :-1]
    rank_key = torch.where(first & (ids < SENTINEL), keys[..., 0],
                           torch.full_like(keys[..., 0], INF))
    order2 = torch.sort(rank_key, dim=1, stable=True).indices[:, :L]
    out_ids = torch.where(_take(rank_key, order2) < INF, _take(ids, order2),
                          torch.full_like(order2, SENTINEL, dtype=ids.dtype))
    return out_ids, _take(keys, order2), _take(flags, order2)


def top_w_unexpanded(keys0, expanded, valid, w_static: int, w_dynamic=None):
    """Indices of the best w unexpanded valid candidates of each row.
    keys0, expanded, valid (B, N). Returns (idx (B, w_static), active
    (B, w_static) bool). w_dynamic ((B,) ints <= w_static) masks the
    selection width per row (DynamicWidth)."""
    masked = torch.where(valid & ~expanded, keys0,
                         torch.full_like(keys0, INF))
    idx = torch.sort(masked, dim=1, stable=True).indices[:, :w_static]
    active = torch.gather(masked, 1, idx) < INF
    if w_dynamic is not None:
        cols = torch.arange(idx.shape[1], device=idx.device)
        active = active & (cols[None, :] < w_dynamic[:, None])
    return idx, active
