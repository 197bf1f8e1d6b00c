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

`dedup_merge_topL` runs on the card as one hand-written kernel
(kernels/csrc/merge_topl.cu) and on the CPU as its plain version
(kernels/ref.py), by the kernel wrapper's dispatch (kernels/ops.py).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

SENTINEL = 2 ** 30   # padding id; sorts after every real id (int32 range)
INF = 3e38           # padding key, compared in float32


def sq_dists(q, X):
    """q (..., d) against X (..., n, d) -> squared L2 (..., n)."""
    diff = q[..., None, :] - X
    return torch.sum(torch.square(diff), dim=-1)


def dedup_merge_topL(ids, keys, flags, L: int):
    """ids (B, N) int (SENTINEL padding); keys (B, N, K) f32, column 0 the
    ranking key; flags (B, N, F) bool. Returns (ids, keys, flags) of length
    L per row: unique ids, best (min) keys and OR'd flags per id, sorted by
    keys[..., 0]. On the card N is at most ops.MERGE_MAX_N (16,384)."""
    return ops.dedup_merge_topL(ids, keys, flags, L, sentinel=SENTINEL,
                                inf=INF)


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
