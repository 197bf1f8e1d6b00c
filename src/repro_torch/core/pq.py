"""Product Quantization (Jegou et al. 2011) — the paper's memory-layout
baseline technique (§4.1.1): compressed codes live in the fast tier and give
approximate distances without touching the capacity tier; full-precision
vectors on "disk" are used only for re-ranking.

The port of src/repro/core/pq.py. k-means and encoding run with torch on the
caller's device in full float32. One difference: the reference seeds each
subspace's k-means from `jax.random.choice`, whose stream torch cannot
reproduce; the port draws the initial centroids with a seeded numpy
generator instead, so its centroids differ from the reference's while
`encode` and `lut` agree given the same centroids.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device


@dataclasses.dataclass
class PQ:
    centroids: np.ndarray  # (M, 256, dsub) float32
    codes: np.ndarray      # (n, M) uint8
    m: int
    dsub: int

    @property
    def memory_bytes(self) -> int:
        return self.codes.nbytes + self.centroids.nbytes

    def lut(self, q: np.ndarray) -> np.ndarray:
        """ADC lookup table for query q: (M, 256) float32 of squared
        dists (a host-side helper: computed on the CPU)."""
        qs = torch.as_tensor(np.asarray(q, np.float32).reshape(self.m,
                                                               self.dsub))
        cent = torch.as_tensor(self.centroids)
        return torch.sum(torch.square(cent - qs[:, None, :]), -1).numpy()

    def adc(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        lut = self.lut(q)
        return lut[np.arange(self.m)[None, :], self.codes[ids]].sum(-1)


def _kmeans(x, init_idx: np.ndarray, iters: int = 12, k: int = 256):
    """x (ns, dsub) tensor -> centroids (k, dsub). Lloyd from the rows
    `init_idx`; a dead centroid keeps its previous position. The centroid
    sums are a one-hot product, as in the reference, so they are summed in
    a fixed order (no atomics) and repeat from run to run."""
    c = x[torch.as_tensor(init_idx, device=x.device)]
    x2 = torch.sum(torch.square(x), 1)[:, None]
    for _ in range(iters):
        d = x2 - 2.0 * (x @ c.T) + torch.sum(torch.square(c), 1)[None, :]
        a = torch.argmin(d, 1)
        onehot = F.one_hot(a, k).to(x.dtype)
        counts = onehot.sum(0)
        sums = onehot.T @ x
        c_new = sums / torch.clamp(counts[:, None], min=1.0)
        c = torch.where(counts[:, None] > 0, c_new, c)
    return c


def train_pq(x: np.ndarray, m: int = 16, sample: int = 16384,
             iters: int = 12, seed: int = 0, device=None) -> PQ:
    device = resolve_device(device)
    n, d = x.shape
    if d % m:
        raise ValueError(f"dimension {d} is not a multiple of pq_m={m}")
    dsub = d // m
    rng = np.random.default_rng(seed)
    sub = x[rng.choice(n, min(sample, n), replace=False)]
    xs = torch.as_tensor(np.ascontiguousarray(sub, np.float32),
                         device=device).reshape(-1, m, dsub)
    ns = xs.shape[0]
    cents = []
    for j in range(m):
        init = np.random.default_rng([seed, j]).choice(ns, 256,
                                                       replace=ns < 256)
        cents.append(_kmeans(xs[:, j].contiguous(), init, iters=iters))
    cents = torch.stack(cents).cpu().numpy()
    codes = encode(x, cents, device=device)
    return PQ(centroids=cents, codes=codes, m=m, dsub=dsub)


def encode(x: np.ndarray, centroids: np.ndarray, block: int = 8192,
           device=None) -> np.ndarray:
    """(n, M) uint8: each subvector's nearest centroid (first on ties)."""
    device = resolve_device(device)
    n, d = x.shape
    m, k, dsub = centroids.shape
    out = np.empty((n, m), np.uint8)
    cj = torch.as_tensor(np.asarray(centroids, np.float32), device=device)
    c2 = torch.sum(torch.square(cj), -1)[None]                # (1, M, k)
    for i in range(0, n, block):
        xs = torch.as_tensor(np.asarray(x[i:i + block], np.float32),
                             device=device).reshape(-1, m, dsub)
        d_ = (torch.sum(torch.square(xs), -1)[..., None]
              - 2.0 * torch.einsum("nmd,mkd->nmk", xs, cj) + c2)
        out[i:i + block] = torch.argmin(d_, -1).to(torch.uint8).cpu().numpy()
    return out
