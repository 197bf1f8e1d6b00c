"""Plain reference of the PQ codebook: k-means per subspace, worked out
again from the benchmark's own base vectors.

The codebook is trained as the paper's builder trains it (Jegou et al.,
2011): `sample` base vectors drawn without replacement by the build seed's
generator; in each of the M subspaces, Lloyd's iterations from 256 rows
drawn by a generator seeded with (build seed, subspace); a centroid that no
row chooses keeps its place. Distances are ||x||^2 - 2 x.c + ||c||^2 and the
centroid sums a one-hot product, in float32 with TF32 off, on the card where
there is one: the order of the float32 sums decides near-ties between two
centroids, and so which rows each centroid takes. Nothing here imports the
program. `precision="bfloat16"` runs the iterations in bfloat16, the
control that the comparison has to reject.
"""
from __future__ import annotations

import numpy as np
import torch


def train(vectors: np.ndarray, m: int, seed: int, sample: int, iters: int,
          k: int = 256, precision: str = "float32") -> np.ndarray:
    """(M, k, dsub) float32 centroids."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    dt = torch.float32 if precision == "float32" else torch.bfloat16
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        n, d = vectors.shape
        dsub = d // m
        rows = np.random.default_rng(seed).choice(n, min(sample, n),
                                                  replace=False)
        xs = torch.as_tensor(np.ascontiguousarray(vectors[rows], np.float32),
                             device=dev).reshape(-1, m, dsub)
        ns = xs.shape[0]
        out = []
        for j in range(m):
            x = xs[:, j].contiguous().to(dt)
            init = np.random.default_rng([seed, j]).choice(ns, k,
                                                           replace=ns < k)
            c = x[torch.as_tensor(init, device=dev)]
            x2 = torch.sum(x * x, 1)[:, None]
            for _ in range(iters):
                dist = x2 - 2.0 * (x @ c.T) + torch.sum(c * c, 1)[None, :]
                a = torch.argmin(dist, 1)
                onehot = torch.nn.functional.one_hot(a, k).to(dt)
                counts = onehot.sum(0)
                mean = (onehot.T @ x) / torch.clamp(counts[:, None], min=1.0)
                c = torch.where(counts[:, None] > 0, mean, c)
            out.append(c.float())
        return torch.stack(out).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def gap(mine: np.ndarray, ref: np.ndarray) -> float:
    """The largest distance between a centroid and the reference's, relative
    to the reference centroid's norm or the median centroid's, whichever is
    larger (some centroids lie near the origin)."""
    if mine.shape != ref.shape:
        return float("inf")
    norms = np.linalg.norm(ref, axis=-1)
    scale = np.maximum(norms, np.median(norms))
    err = np.linalg.norm(mine.astype(np.float64) - ref, axis=-1)
    return float(np.max(err / np.maximum(scale, 1e-30)))
