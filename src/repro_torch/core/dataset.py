"""Synthetic stand-ins for the paper's four datasets + exact ground truth.

The paper evaluates SIFT(128d)/DEEP(96d)/SPACEV(100d int8)/GIST(960d) at
10^8 scale; the engine here is scale-free, so we generate clustered mixtures
matching each dataset's dimensionality/dtype regime at a CPU-friendly scale
(default n=32768, override with REPRO_ANN_N). Ground truth is exact brute force, computed with torch on the dataset's
device. The port of src/repro/core/dataset.py: `make_dataset` makes its data
with the same numpy calls, so a seed gives the same vectors and queries as
the reference.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass
class Dataset:
    name: str
    vectors: np.ndarray   # (n, d) float32
    queries: np.ndarray   # (nq, d) float32
    gt: np.ndarray        # (nq, k_gt) int32 — exact nearest neighbors
    dtype_tag: str        # "float" | "uint8" | "int8" (paper's storage dtype)

    @property
    def n(self):
        return self.vectors.shape[0]

    @property
    def d(self):
        return self.vectors.shape[1]

    @property
    def record_bytes(self):
        per = {"float": 4, "uint8": 1, "int8": 1}[self.dtype_tag]
        return self.d * per


_SPECS = {
    # name: (dim, dtype_tag, n_clusters)
    "sift-like": (128, "uint8", 64),
    "deep-like": (96, "float", 64),
    "spacev-like": (100, "int8", 48),
    "gist-like": (960, "float", 32),
}

DATASET_NAMES = tuple(_SPECS)


def default_scale() -> int:
    return int(os.environ.get("REPRO_ANN_N", 32768))


def make_dataset(name: str, n: Optional[int] = None, nq: int = 256,
                 k_gt: int = 100, seed: int = 0, device=None) -> Dataset:
    """The data is made on the host with numpy; the ground truth is
    computed on `device` ("cuda" unless named)."""
    device = resolve_device(device)
    dim, tag, n_clusters = _SPECS[name]
    n = n or default_scale()
    # zlib.crc32: stable across processes (hash() is salted per process,
    # which would silently invalidate disk-cached graphs between runs)
    import zlib
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 10000)
    # Clustered data on a low-dimensional nonlinear manifold: real SIFT/DEEP/
    # GIST embeddings have intrinsic dimensionality ~10-20, which is what
    # makes proximity-graph search effective. (I.i.d. high-dim Gaussian
    # blobs suffer distance concentration and disconnect kNN graphs —
    # unrepresentative of the paper's datasets.)
    k_lat = int(np.clip(dim // 12, 8, 16))
    centers = rng.normal(0, 1.0, (n_clusters, k_lat)).astype(np.float32)
    w1 = rng.normal(0, 1.0, (k_lat, 4 * k_lat)).astype(np.float32) / np.sqrt(k_lat)
    w2 = rng.normal(0, 1.0, (4 * k_lat, dim)).astype(np.float32) / np.sqrt(4 * k_lat)

    def lift(z):
        return (np.tanh(z @ w1) @ w2 + 0.05 * rng.normal(
            0, 1.0, (len(z), dim))).astype(np.float32)

    z = centers[rng.integers(0, n_clusters, n)] + 0.6 * rng.normal(
        0, 1.0, (n, k_lat)).astype(np.float32)
    x = lift(z)
    zq = centers[rng.integers(0, n_clusters, nq)] + 0.6 * rng.normal(
        0, 1.0, (nq, k_lat)).astype(np.float32)
    q = lift(zq)
    if tag in ("uint8", "int8"):
        # quantize into the integer range like SIFT/SPACEV storage
        lo, hi = (0, 255) if tag == "uint8" else (-128, 127)
        scale = 80.0 / max(np.abs(x).max(), 1e-6)
        x = np.clip(np.round(x * scale + (128 if tag == "uint8" else 0)),
                    lo, hi).astype(np.float32)
        q = np.clip(np.round(q * scale + (128 if tag == "uint8" else 0)),
                    lo, hi).astype(np.float32)
    gt = exact_ground_truth(x, q, k_gt, device=device)
    return Dataset(name, x, q, gt, tag)


def exact_ground_truth(x: np.ndarray, q: np.ndarray, k: int,
                       block: int = 256, device=None) -> np.ndarray:
    """Chunked brute force on `device` in full float32 (no TF32): the k
    nearest base vectors of each query, nearest first."""
    device = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    xn = torch.sum(torch.square(xt), 1)
    out = np.empty((len(q), k), np.int32)
    for i in range(0, len(q), block):
        qb = torch.as_tensor(np.asarray(q[i:i + block], np.float32),
                             device=device)
        d = xn[None, :] - 2.0 * (qb @ xt.T)   # + ||q||^2 (constant per row)
        idx = torch.topk(d, k, dim=1, largest=False, sorted=True).indices
        out[i:i + block] = idx.cpu().numpy()
    return out


def recall_at_k(result_ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Recall@k = |result ∩ gt_k| / k averaged over queries."""
    hits = 0
    for r, g in zip(result_ids[:, :k], gt[:, :k]):
        hits += len(set(int(v) for v in r if v >= 0) & set(int(v) for v in g))
    return hits / (len(gt) * k)
