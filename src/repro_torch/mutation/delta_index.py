"""Streaming-update memory tier: the delta index over fresh inserts.

FreshDiskANN-style staging: an inserted vector is NOT written to the disk
layout at insert time — it lands in this in-memory delta, is searched
exactly (bruteforce over at most `flush_threshold` vectors) alongside every
disk search, and only reaches pages when the mutable index flushes the
backlog. Until then the disk graph carries no edge to it, so the kernel
never sees a vid beyond the layout and the golden facade stays
bit-identical while the delta is empty.

The bruteforce cost is REAL and charged: `search` reports the number of
full-precision distance evaluations it performed per query, which the
mutable index folds into `QueryStats.mem_evals` — the device model then
prices delta scans exactly like any other in-memory distance work, so a
lazily-flushed fat delta visibly taxes every query's latency. (A mini-graph
over the delta is the natural upgrade once deltas outgrow bruteforce; at
`flush_threshold`-bounded sizes the scan is the honest baseline.)

The port of src/repro/mutation/delta_index.py. The backlog is host state
(numpy, as the journal and snapshots see it); `search` runs the exact scan
on the index's device in full float32 (TF32 off for its one product) and
orders with a stable sort, so ties fall as the reference's
`argsort(kind="stable")` lets them.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

INF = np.float32(np.inf)


@contextlib.contextmanager
def _full_f32():
    """Matmuls in full float32 inside the block: TF32 would round the
    operands to 10 mantissa bits and reorder near-ties."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class DeltaIndex:
    """Exact in-memory index over vectors inserted since the last flush;
    `search` scans it on `device`."""

    def __init__(self, d: int, device):
        self.d = int(d)
        self.device = torch.device(device)
        self._vecs: List[np.ndarray] = []
        self._vids: List[int] = []
        self._pos: Dict[int, int] = {}   # vid -> slot in the lists

    def __len__(self) -> int:
        return len(self._vids)

    def __contains__(self, vid: int) -> bool:
        return int(vid) in self._pos

    def insert(self, vid: int, vec: np.ndarray) -> None:
        vec = np.asarray(vec, np.float32).reshape(-1)
        if vec.shape[0] != self.d:
            raise ValueError(f"vector has dim {vec.shape[0]}, delta holds "
                             f"dim {self.d}")
        vid = int(vid)
        if vid in self._pos:
            raise ValueError(f"vid {vid} already in the delta")
        self._pos[vid] = len(self._vids)
        self._vids.append(vid)
        self._vecs.append(vec)

    def remove(self, vid: int) -> bool:
        """Delete-before-flush: the vector never existed on disk, so the
        tombstone resolves entirely in memory (swap-remove)."""
        vid = int(vid)
        pos = self._pos.pop(vid, None)
        if pos is None:
            return False
        last = len(self._vids) - 1
        if pos != last:
            self._vids[pos] = self._vids[last]
            self._vecs[pos] = self._vecs[last]
            self._pos[self._vids[pos]] = pos
        self._vids.pop()
        self._vecs.pop()
        return True

    def state(self) -> Tuple[np.ndarray, np.ndarray]:
        """Peek the backlog WITHOUT draining: (vids (m,), vecs (m, d)) in
        insertion order — the snapshot/checkpoint path (a snapshot must
        capture the delta but leave the live index untouched)."""
        if not self._vids:
            return (np.zeros(0, np.int64), np.zeros((0, self.d), np.float32))
        return (np.asarray(self._vids, np.int64),
                np.stack(self._vecs).astype(np.float32))

    def load(self, state: Tuple[np.ndarray, np.ndarray]) -> None:
        """Restore a `state()` capture into this (empty) delta, preserving
        insertion order."""
        vids, vecs = state
        if len(self):
            raise ValueError(
                f"load() needs an empty delta (holds {len(self)} vectors)")
        for vid, vec in zip(np.asarray(vids, np.int64),
                            np.asarray(vecs, np.float32)):
            self.insert(int(vid), vec)

    def drain(self) -> Tuple[np.ndarray, np.ndarray]:
        """Hand the backlog to a flush: (vids (m,), vecs (m, d)) in
        insertion order, clearing the delta."""
        if not self._vids:
            return (np.zeros(0, np.int64), np.zeros((0, self.d), np.float32))
        order = np.argsort(np.asarray(self._vids, np.int64), kind="stable")
        vids = np.asarray(self._vids, np.int64)[order]
        vecs = np.stack(self._vecs)[order].astype(np.float32)
        self._vids.clear()
        self._vecs.clear()
        self._pos.clear()
        return vids, vecs

    def search(self, queries: np.ndarray,
               k: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Exact top-k over the delta for each query. Returns
        (ids (B, k) int64 with -1 padding, dists (B, k) float32 with +inf
        padding, evals_per_query) — squared L2, matching the kernel's
        distance space so the merged heap compares like with like."""
        queries = np.asarray(queries, np.float32)
        B = queries.shape[0]
        m = len(self._vids)
        ids = np.full((B, k), -1, np.int64)
        dists = np.full((B, k), INF, np.float32)
        if m == 0:
            return ids, dists, 0
        X = torch.as_tensor(np.stack(self._vecs).astype(np.float32),
                            device=self.device)                  # (m, d)
        q = torch.as_tensor(queries, device=self.device)
        with _full_f32():
            d2 = (torch.sum(torch.square(q), 1)[:, None]
                  - 2.0 * (q @ X.T) + torch.sum(torch.square(X), 1)[None, :])
        d2 = torch.clamp(d2, min=0.0)
        take = min(k, m)
        order = torch.argsort(d2, dim=1, stable=True)[:, :take]
        top = torch.gather(d2, 1, order)
        vids = np.asarray(self._vids, np.int64)
        ids[:, :take] = vids[order.cpu().numpy()]
        dists[:, :take] = top.cpu().numpy()
        return ids, dists, m
