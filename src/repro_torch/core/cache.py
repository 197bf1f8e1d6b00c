"""Cache policies (§4.1.2).

SSSP/BFS cache: pre-load vertices within k hops of the entry point —
DiskANN's static strategy (the one the paper evaluates).

Frequency cache: BEYOND-PAPER ablation — the paper lists frequency-based
caching (Starling-style) but only benchmarks SSSP; we implement it by
replaying a sample workload through the in-memory traversal and caching the
most-expanded vertices. A copy of src/repro/core/cache.py whose frequency
replay runs the port's beam_search_mem on `device`.
"""
from __future__ import annotations

from collections import deque

import numpy as np


def sssp_cache(graph: np.ndarray, medoid: int, budget_frac: float) -> np.ndarray:
    """Returns boolean (n,) mask of cached vertices (BFS-closest from the
    entry point until the budget is exhausted)."""
    n = graph.shape[0]
    budget = int(max(0, round(budget_frac * n)))
    cached = np.zeros(n, bool)
    if budget == 0:
        return cached
    seen = np.zeros(n, bool)
    dq = deque([medoid])
    seen[medoid] = True
    count = 0
    while dq and count < budget:
        u = dq.popleft()
        cached[u] = True
        count += 1
        for v in graph[u]:
            v = int(v)
            if v >= 0 and not seen[v]:
                seen[v] = True
                dq.append(v)
    return cached


def frequency_cache(graph: np.ndarray, vectors: np.ndarray, medoid: int,
                    sample_queries: np.ndarray, budget_frac: float,
                    L: int = 48, width: int = 4,
                    device=None) -> np.ndarray:
    """Workload-aware cache: replay a query sample through the traversal and
    cache the most-frequently-expanded vertices (beyond-paper ablation)."""
    from repro_torch.core.searchutils import SENTINEL
    from repro_torch.core.vamana import beam_search_mem

    n = graph.shape[0]
    budget = int(max(0, round(budget_frac * n)))
    cached = np.zeros(n, bool)
    if budget == 0 or len(sample_queries) == 0:
        return cached
    res = beam_search_mem(vectors, graph, medoid, sample_queries,
                          L=L, width=width, device=device)
    vis = np.asarray(res["visited_ids"]).reshape(-1)
    vis = vis[vis < int(SENTINEL)]
    counts = np.bincount(vis, minlength=n)
    top = np.argsort(-counts)[:budget]
    cached[top[counts[top] > 0]] = True
    # fill any remainder from the entry point's BFS neighborhood
    if cached.sum() < budget:
        extra = sssp_cache(graph, medoid, budget_frac)
        cached |= extra
    return cached
