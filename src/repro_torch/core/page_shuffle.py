"""PageShuffle (§4.2.1) — Starling-style locality-aware page packing.

Greedy heuristic for the NP-hard packing problem: visit vertices in BFS order
from the medoid; each unassigned vertex opens a page, then the page is filled
greedily with the unassigned candidate having the most edges into the page
(ties broken by distance rank). Requires the forward AND reverse graph in
memory (the paper's Finding 6: PageShuffle is time- and memory-intensive —
we measure and report both).

The packer is exposed in pieces (`undirected_adjacency`, `bfs_order`,
`greedy_pack`) so a streaming-mutation subsystem can run the SAME greedy
heuristic on a dirty sub-neighborhood during background compaction instead
of re-shuffling the whole index. A copy of src/repro/core/page_shuffle.py:
the port imports nothing of `repro`.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import List, Sequence

import numpy as np


def undirected_adjacency(graph: np.ndarray) -> List[set]:
    """fwd ∪ rev adjacency sets of a (n, R) -1-padded edge list — the
    symmetric locality signal the packer scores candidates by."""
    n = graph.shape[0]
    fwd = [set(int(v) for v in row if v >= 0) for row in graph]
    rev = defaultdict(set)
    for u in range(n):
        for v in fwd[u]:
            rev[v].add(u)
    return [fwd[u] | rev[u] for u in range(n)]


def bfs_order(adj: Sequence[set], entry: int) -> List[int]:
    """BFS visit order from `entry`, falling back to the smallest unvisited
    id whenever a connected component is exhausted — every vertex appears
    exactly once even on disconnected graphs."""
    n = len(adj)
    order: List[int] = []
    seen = np.zeros(n, bool)
    dq = deque([entry])
    seen[entry] = True
    ptr = 0
    while len(order) < n:
        if not dq:
            while ptr < n and seen[ptr]:
                ptr += 1
            if ptr >= n:
                break
            dq.append(ptr)
            seen[ptr] = True
        u = dq.popleft()
        order.append(u)
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                dq.append(v)
    return order


def greedy_pack(adj: Sequence[set], order: Sequence[int],
                n_p: int) -> np.ndarray:
    """The greedy page filler: walk `order`; each unassigned vertex opens a
    page, then the page greedily absorbs the unassigned candidate with the
    most links into it (ties to the smallest id). Returns perm (n,) int32
    with perm[i] = the vertex stored at slot i — consecutive runs of n_p
    slots are one page."""
    n = len(adj)
    assigned = np.full(n, False)
    perm = np.empty(n, np.int32)
    out_ptr = 0
    for u in order:
        if assigned[u]:
            continue
        page = [u]
        assigned[u] = True
        # greedy fill: candidate with most links into current page
        scores = defaultdict(int)
        for v in adj[u]:
            if not assigned[v]:
                scores[v] += 1
        while len(page) < n_p and scores:
            best = max(scores.items(), key=lambda kv: (kv[1], -kv[0]))[0]
            del scores[best]
            if assigned[best]:
                continue
            page.append(best)
            assigned[best] = True
            for w in adj[best]:
                if not assigned[w]:
                    scores[w] += 1
        for v in page:
            perm[out_ptr] = v
            out_ptr += 1
    return perm


def shuffle_order(graph: np.ndarray, medoid: int, n_p: int,
                  seed: int = 0) -> dict:
    """Returns dict(perm (n,) int32, stats). perm[i] = vid at slot i.
    Deterministic for a given (graph, medoid, n_p); `seed` is accepted for
    interface symmetry with the other builders but unused (the heuristic
    breaks ties by id, not by chance)."""
    t0 = time.time()
    n = graph.shape[0]
    # forward + reverse adjacency (peak-memory cost measured for Table 6)
    adj = undirected_adjacency(graph)
    approx_mem = graph.nbytes * 2 + n * 64  # fwd + rev + bookkeeping (approx)

    # BFS order from medoid (fall back to unvisited ids for other components)
    order = bfs_order(adj, medoid)
    perm = greedy_pack(adj, order, n_p)
    # leftover singletons (opened pages may be underfull — keep slot order)
    stats = {"shuffle_s": time.time() - t0, "approx_peak_bytes": int(approx_mem)}
    return {"perm": perm, "stats": stats}
