"""Plain reference of the disk-index search, one query at a time, in NumPy.

It follows the published DiskANN beam search as the paper composes it
(§4): a candidate pool of the L best ids by ranking key; each hop expands
the best unexpanded candidates (the beam; DynamicWidth doubles it from
dw_min up to dw_max whenever the best key stops improving); expanding a
vertex reads its page, which is charged unless the vertex is in the
in-memory cache; every record of a read page is scored exactly (PageSearch
inserts them all into the pool); neighbours enter the pool ranked by PQ
asymmetric distance; an entry scored exactly is ranked by its exact
distance; the result is the k best exactly-scored ids. With a MemGraph the
entries come from a best-first search over the memory-resident sample
graph.

Tie rules, which decide which of equal keys survive a cut: the pool holds
each id once, with its smallest keys and the union of its flags, ordered
by (ranking key, id); after each merge an exactly-scored entry takes its
exact distance as key in place, so the pool's order is that of the merge
until the next one; the beam and the final top-k take the pool's entries
by key, and by pool position among equal keys.

Nothing here imports the program: the index's graph, page order, PQ
codebook and MemGraph graph come in as arrays, and the reference works out
the rest (PQ codes, the cache, the page map) again from its own vectors.
`precision="bfloat16"` computes every distance in bfloat16, the control
that the comparison has to reject.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

SENTINEL = np.int64(2 ** 62)
INF = np.float32(np.inf)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()


def sq_dists(q: np.ndarray, X: np.ndarray, precision: str) -> np.ndarray:
    """Squared L2 from q (d,) to each row of X (..., d), float32 out."""
    if precision == "float32":
        diff = X - q
        return np.sum(diff * diff, axis=-1, dtype=np.float32)
    t = _bf16(X) - _bf16(q)
    return (t * t).sum(-1).float().numpy()


def encode(vectors: np.ndarray, centroids: np.ndarray,
           block: int = 16384) -> np.ndarray:
    """(n, M) uint8 PQ codes: each subvector's nearest centroid (the first
    of equal ones), by ||x||^2 - 2 x.c + ||c||^2 in float32 with TF32 off,
    on the card where there is one."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m, k, dsub = centroids.shape
        c = torch.as_tensor(centroids, dtype=torch.float32, device=dev)
        c2 = torch.sum(c * c, -1)[None]
        out = np.empty((len(vectors), m), np.uint8)
        for s in range(0, len(vectors), block):
            x = torch.as_tensor(vectors[s:s + block], dtype=torch.float32,
                                device=dev).reshape(-1, m, dsub)
            d = (torch.sum(x * x, -1)[..., None]
                 - 2.0 * torch.einsum("nmd,mkd->nmk", x, c) + c2)
            out[s:s + block] = torch.argmin(d, -1).to(torch.uint8).cpu().numpy()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def bfs_cache(graph: np.ndarray, medoid: int, frac: float) -> np.ndarray:
    """DiskANN's static cache: the round(frac * n) vertices first reached by
    a breadth-first walk from the medoid, neighbours in list order."""
    n = len(graph)
    budget = int(round(frac * n))
    cached = np.zeros(n, bool)
    seen = {int(medoid)}
    todo = deque([int(medoid)])
    while todo and budget > 0:
        u = todo.popleft()
        cached[u] = True
        budget -= 1
        for v in graph[u]:
            if v >= 0 and int(v) not in seen:
                seen.add(int(v))
                todo.append(int(v))
    return cached


def medoid(x: np.ndarray) -> int:
    """The base vector nearest the mean."""
    mean = x.mean(0)
    return int(np.argmin(((x - mean) ** 2).sum(1)))


@dataclasses.dataclass
class RefIndex:
    """What the reference searches: its own vectors and codes, and the
    program's graph, page order, codebook and MemGraph graph."""
    vectors: np.ndarray      # (n, d) float32, the benchmark's own
    graph: np.ndarray        # (n, R), -1 padded
    medoid: int
    page_vids: np.ndarray    # (P, n_p), -1 padded
    centroids: np.ndarray    # (M, 256, dsub)
    codes: np.ndarray        # (n, M) uint8
    cached: np.ndarray       # (n,) bool
    vid2page: np.ndarray     # (n,)
    mem_ids: np.ndarray | None = None     # (s,) sampled vertex ids
    mem_graph: np.ndarray | None = None   # (s, R')
    mem_medoid: int = 0


def page_map(page_vids: np.ndarray, n: int) -> np.ndarray:
    """vid -> page, from the page order; -1 for a vid on no page."""
    v2p = np.full(n, -1, np.int64)
    pages = np.repeat(np.arange(page_vids.shape[0]), page_vids.shape[1])
    flat = page_vids.reshape(-1)
    ok = flat >= 0
    v2p[flat[ok]] = pages[ok]
    return v2p


def merge(ids, rank, exact, expanded, known, L):
    """Each id once (smallest keys, union of flags), the L best by
    (rank, id); ids that are padding or ranked at infinity drop out."""
    ids = np.asarray(ids, np.int64)
    ok = ids < SENTINEL
    ids, rank, exact = ids[ok], rank[ok], exact[ok]
    expanded, known = expanded[ok], known[ok]
    order = np.argsort(ids, kind="stable")
    ids, rank, exact = ids[order], rank[order], exact[order]
    expanded, known = expanded[order], known[order]
    uniq, start = np.unique(ids, return_index=True)
    if len(uniq) == 0:
        e = np.zeros(0, np.float32)
        return uniq, e, e, np.zeros(0, bool), np.zeros(0, bool)
    rank = np.minimum.reduceat(rank, start)
    exact = np.minimum.reduceat(exact, start)
    expanded = np.logical_or.reduceat(expanded, start)
    known = np.logical_or.reduceat(known, start)
    keep = rank < INF
    uniq, rank, exact = uniq[keep], rank[keep], exact[keep]
    expanded, known = expanded[keep], known[keep]
    top = np.lexsort((uniq, rank))[:L]
    return uniq[top], rank[top], exact[top], expanded[top], known[top]


def mem_entries(q, idx: RefIndex, *, n_entries: int, L: int, width: int = 2,
                precision: str = "float32"):
    """MemGraph navigation: best-first search of the sample graph from its
    medoid, `width` expansions a hop, at most 4 L hops. Returns (entry vids,
    hops)."""
    X = idx.vectors[idx.mem_ids]
    G = idx.mem_graph
    ids = np.array([idx.mem_medoid], np.int64)
    key = sq_dists(q, X[ids], precision)
    ids, key, _, exp, _ = merge(ids, key, key, np.zeros(1, bool),
                                np.zeros(1, bool), L)
    hops = 0
    while (~exp).any() and hops < 4 * L:
        sel = np.flatnonzero(~exp)[np.argsort(key[~exp], kind="stable")]
        sel = sel[:width]
        exp = exp.copy()
        exp[sel] = True
        nb = G[ids[sel]].reshape(-1)
        nb = nb[nb >= 0].astype(np.int64)
        nd = sq_dists(q, X[nb], precision)
        z = np.zeros(len(nb), bool)
        ids, key, _, exp, _ = merge(np.concatenate([ids, nb]),
                                    np.concatenate([key, nd]),
                                    np.concatenate([key, nd]),
                                    np.concatenate([exp, z]),
                                    np.concatenate([exp, z]), L)
        hops += 1
    return idx.mem_ids[ids[:n_entries]].astype(np.int64), hops


def search_one(q: np.ndarray, idx: RefIndex, cfg: dict,
               precision: str = "float32") -> dict:
    """One query's search. `cfg` holds the SearchConfig's fields by name.
    Returns ids (k,), dists (k,), hops, page_reads, cache_hits, mem_hops."""
    q = np.asarray(q, np.float32)
    k, L = cfg["k"], cfg["L"]
    dyn = cfg["dynamic_width"]
    width = max(cfg["beam_width"], cfg["dw_max"]) if dyn else cfg["beam_width"]
    width = min(width, L)
    spec = cfg["pipeline_spec"] if cfg["pipeline"] else 0
    n_p = idx.page_vids.shape[1]
    m, _, dsub = idx.centroids.shape
    if precision == "float32":
        lut = np.sum((idx.centroids - q.reshape(m, 1, dsub)) ** 2, -1,
                     dtype=np.float32)
    else:
        t = _bf16(idx.centroids) - _bf16(q.reshape(m, 1, dsub))
        lut = (t * t).sum(-1)

    def adc(ids):
        if precision == "float32":
            return lut[np.arange(m), idx.codes[ids]].sum(-1, dtype=np.float32)
        rows = torch.as_tensor(idx.codes[ids].astype(np.int64))
        return lut[torch.arange(m), rows].sum(-1).float().numpy()

    mem_hops = 0
    if cfg["memgraph_frac"] > 0 and idx.mem_ids is not None:
        entries, mem_hops = mem_entries(
            q, idx, n_entries=cfg["memgraph_entries"], L=cfg["memgraph_L"],
            precision=precision)
    else:
        entries = np.array([idx.medoid], np.int64)
    e = len(entries)
    f = np.zeros(e, bool)
    ids, rank, exact, expd, known = merge(entries, adc(entries),
                                          np.full(e, INF, np.float32), f, f,
                                          L)
    w_dyn, stall = float(cfg["dw_min"]), 0
    hops = pages = hits = 0
    while hops < cfg["max_iters"]:
        open_ = np.flatnonzero(~expd)
        if len(open_) == 0:
            break
        best_before = rank[0]
        w_sel = int(min(min(w_dyn, cfg["dw_max"]) if dyn else width, width))
        beam = open_[np.argsort(rank[open_], kind="stable")][:w_sel + spec]
        fids = ids[beam]
        hit = idx.cached[fids]
        pages += len(np.unique(idx.vid2page[fids[~hit]]))
        hits += int(hit.sum())
        recs = idx.page_vids[idx.vid2page[fids]]            # (w, n_p)
        valid = recs >= 0
        rd = sq_dists(q, idx.vectors[np.maximum(recs, 0)], precision)
        own = rd[recs == fids[:, None]]
        nb = idx.graph[fids].reshape(-1)
        nb = nb[nb >= 0].astype(np.int64)
        parts = [(ids, rank, exact, expd, known),
                 (fids, own, own, np.ones(len(fids), bool),
                  np.ones(len(fids), bool))]
        if cfg["page_search"]:
            pv, pd = recs[valid].astype(np.int64), rd[valid]
            parts.append((pv, pd, pd, np.zeros(len(pv), bool),
                          np.ones(len(pv), bool)))
        parts.append((nb, adc(nb), np.full(len(nb), INF, np.float32),
                      np.zeros(len(nb), bool), np.zeros(len(nb), bool)))
        ids, rank, exact, expd, known = merge(
            *(np.concatenate(c) for c in zip(*parts)), L)
        rank = np.where(known, exact, rank)
        improved = len(rank) > 0 and rank[0] < best_before
        stall = 0 if improved else stall + 1
        if dyn and stall > 0:
            w_dyn = min(w_dyn * 2.0, float(cfg["dw_max"]))
        hops += 1
    final = np.where(known, exact, INF)
    top = np.argsort(final, kind="stable")[:k]
    out_ids = np.full(k, -1, np.int64)
    out_d = np.full(k, INF, np.float32)
    good = final[top] < INF
    out_ids[:len(top)][good] = ids[top][good]
    out_d[:len(top)][good] = final[top][good]
    return {"ids": out_ids, "dists": out_d, "hops": hops, "page_reads": pages,
            "cache_hits": hits, "mem_hops": mem_hops}
