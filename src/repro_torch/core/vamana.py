"""Vamana graph construction (DiskANN's logical graph), batched in torch.

The port of src/repro/core/vamana.py. Algorithm (Subramanya et al. 2019),
batch-parallel variant (parlayANN-style): start from a random R-regular
graph, then two refinement passes (alpha=1.0, then alpha) — for each batch
of nodes: greedy-search the current graph to collect the visited set V,
RobustPrune(V ∪ N(x)) into new out-edges, then add reverse edges and
re-prune overfull nodes. The random initial graph and node order come from
the same numpy generator calls as the reference, so a seed gives the same
start. Deterministic given the seed, on the card too: the one scatter with
colliding targets (reverse edges) resolves its collisions explicitly.

Also exports `beam_search_mem`, the in-memory best-first search used for
build and for the MemGraph navigation layer. One of its iterations
(`_mem_hop`) has fixed shapes and no host sync; for a caller whose vectors
and graph stay on the card (the MemGraph), it replays as a captured CUDA
graph, and everywhere else it runs op by op. The loop runner is
core/hop_loop.py, shared with the disk loop.
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.hop_loop import hop_loop
from repro_torch.core.searchutils import (INF, SENTINEL, dedup_merge_topL,
                                          sq_dists, top_w_unexpanded)


def medoid(x: np.ndarray) -> int:
    mean = x.mean(0)
    return int(np.argmin(((x - mean) ** 2).sum(1)))


# ---------------------------------------------------------------------------
# in-memory best-first / beam search


class _MemInputs(NamedTuple):
    """What a MemGraph hop reads besides the state: the graph's vectors X
    (n, d) f32 and adjacency G (n, R) int64 (read in place), the queries q
    (B, d) f32, and span = arange(width)."""
    X: torch.Tensor
    G: torch.Tensor
    q: torch.Tensor
    span: torch.Tensor


class _MemState(NamedTuple):
    """The state a MemGraph hop maps to the next, each (B, ...): the
    candidate list (ids (B, L); keys (B, L, 1) distances; flags (B, L, 1)
    expanded), the visited window (vis_ids, vis_d (B, V)), iterations
    taken (it) and the visited count (vn)."""
    ids: torch.Tensor
    keys: torch.Tensor
    flags: torch.Tensor
    vis_ids: torch.Tensor
    vis_d: torch.Tensor
    it: torch.Tensor
    vn: torch.Tensor


def _mem_live(st, max_iters):
    """(B,) bool: the query has an unexpanded candidate and hops left."""
    return ((st.ids < SENTINEL) & ~st.flags[..., 0]).any(1) & (
        st.it < max_iters)


def _mem_hop(t, st, live, *, L, width, visited_cap):
    """One MemGraph hop of every live query; a query that is not live keeps
    its state. Fixed shapes, no host sync, so a CUDA graph can replay it."""
    X, G, q = t.X, t.G, t.q
    B, n = q.shape[0], X.shape[0]
    ids, keys, flags = st.ids, st.keys, st.flags
    fidx, active = top_w_unexpanded(keys[..., 0], flags[..., 0],
                                    ids < SENTINEL, width)
    fids = torch.where(active, torch.gather(ids, 1, fidx), SENTINEL)
    # record visited (expanded) nodes; like dynamic_update_slice, the
    # window start is clamped so the window fits
    pos = st.vn.clamp(0, visited_cap - width)[:, None] + t.span
    n_vis_ids = st.vis_ids.scatter(1, pos, fids)
    n_vis_d = st.vis_d.scatter(1, pos, torch.where(
        active, torch.gather(keys[..., 0], 1, fidx), INF))
    exp = flags[..., 0].scatter(
        1, fidx, torch.gather(flags[..., 0], 1, fidx) | active)
    # expand neighbors
    nbrs = G[fids.clamp(max=n - 1)]                           # (B, w, R)
    nbrs = torch.where(active[..., None] & (nbrs >= 0), nbrs, SENTINEL)
    nflat = nbrs.reshape(B, -1)
    nd = torch.where(nflat < SENTINEL,
                     sq_dists(q, X[nflat.clamp(max=n - 1)]), INF)
    all_ids = torch.cat([ids, nflat], 1)
    all_keys = torch.cat([keys[..., 0], nd], 1)[..., None]
    all_flags = torch.cat([exp, torch.zeros_like(nflat, dtype=torch.bool)],
                          1)[..., None]
    n_ids, n_keys, n_flags = dedup_merge_topL(all_ids, all_keys, all_flags,
                                              L)
    # a finished query keeps its state
    return _MemState(torch.where(live[:, None], n_ids, ids),
                     torch.where(live[:, None, None], n_keys, keys),
                     torch.where(live[:, None, None], n_flags, flags),
                     torch.where(live[:, None], n_vis_ids, st.vis_ids),
                     torch.where(live[:, None], n_vis_d, st.vis_d),
                     st.it + live.to(torch.int64),
                     st.vn + width * live.to(torch.int64))


def _beam_search_mem_batch(X, G, entries, entry_valid, q, *, L, width,
                           max_iters, visited_cap, graphs=None, tracer=None):
    """Batched over queries; tensors on one device. X (n, d) f32; G (n, R)
    int64 (-1 padded); entries (B, E) int64; entry_valid (B, E) bool;
    q (B, d) f32. Returns dict(ids (B, L), dists (B, L), visited_ids
    (B, V), visited_dists, hops (B,)). A finished query keeps its state
    while the others go on, as under the reference's vmap. `graphs` (a
    hop_loop.HopGraphs) is for a caller whose X and G stay on the device
    from call to call: on a CUDA device each iteration then replays a graph
    of `_mem_hop` from it, captured once per key (X and G read in place,
    the call size and the static arguments); otherwise the hop runs op by
    op. A host-clock `tracer` gets a `search.sync` span for each loop
    check's host sync and a `mem.hop` span for each iteration (its work,
    then the next check and its sync)."""
    dev = q.device
    B, n = q.shape[0], X.shape[0]
    d0 = torch.where(entry_valid,
                     sq_dists(q, X[entries.clamp(0, n - 1)]), INF)
    ids = torch.where(entry_valid, entries, SENTINEL)
    pad = L + width - ids.shape[1]
    ids = torch.cat([ids, torch.full((B, pad), SENTINEL, dtype=torch.int64,
                                     device=dev)], 1)
    keys = torch.cat([d0, torch.full((B, pad), INF, device=dev)], 1)[..., None]
    flags = torch.zeros((B, ids.shape[1], 1), dtype=torch.bool, device=dev)
    ids, keys, flags = dedup_merge_topL(ids, keys, flags, L)

    state = _MemState(
        ids, keys, flags,
        torch.full((B, visited_cap), SENTINEL, dtype=torch.int64, device=dev),
        torch.full((B, visited_cap), INF, device=dev),
        torch.zeros(B, dtype=torch.int64, device=dev),
        torch.zeros(B, dtype=torch.int64, device=dev))
    t = _MemInputs(X, G, q, torch.arange(width, device=dev))
    st = hop_loop(
        functools.partial(_mem_hop, L=L, width=width,
                          visited_cap=visited_cap),
        t, state, functools.partial(_mem_live, max_iters=max_iters),
        graphs=graphs, reads=(X, G),
        static=dict(L=L, width=width, max_iters=max_iters,
                    visited_cap=visited_cap),
        copied=("q", "span"), tracer=tracer, span="mem.hop")
    return {"ids": st.ids, "dists": st.keys[..., 0],
            "visited_ids": st.vis_ids, "visited_dists": st.vis_d,
            "hops": st.it}


def beam_search_mem(X, G, entry: int, q, L=64, width=1, max_iters=None,
                    visited_cap=None, device=None, graphs=None,
                    tracer=None) -> dict:
    """q: (B, d). Single fixed entry point (the medoid). X, G and q are
    numpy arrays or tensors; the search runs on `device` and returns numpy
    arrays. `graphs` is the caller's cache of captured hops, for X and G
    tensors it keeps on `device` (`_beam_search_mem_batch`). A host-clock
    `tracer` gets `search.upload` and `search.readback` spans around the
    moves to and from the device, and the loop's spans."""
    device = resolve_device(device)
    if tracer:
        span = tracer.begin("search.upload", "search")
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    G = torch.as_tensor(G, device=device).to(torch.int64)
    q = torch.as_tensor(q, dtype=torch.float32, device=device)
    B = q.shape[0]
    max_iters = max_iters or (4 * L)
    visited_cap = visited_cap or (width * max_iters)
    entries = torch.full((B, 1), entry, dtype=torch.int64, device=device)
    valid = torch.ones((B, 1), dtype=torch.bool, device=device)
    if tracer:
        tracer.end(span)
    res = _beam_search_mem_batch(X, G, entries, valid, q, L=L, width=width,
                                 max_iters=max_iters,
                                 visited_cap=visited_cap, graphs=graphs,
                                 tracer=tracer)
    if tracer:
        span = tracer.begin("search.readback", "search")
    res = {k: v.cpu().numpy() for k, v in res.items()}
    if tracer:
        tracer.end(span)
    return res


# ---------------------------------------------------------------------------
# RobustPrune


def _robust_prune_batch(X, xs_ids, cand_ids, cand_dists, *, R, alpha):
    """Batched RobustPrune. xs_ids (B,), cand_ids (B, C) (SENTINEL pad,
    deduped, may include x itself, removed here), cand_dists (B, C) dist
    to x. Returns (B, R) int64 new out-neighbors (-1 padded)."""
    n = X.shape[0]
    B = xs_ids.shape[0]
    rows = torch.arange(B, device=X.device)
    cids = torch.where(cand_ids == xs_ids[:, None], SENTINEL, cand_ids)
    cd = torch.where(cids == SENTINEL, INF, cand_dists)
    cvecs = X[cids.clamp(max=n - 1)]                          # (B, C, d)
    alive = cids < SENTINEL
    out = torch.full((B, R), -1, dtype=torch.int64, device=X.device)
    a2 = alpha * alpha
    for i in range(R):
        key = torch.where(alive, cd, INF)
        j = torch.argmin(key, 1)              # first minimum, as jnp.argmin
        ok = key[rows, j] < INF
        out[:, i] = torch.where(ok, cids[rows, j], -1)
        # kill candidates dominated by the pick: alpha*d(p,c) <= d(x,c)
        dpc = sq_dists(cvecs[rows, j], cvecs)
        alive = alive & ~(a2 * dpc <= cd) & ok[:, None]
        alive[rows, j] = False
    return out


# ---------------------------------------------------------------------------
# build


def build_vamana(x: np.ndarray, R=64, L=125, alpha=1.2, seed=0,
                 batch=1024, passes=(1.0, None), log=lambda *a: None,
                 device=None):
    """Returns (G (n, R) int32 with -1 padding, medoid id, build stats)."""
    device = resolve_device(device)
    t0 = time.time()
    n, d = x.shape
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(np.asarray(x, np.float32), device=device)
    med = medoid(x)

    # random initial R-regular graph
    G = rng.integers(0, n, (n, R), dtype=np.int64).astype(np.int32)
    G[G == np.arange(n)[:, None]] = (G[G == np.arange(n)[:, None]] + 1) % n
    G = torch.as_tensor(G.astype(np.int64), device=device)

    max_iters = max(2 * L // 1, 48)
    vcap = max_iters

    for p_i, a in enumerate(passes):
        a = float(a or alpha)
        order = rng.permutation(n)
        for s in range(0, n, batch):
            ids = torch.as_tensor(order[s:s + batch], device=device)
            b = ids.shape[0]
            qb = X[ids]
            res = _beam_search_mem_batch(
                X, G, torch.full((b, 1), med, dtype=torch.int64,
                                 device=device),
                torch.ones((b, 1), dtype=torch.bool, device=device), qb,
                L=L, width=1, max_iters=max_iters, visited_cap=vcap)
            # candidate pool = visited ∪ current out-neighbors
            cur = G[ids]
            cur = torch.where(cur >= 0, cur, SENTINEL)
            cand = torch.cat([res["visited_ids"], res["ids"], cur], 1)
            cd = torch.cat([res["visited_dists"], res["dists"],
                            sq_dists(qb, X[cur.clamp(max=n - 1)])], 1)
            cd = torch.where(cand < SENTINEL, cd, INF)
            # dedup candidates per row
            cand, cdk, _ = dedup_merge_topL(
                cand, cd[..., None],
                torch.zeros(cand.shape + (1,), dtype=torch.bool,
                            device=device), cand.shape[1])
            newn = _robust_prune_batch(X, ids, cand, cdk[..., 0], R=R,
                                       alpha=a)
            G[ids] = newn
            # reverse edges: u in newn[x] -> try add x to N(u)
            _add_reverse_edges(X, G, ids, newn, R)
        log(f"pass {p_i} (alpha={a}) done at {time.time()-t0:.1f}s")

    stats = {"build_s": time.time() - t0, "R": R, "L": L, "alpha": alpha,
             "n": n, "d": d}
    return G.cpu().numpy().astype(np.int32), med, stats


def _add_reverse_edges(X, G, xs_ids, newn, R):
    """For each edge x->u, append x to N(u) if capacity remains; a full
    node replaces its farthest neighbor when x is nearer. Updates G in
    place. Degrees and victims are read from G as it stands before any of
    the batch's writes. Several edges can target the same (u, slot); the
    reference leaves which write wins open (and on the card a plain scatter
    varies from run to run), so here the LAST in flat order wins,
    explicitly. Edges are priced in chunks, which bounds the (edges, R, d)
    gather of the victims' vectors."""
    chunk = 16384
    flat_u = newn.reshape(-1)
    flat_x = xs_ids.repeat_interleave(newn.shape[1])
    ok = flat_u >= 0
    u = flat_u.clamp(min=0)
    slot = torch.empty_like(u)
    accept = torch.empty_like(ok)
    for s in range(0, u.shape[0], chunk):
        uu, xx = u[s:s + chunk], flat_x[s:s + chunk]
        nb = G[uu]                                           # (F, R)
        deg = (nb >= 0).sum(-1)
        xu = X[uu]
        # distance of the proposed reverse edge
        dxu = torch.sum(torch.square(xu - X[xx]), -1)
        # farthest current neighbor of u (replacement victim when full)
        nbd = torch.where(nb >= 0, torch.sum(torch.square(
            X[nb.clamp(min=0)] - xu[:, None, :]), -1), -INF)
        far_d = nbd.max(-1).values
        far_slot = torch.argmax(nbd, -1)      # first maximum, as jnp.argmax
        full = deg >= R
        slot[s:s + chunk] = torch.where(full, far_slot, deg.clamp(max=R - 1))
        accept[s:s + chunk] = ok[s:s + chunk] & (~full | (dxu < far_d))
    target = torch.where(accept, u * R + slot, -1)
    order = torch.sort(target, stable=True).indices
    ts = target[order]
    last = torch.ones_like(accept)
    last[:-1] = ts[:-1] != ts[1:]
    win = order[last & (ts >= 0)]
    G.view(-1)[target[win]] = flat_x[win]
