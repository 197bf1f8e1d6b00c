"""Search layer: the batched beam search over store-provided page arrays.

The port of src/repro/core/search_kernel.py. `_search_batch` is a function
of the page tensors a PageStore exposes; it never touches the store object.
Where the reference maps a one-query search with `vmap` and loops with
`lax.while_loop`, this runs one Python loop over (B, ...) tensors: each
iteration is one hop of every query that is still open, and a query that
has finished keeps its whole state (candidate list, hop count, DynamicWidth
state, every metric), exactly as the reference's batched while loop freezes
it. The loop runs at most `max_iters` hops and stops once no query is open.
One hop (`_hop`) has fixed shapes and no host sync, so on a CUDA device it
is captured once per shape key as a CUDA graph and replayed for every
iteration, one launch where op by op it takes some 260-295; off the card
the same `_hop` runs op by op. The host reads one flag an iteration. The
loop runner, which the MemGraph loop (core/vamana.py `_mem_hop`) shares,
is core/hop_loop.py; this module owns the disk loop's cache, `GRAPHS`.

Besides the per-query counters, the search emits `visited_pages` (a
(B, num_pages) bitmap of the pages each query charged) when
`track_visited` is set, and `page_trace` ((B, max_iters, w_cap) int32, the
distinct pages query b charged at hop h, -1 padded) when `track_trace` is
set.

Technique mapping (SearchConfig), as in the reference:
  PQ            — always on: neighbors ranked by memory-resident ADC
                  distances; exact distances only for records whose page was
                  fetched.
  Cache         — `cached` vertex mask: frontier reads of cached vertices are
                  free.
  MemGraph      — entry points from the navigation layer instead of the
                  medoid.
  PageShuffle   — a different PageLayout (perm); search unchanged.
  AiS           — smaller n_p / bigger records (layout).
  DynamicWidth  — beam width starts at w_min and doubles each iteration the
                  best candidate stops improving.
  Pipeline      — speculative frontier: `spec` extra reads per step.
  PageSearch    — every record of a fetched page is scored exactly and
                  inserted into the pool.
"""
from __future__ import annotations

import functools
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import same_device
from repro_torch.core.hop_loop import HopGraphs, hop_loop
from repro_torch.core.searchutils import (INF, SENTINEL, dedup_merge_topL,
                                          sq_dists, top_w_unexpanded)
from repro_torch.core.stats import QueryStats


class _Inputs(NamedTuple):
    """What a disk hop reads besides the state: the store's page tensors,
    vid2page/vid2slot, the PQ codes and the cache mask (read in place), the
    batch's queries q (B, d) and flat ADC tables lut_flat (B, M*256), and
    three index vectors: code_off (M,), rows (B,), cols (w_cap,)."""
    page_vids: torch.Tensor
    page_vecs: torch.Tensor
    page_nbrs: torch.Tensor
    vid2page: torch.Tensor
    vid2slot: torch.Tensor
    pq_codes: torch.Tensor
    cached: torch.Tensor
    q: torch.Tensor
    lut_flat: torch.Tensor
    code_off: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor


class _State(NamedTuple):
    """The search state a hop maps to the next, each (B, ...): the
    candidate list (ids; keys = [rank_key, exact_dist]; flags = [expanded,
    exact_known]), hops taken, the DynamicWidth state, the six metrics, and
    the optional visited bitmap and page trace, which a hop writes in
    place."""
    ids: torch.Tensor
    keys: torch.Tensor
    flags: torch.Tensor
    it: torch.Tensor
    w_dyn: torch.Tensor
    stall: torch.Tensor
    pages: torch.Tensor
    cache_hits: torch.Tensor
    n_read: torch.Tensor
    n_eff: torch.Tensor
    full_evals: torch.Tensor
    pq_evals: torch.Tensor
    visited: Optional[torch.Tensor]
    trace: Optional[torch.Tensor]


def _pq_dist(t, ids):
    """ADC distances (B, X) from each row's query to vertices ids (B, X)."""
    n = t.vid2page.shape[0]
    codes = t.pq_codes[ids.clamp(0, n - 1)].long() + t.code_off  # (B, X, M)
    d = torch.gather(t.lut_flat, 1, codes.reshape(ids.shape[0], -1))
    return d.reshape(codes.shape).sum(-1)


def _live(st, max_iters):
    """(B,) bool: the query has an unexpanded candidate and hops left."""
    open_ = (st.ids < SENTINEL) & ~st.flags[..., 0] & (st.keys[..., 0] < INF)
    return open_.any(1) & (st.it < max_iters)


def _hop(t, st, live, *, L, width, w_cap, spec, max_iters, n_p,
         page_search, dynamic_width, dw_max):
    """One hop of every live query: `t` (_Inputs) and `st` (_State) on one
    device, `live` (B,) bool. Returns the next _State; a query that is not
    live keeps its state. Fixed shapes, no host sync: the same launches
    whatever the data, so a CUDA graph can replay it."""
    dev = t.q.device
    B = t.q.shape[0]
    n = t.vid2page.shape[0]
    num_pages = t.page_vids.shape[0]
    ids, keys, flags = st.ids, st.keys, st.flags

    best_before = keys[:, 0, 0]
    w_now = (torch.clamp(st.w_dyn, max=float(dw_max)) if dynamic_width
             else torch.full((B,), float(width), dtype=torch.float32,
                             device=dev))
    w_sel = torch.clamp(w_now, max=float(width)).to(torch.int64)
    fidx, active = top_w_unexpanded(
        keys[..., 0], flags[..., 0], ids < SENTINEL, w_cap,
        w_dynamic=w_sel + spec)
    # pipeline: the first w_sel are confirmed, the rest speculative
    fids = torch.where(active, torch.gather(ids, 1, fidx), SENTINEL)
    neff = (active & (t.cols[None, :] < w_sel[:, None])).sum(1)

    # --- page fetch accounting ------------------------------------------
    page_ok = fids < SENTINEL
    safe_f = fids.clamp(0, n - 1)
    fpages = torch.where(page_ok, t.vid2page[safe_f], -1)
    is_cached = page_ok & t.cached[safe_f]
    chargeable = torch.where(is_cached, -1, fpages)
    srt = torch.sort(chargeable, dim=1).values
    uniq = srt >= 0
    uniq[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    pages_step = uniq.sum(1).to(torch.float32)
    if st.visited is not None:
        slot = torch.where((chargeable >= 0) & live[:, None], chargeable,
                           num_pages)
        st.visited.scatter_(1, slot, True)
    if st.trace is not None:
        h = st.it.clamp(max=max_iters - 1)
        row = torch.where(uniq, srt, -1).to(torch.int32)
        st.trace[t.rows, h] = torch.where(live[:, None], row,
                                          st.trace[t.rows, h])

    # --- fetch records --------------------------------------------------
    pg = fpages.clamp(min=0)
    rec_vids = t.page_vids[pg]                      # (B, w_cap, n_p)
    rec_vecs = t.page_vecs[pg]                      # (B, w_cap, n_p, d)
    rec_nbrs = t.page_nbrs[pg, t.vid2slot[safe_f]]  # (B, w_cap, R)

    # exact distance for every record on fetched pages
    rd = sq_dists(t.q[:, None, :], rec_vecs)        # (B, w_cap, n_p)
    rec_valid = (rec_vids >= 0) & page_ok[..., None]
    full_step = rec_valid.sum((1, 2)).to(torch.float32)

    # frontier's own exact distances (re-rank info, always used)
    own = rec_vids == torch.where(page_ok, fids, -2)[..., None]
    own_ids = torch.where(page_ok, fids, SENTINEL)
    own_d = torch.where(page_ok, torch.where(own, rd, 0.0).sum(-1), INF)

    # --- assemble merge inputs ------------------------------------------
    parts_ids = [ids, own_ids]
    parts_rank = [keys[..., 0], own_d]
    parts_exact = [keys[..., 1], own_d]
    parts_exp = [flags[..., 0], page_ok]
    parts_exk = [flags[..., 1], page_ok]

    if page_search:
        pr_ids = torch.where(rec_valid, rec_vids, SENTINEL).reshape(B, -1)
        pr_d = torch.where(rec_valid, rd, INF).reshape(B, -1)
        parts_ids.append(pr_ids)
        parts_rank.append(pr_d)
        parts_exact.append(pr_d)
        parts_exp.append(torch.zeros_like(pr_ids, dtype=torch.bool))
        parts_exk.append(pr_ids < SENTINEL)

    nb = torch.where(page_ok[..., None] & (rec_nbrs >= 0), rec_nbrs,
                     SENTINEL).reshape(B, -1)
    nb_pq = torch.where(nb < SENTINEL, _pq_dist(t, nb), INF)
    pq_step = (nb < SENTINEL).sum(1).to(torch.float32)
    parts_ids.append(nb)
    parts_rank.append(nb_pq)
    parts_exact.append(torch.full_like(nb_pq, INF))
    parts_exp.append(torch.zeros_like(nb, dtype=torch.bool))
    parts_exk.append(torch.zeros_like(nb, dtype=torch.bool))

    all_ids = torch.cat(parts_ids, 1)
    all_keys = torch.stack([torch.cat(parts_rank, 1),
                            torch.cat(parts_exact, 1)], -1)
    all_flags = torch.stack([torch.cat(parts_exp, 1),
                             torch.cat(parts_exk, 1)], -1)
    n_ids, n_keys, n_flags = dedup_merge_topL(all_ids, all_keys, all_flags,
                                              L)
    # expanded entries keep exact distance as ranking key
    n_keys[..., 0] = torch.where(n_flags[..., 1], n_keys[..., 1],
                                 n_keys[..., 0])

    # dynamic width phase detection: no improvement => converge phase
    improved = n_keys[:, 0, 0] < best_before
    n_stall = torch.where(improved, 0.0, st.stall + 1.0)
    n_w_dyn = (torch.where(n_stall > 0,
                           torch.clamp(st.w_dyn * 2.0, max=float(dw_max)),
                           st.w_dyn)
               if dynamic_width else st.w_dyn)

    # --- a finished query keeps its state -------------------------------
    steps = (pages_step, is_cached.sum(1).to(torch.float32),
             pages_step * n_p, neff, full_step, pq_step)
    met = [torch.where(live, v + s, v) for v, s in zip(st[6:12], steps)]
    return _State(torch.where(live[:, None], n_ids, ids),
                  torch.where(live[:, None, None], n_keys, keys),
                  torch.where(live[:, None, None], n_flags, flags),
                  st.it + live.to(torch.int64),
                  torch.where(live, n_w_dyn, st.w_dyn),
                  torch.where(live, n_stall, st.stall),
                  *met, st.visited, st.trace)


GRAPHS = HopGraphs()   # the disk loop's captured hops, for the process


def _search_batch(page_vids, page_vecs, page_nbrs, vid2page, vid2slot,
                  pq_centroids, pq_codes, cached, q, entries, entry_valid, *,
                  k, L, width, max_iters, n_p, page_search, dynamic_width,
                  dw_min, dw_max, pipeline, spec, track_visited=True,
                  track_trace=False, tracer=None):
    """All tensors on one device: page_vids (P, n_p), page_nbrs (P, n_p, R),
    vid2page/vid2slot (n,) int64; page_vecs (P, n_p, d) f32; pq_centroids
    (M, 256, dsub) f32; pq_codes (n, M) uint8; cached (n,) bool; q (B, d)
    f32; entries (B, E) int64; entry_valid (B, E) bool. Returns a dict of
    (B, ...) tensors. On a CUDA device each loop iteration replays the
    batch's captured hop from `GRAPHS`; elsewhere it runs op by op
    (core/hop_loop.py). A host-clock `tracer` gets the loop's spans."""
    static = dict(k=k, L=L, width=width, max_iters=max_iters, n_p=n_p,
                  page_search=page_search, dynamic_width=dynamic_width,
                  dw_min=dw_min, dw_max=dw_max, pipeline=pipeline, spec=spec,
                  track_visited=track_visited, track_trace=track_trace)
    dev = q.device
    B = q.shape[0]
    num_pages = page_vids.shape[0]
    R = page_nbrs.shape[2]
    m, ksub, dsub = pq_centroids.shape
    width = max(width, dw_max) if dynamic_width else width
    width = min(width, L)   # frontier can never exceed the candidate pool
    w_cap = min(width + (spec if pipeline else 0), L)
    spec_now = spec if pipeline else 0

    lut = torch.sum(torch.square(pq_centroids[None]
                                 - q.reshape(B, m, 1, dsub)), dim=-1)
    t = _Inputs(page_vids, page_vecs, page_nbrs, vid2page, vid2slot,
                pq_codes, cached, q, lut.reshape(B, m * ksub),
                torch.arange(m, device=dev) * ksub,
                torch.arange(B, device=dev), torch.arange(w_cap, device=dev))

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    # candidate list: keys = [rank_key, exact_dist]; flags = [expanded,
    # exact_known]
    cap = L + w_cap * (n_p if page_search else 0) + w_cap * R
    e_pq = _pq_dist(t, entries)
    ids0 = torch.where(entry_valid, entries, SENTINEL)
    pad = cap - ids0.shape[1]
    ids = torch.cat([ids0, full((B, pad), SENTINEL, torch.int64)], 1)
    keys = torch.stack([torch.where(entry_valid, e_pq, INF),
                        full(ids0.shape, INF, torch.float32)], -1)
    keys = torch.cat([keys, full((B, pad, 2), INF, torch.float32)], 1)
    flags = torch.zeros((B, cap, 2), dtype=torch.bool, device=dev)
    ids, keys, flags = dedup_merge_topL(ids, keys, flags, L)

    # visited[b, p]: page p charged by query b; column num_pages is the
    # trash slot for "-1 / cached / finished" entries
    state = _State(
        ids, keys, flags, torch.zeros(B, dtype=torch.int64, device=dev),
        full((B,), float(dw_min), torch.float32),
        *(torch.zeros(B, dtype=torch.float32, device=dev) for _ in range(7)),
        (torch.zeros((B, num_pages + 1), dtype=torch.bool, device=dev)
         if track_visited else None),
        full((B, max_iters, w_cap), -1, torch.int32) if track_trace else None)
    hop = functools.partial(
        _hop, L=L, width=width, w_cap=w_cap, spec=spec_now,
        max_iters=max_iters, n_p=n_p, page_search=page_search,
        dynamic_width=dynamic_width, dw_max=dw_max)
    st = hop_loop(hop, t, state,
                  functools.partial(_live, max_iters=max_iters),
                  graphs=GRAPHS,
                  reads=(page_vids, page_vecs, page_nbrs, vid2page, vid2slot,
                         pq_centroids, pq_codes, cached),
                  static=static,
                  copied=("q", "lut_flat", "code_off", "rows", "cols"),
                  tracer=tracer)

    # final top-k by exact distance (re-rank among exact-known)
    final_key = torch.where(st.flags[..., 1], st.keys[..., 1], INF)
    order = torch.sort(final_key, dim=1, stable=True).indices[:, :k]
    topd = torch.gather(final_key, 1, order)
    topk = torch.where(topd < INF, torch.gather(st.ids, 1, order), -1)
    out = {"ids": topk.to(torch.int32), "dists": topd,
           "hops": st.it.to(torch.int32), "page_reads": st.pages,
           "cache_hits": st.cache_hits, "n_read": st.n_read,
           "n_eff": st.n_eff, "full_evals": st.full_evals,
           "pq_evals": st.pq_evals}
    if track_visited:
        out["visited_pages"] = st.visited[:, :num_pages]
    if track_trace:
        out["page_trace"] = st.trace
    return out


# ---------------------------------------------------------------------------
# Fused-pipeline measurement surface (SearchConfig.pipeline == "fused"):
# results still come from _search_batch above (identical to pipeline=True);
# the traced page schedule is then re-executed through the fused page kernel
# (kernels/csrc/fused_page_rank.cu) to produce a measured step time beside
# the modelled one.

# the measured slice of the schedule; the per-page rate is extrapolated
MEASURE_PAGES_CAP = int(os.environ.get("REPRO_FUSED_MEASURE_PAGES", 256))


def hop_major_schedule(page_trace: np.ndarray) -> np.ndarray:
    """The batch's page stream in hop-major order: hop t's distinct pages
    (the batch union), then hop t+1's. page_trace (B, max_iters, w), -1
    padded."""
    trace = np.asarray(page_trace)
    out = []
    for h in range(trace.shape[1]):
        pages = np.unique(trace[:, h, :])
        out.append(pages[pages >= 0])
    return (np.concatenate(out) if out else np.zeros(0, np.int64))


def query_luts(pq_centroids, queries):
    """Per-query ADC LUTs, laid out (M, 256, Q) as the page kernels read
    them: squared subspace distances from each query's subvectors to every
    centroid. Tensors on one device."""
    m, ksub, dsub = pq_centroids.shape
    qs = queries.float().reshape(-1, m, 1, dsub)
    lut = torch.sum(torch.square(pq_centroids[None] - qs), dim=-1)
    return lut.permute(1, 2, 0).contiguous()


def _pq_device_arrays(pq, device):
    """(centroids f32, codes uint8) of `pq` on `device`, memoized on the PQ
    object: re-uploading the (n, M) code matrix per batch would dominate,
    and would give each call's hop graph a new key ("cuda" names the
    current card, as "cuda:0" does)."""
    memo = getattr(pq, "_device_arrays", None)
    if memo is None or not same_device(memo[0].device, torch.device(device)):
        memo = (torch.as_tensor(pq.centroids, dtype=torch.float32,
                                device=device),
                torch.as_tensor(pq.codes, dtype=torch.uint8, device=device))
        pq._device_arrays = memo
    return memo


def _page_codes(store, pq):
    """(P, n_p, M) uint8 page-aligned PQ codes on the store's device (the
    residents' codes laid out like the vector tiles). Memoized on the
    store next to its kernel arrays."""
    cached = getattr(store, "_device_page_codes", None)
    if cached is None or cached.shape[0] != store.layout.num_pages:
        vids = store.layout.page_vids
        safe = np.clip(vids, 0, pq.codes.shape[0] - 1)
        codes = np.ascontiguousarray(pq.codes[safe])
        codes[vids < 0] = 0
        cached = torch.as_tensor(codes, device=store.device)
        store._device_page_codes = cached
    return cached


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_step_us(store, pq, queries, page_trace, *,
                    mode: str = "fused",
                    max_pages: int | None = None) -> dict:
    """Wall-clock one batch's page schedule through the page kernels.

    mode="fused": kernels.fused_page_rank, one launch. mode="split": the
    two kernels it replaces (kernels.page_scan, then kernels.page_adc), back
    to back. Returns {"wall_us", "pages", "us_per_page"}; the schedule is
    capped at `max_pages` (default MEASURE_PAGES_CAP) and the per-page rate
    is what callers scale by a query's own page count. The schedule's page
    ids are range-checked here on the host, so the timed call makes no
    device round trip for the check. One warm-up call comes first (it
    builds the kernels on first use); the timed call is bracketed by device
    synchronisations."""
    from repro_torch import kernels as ops
    sched = hop_major_schedule(page_trace)
    cap = MEASURE_PAGES_CAP if max_pages is None else max_pages
    if cap > 0:
        sched = sched[:cap]
    if len(sched) == 0:
        return {"wall_us": 0.0, "pages": 0, "us_per_page": 0.0}
    num_pages = store.layout.num_pages
    if sched.min() < 0 or sched.max() >= num_pages:
        raise IndexError(f"page schedule spans [{sched.min()}, "
                         f"{sched.max()}], outside the {num_pages} pages")
    dev = store.device
    _, vecs, _, _, _ = store.kernel_arrays()
    codes = _page_codes(store, pq)
    qb = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    lut = query_luts(_pq_device_arrays(pq, dev)[0], qb)
    ids = torch.as_tensor(sched.astype(np.int32), device=dev)
    if mode == "fused":
        def fn():
            return ops.fused_page_rank(vecs, codes, ids, qb, lut,
                                       ids_checked=True)
    elif mode == "split":
        def fn():
            return (ops.page_scan(vecs, ids, qb, ids_checked=True),
                    ops.page_adc(codes, ids, lut, ids_checked=True))
    else:
        raise ValueError(f"mode={mode!r} must be 'fused' or 'split'")
    fn()                               # build + warm up
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    wall = (time.perf_counter() - t0) * 1e6
    return {"wall_us": wall, "pages": len(sched),
            "us_per_page": wall / len(sched)}


def search_batched(store, pq, cfg, queries: np.ndarray, *,
                   medoid: int, memgraph=None, batch: int = 256,
                   collect_visited: bool = True,
                   collect_trace: bool = False,
                   account_kernel_io: bool = True,
                   tracer=None) -> QueryStats:
    """Feed query batches through `_search_batch` on the store's device,
    with page data and the cache mask supplied by `store`.

    This is the search path behind `DiskIndex.search`. `collect_trace` adds
    the per-hop page trace (QueryStats.page_trace). With
    `cfg.pipeline == "fused"` the trace is collected regardless (it is the
    fused kernel's page schedule), the results stay identical to
    `pipeline=True`, and each batch's schedule is re-executed through the
    fused kernel: QueryStats.measured_step_us carries each query's measured
    kernel time (its page count x the batch's measured per-page rate).

    A `tracer` (repro_torch.obs.Tracer(clock="host"); any other clock
    raises ValueError) gets the spans of each batch: `search.memgraph`,
    `search.upload`, `search.hops` (the whole `_search_batch`, with its
    `search.hop` and `search.sync` spans), `search.readback` and
    `search.stats`, then one `search.stats` for the concatenation. With
    `tracer=None` each emission costs one falsy check."""
    if tracer is not None and tracer.clock != "host":
        raise ValueError(f"the search path stamps the host clock: pass "
                         f"Tracer(clock='host'), not clock={tracer.clock!r}")
    fused = cfg.pipeline == "fused"
    track_trace = collect_trace or fused
    dev = store.device
    vids, vecs, nbrs, v2p, v2s = store.kernel_arrays()
    cached = getattr(store, "_device_cache_mask", None)
    if cached is None:
        cached = torch.as_tensor(store.vertex_cache_mask(), device=dev)
        store._device_cache_mask = cached
    pq_cent, pq_codes = _pq_device_arrays(pq, dev)
    parts = []
    for s in range(0, len(queries), batch):
        qb = np.asarray(queries[s:s + batch], np.float32)
        if memgraph is not None and cfg.memgraph_frac > 0:
            if tracer:
                span = tracer.begin("search.memgraph", "search")
            mg = memgraph.entry_points(
                qb, n_entries=cfg.memgraph_entries, L=cfg.memgraph_L,
                tracer=tracer)
            if tracer:
                tracer.end(span)
            entries = mg["entries"]
            mem_hops, mem_evals = mg["hops"], mg["dist_evals"]
        else:
            entries = np.full((len(qb), 1), medoid, np.int32)
            mem_hops = np.zeros(len(qb), np.int32)
            mem_evals = np.zeros(len(qb), np.int32)
        if tracer:
            span = tracer.begin("search.upload", "search")
        ent = torch.as_tensor(entries.astype(np.int64), device=dev)
        qt = torch.as_tensor(qb, device=dev)
        ent_ok = ent >= 0
        if tracer:
            tracer.end(span)
            span = tracer.begin("search.hops", "search")
        out = _search_batch(
            vids, vecs, nbrs, v2p, v2s, pq_cent, pq_codes, cached,
            qt, ent, ent_ok,
            k=cfg.k, L=cfg.L, width=cfg.beam_width,
            max_iters=cfg.max_iters, n_p=store.layout.n_p,
            page_search=cfg.page_search,
            dynamic_width=cfg.dynamic_width, dw_min=cfg.dw_min,
            dw_max=cfg.dw_max, pipeline=bool(cfg.pipeline),
            spec=cfg.pipeline_spec, track_visited=collect_visited,
            track_trace=track_trace, tracer=tracer)
        if tracer:
            tracer.end(span)
            span = tracer.begin("search.readback", "search")
        out = {k_: v.cpu().numpy() for k_, v in out.items()}
        if tracer:
            tracer.end(span)
            span = tracer.begin("search.stats", "search")
        out["mem_hops"] = mem_hops
        out["mem_evals"] = mem_evals
        st = QueryStats.from_kernel(out)
        if fused:
            m = measure_step_us(store, pq, qb, out["page_trace"])
            st.measured_step_us = (st.page_reads.astype(np.float64)
                                   * m["us_per_page"])
        if account_kernel_io:
            store.note_kernel_io(st)
        if tracer:
            tracer.end(span)
        parts.append(st)
    if tracer:
        span = tracer.begin("search.stats", "search")
    st = QueryStats.concat(parts)
    if tracer:
        tracer.end(span)
    return st
