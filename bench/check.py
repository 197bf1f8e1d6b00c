"""The comparison that decides `correct`.

It judges what the timed path returned: every answer of the window, and a
sample of answers, drawn from the run seed, searched again by the plain
reference (bench/reference/search.py). It imports nothing of the program:
the harness hands it the program's answers and the built index's arrays.

Numbers compared, each against the configuration's limit:

  dist_err_max    over every answer of the window: the largest gap between
                  a returned distance and the reference's own squared L2
                  from the query to the returned id, relative to the
                  latter (1.0 for an id that names no base vector).
  id_mismatch     over the sample: the share of returned ids (query, rank)
                  that differ from the reference search's.
  count_mismatch  over the sample: the share of queries whose hops, page
                  reads, cache hits or MemGraph hops differ from the
                  reference search's.
  start_mismatch  the index's start, worked out again: the medoid, the
                  vertex cache, the MemGraph's sample and medoid, and
                  whether the page order holds every vertex once and the
                  graph names only other vertices. A count; exact.
  codebook_gap    the program's PQ codebook against the reference's own
                  k-means (bench/reference/codebook.py): the largest
                  distance between two centroids, relative to the norm of
                  the reference's (or of the median one).
  recall_gap      1 - recall@10 of every answer of the window against the
                  exact top-10 by brute force: the quality of the graph,
                  page order and MemGraph the reference takes from the
                  program, which it cannot build again in a run.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import codebook
from bench.reference import search as ref

NAMES = ("dist_err_max", "id_mismatch", "count_mismatch", "start_mismatch",
         "codebook_gap", "recall_gap")
COUNTS = ("hops", "page_reads", "cache_hits", "mem_hops")


def ref_index(vectors, prog: dict, config: dict) -> ref.RefIndex:
    """The reference's index: its own vectors, codebook, codes, medoid,
    cache and page map, with the program's graph, page order and MemGraph
    graph (`prog`, arrays the harness took from the built index)."""
    search_cfg = config["search"]
    n = len(vectors)
    med = ref.medoid(vectors)
    mem_ids = _mem_sample(n, search_cfg, prog)
    cents = codebook.train(vectors, search_cfg["pq_m"], config["build_seed"],
                           **config["pq_train"])
    return ref.RefIndex(
        vectors=vectors, graph=prog["graph"], medoid=med,
        page_vids=prog["page_vids"], centroids=cents,
        codes=ref.encode(vectors, cents),
        cached=(ref.bfs_cache(prog["graph"], med, search_cfg["cache_frac"])
                if search_cfg["cache_frac"] > 0 else np.zeros(n, bool)),
        vid2page=ref.page_map(prog["page_vids"], n), mem_ids=mem_ids,
        mem_graph=prog.get("mem_graph"),
        mem_medoid=ref.medoid(vectors[mem_ids]) if mem_ids is not None else 0)


def _mem_sample(n: int, search_cfg: dict, prog: dict):
    """The MemGraph's sample: round(frac * n) ids (at least 64) drawn
    without replacement by the build seed's generator, in id order."""
    if prog.get("mem_graph") is None:
        return None
    s = max(64, int(round(search_cfg["memgraph_frac"] * n)))
    rng = np.random.default_rng(prog["build_seed"])
    return np.sort(rng.choice(n, s, replace=False)).astype(np.int64)


def start_mismatch(rx: ref.RefIndex, prog: dict) -> int:
    n, R = rx.graph.shape
    bad = int(rx.medoid != prog["medoid"])
    bad += int(np.count_nonzero(rx.cached != prog["cached"]))
    if rx.mem_ids is not None:
        mine = prog["mem_ids"]
        bad += (abs(len(mine) - len(rx.mem_ids)) if len(mine) != len(rx.mem_ids)
                else int(np.count_nonzero(mine != rx.mem_ids)))
        bad += int(rx.mem_medoid != prog["mem_medoid"])
    flat = rx.page_vids.reshape(-1)
    flat = flat[flat >= 0]
    bad += n - len(np.unique(flat)) + (len(flat) - len(np.unique(flat)))
    g = rx.graph
    bad += int(np.count_nonzero((g >= n) | (g == np.arange(n)[:, None])))
    return bad


def codebook_gap(rx: ref.RefIndex, prog: dict) -> float:
    return codebook.gap(prog["centroids"], rx.centroids)


def exact_dists(vectors, queries, ids) -> tuple:
    """(squared L2 of each (query, id), mask of ids that name a vector)."""
    ok = (ids >= 0) & (ids < len(vectors))
    out = np.zeros(ids.shape, np.float32)
    for s in range(0, len(ids), 4096):
        x = vectors[np.where(ok[s:s + 4096], ids[s:s + 4096], 0)]
        diff = x - queries[s:s + 4096, None, :]
        out[s:s + 4096] = np.sum(diff * diff, -1, dtype=np.float32)
    return out, ok


def dist_err_max(vectors, queries, ids, dists) -> float:
    d, ok = exact_dists(vectors, queries, ids)
    err = np.abs(dists.astype(np.float64) - d) / np.maximum(d, 1e-30)
    err = np.where(ok, err, 1.0)
    return float(err.max()) if err.size else 0.0


def draw_sample(rows_answered: np.ndarray, hops: np.ndarray, count: int,
                seed: int) -> np.ndarray:
    """Indices into the answers: `count` drawn from the seed, and the
    answer that took the most hops."""
    from bench.data import seed_words
    rng = np.random.default_rng([0x5A] + seed_words(seed))
    n = len(rows_answered)
    pick = rng.choice(n, min(count, n), replace=False)
    return np.unique(np.concatenate([pick, [int(np.argmax(hops))]]))


def compare_sample(rx, cfg, queries, answers, picks) -> dict:
    """id_mismatch and count_mismatch of `answers` (dict of arrays, one row
    per answer, `rows` naming the query) at `picks`, against the reference
    search."""
    id_bad = cnt_bad = 0
    for a in picks:
        r = ref.search_one(queries[answers["rows"][a]], rx, cfg)
        id_bad += int(np.count_nonzero(r["ids"] != answers["ids"][a]))
        cnt_bad += int(any(int(r[c]) != int(answers[c][a]) for c in COUNTS))
    k = answers["ids"].shape[1]
    return {"id_mismatch": id_bad / (len(picks) * k),
            "count_mismatch": cnt_bad / len(picks)}


def reference_answers(rx, cfg, queries, rows, precision) -> dict:
    """The reference in the program's place: its answers for `rows`."""
    outs = [ref.search_one(queries[r], rx, cfg, precision) for r in rows]
    ans = {c: np.array([o[c] for o in outs]) for c in COUNTS}
    ans["ids"] = np.stack([o["ids"] for o in outs])
    ans["dists"] = np.stack([o["dists"] for o in outs])
    ans["rows"] = np.asarray(rows)
    return ans


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for the numbers in NAMES."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def recall_at_10(vectors, queries, rows, ids, device) -> float:
    """Recall@10 of the answers against the exact top-10, by brute force in
    float32 with TF32 off."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        uq = np.unique(rows)
        x = torch.as_tensor(vectors, device=device)
        xn = torch.sum(x * x, 1)
        gt = {}
        for s in range(0, len(uq), 256):
            q = torch.as_tensor(queries[uq[s:s + 256]], device=device)
            d = xn[None, :] - 2.0 * (q @ x.T)
            top = torch.topk(d, 10, dim=1, largest=False).indices.cpu().numpy()
            gt.update(zip(uq[s:s + 256].tolist(), top))
        del x, xn
        hits = sum(len(set(ids[i, :10].tolist()) & set(gt[r].tolist()))
                   for i, r in enumerate(rows.tolist()))
        return hits / (10 * len(rows))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
