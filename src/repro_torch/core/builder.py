"""Index construction pipeline: Vamana graph -> PQ -> page layout (+optional
page shuffle) -> cache -> MemGraph, per a SearchConfig. Build costs are
recorded for the Table-6 reproduction (Finding 6).

The port of src/repro/core/builder.py: the same steps and stats keys, with
the graph, PQ and MemGraph built on `device` ("cuda" unless named). Two
departures, both where a page holds one record (n_p = 1): page shuffle has
nothing to co-locate there, so the ids keep their order (no permutation, no
mapping table; `page_shuffle_skipped`), and a record longer than a page
spans several (`sectors_per_page`, core/pages.py)."""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import cache as cache_mod
from repro_torch.core import memgraph as mg_mod
from repro_torch.core import page_shuffle as ps_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core import vamana
from repro_torch.core.dataset import Dataset
from repro_torch.core.engine import DiskIndex, SearchConfig
from repro_torch.core.pages import build_layout, overlap_ratio, records_per_page


def build_index(ds: Dataset, cfg: SearchConfig, *, R: int = 64,
                L_build: int = 125, alpha: float = 1.2, seed: int = 0,
                graph: Optional[np.ndarray] = None,
                medoid_id: Optional[int] = None,
                log=lambda *a: None, device=None) -> DiskIndex:
    device = resolve_device(device)
    stats = {}
    t0 = time.time()
    if graph is None:
        graph, medoid_id, gstats = vamana.build_vamana(
            ds.vectors, R=R, L=L_build, alpha=alpha, seed=seed, log=log,
            device=device)
        stats.update(gstats)
    stats["graph_build_s"] = time.time() - t0

    t0 = time.time()
    pq = pq_mod.train_pq(ds.vectors, m=cfg.pq_m, seed=seed, device=device)
    stats["pq_build_s"] = time.time() - t0

    vec_bytes = 1 if ds.dtype_tag in ("uint8", "int8") else 4
    n_p, _ = records_per_page(cfg.page_bytes, ds.d, vec_bytes, R,
                              cfg.all_in_storage, cfg.pq_m)
    perm = None
    stats["page_shuffle_skipped"] = bool(cfg.page_shuffle and n_p == 1)
    if cfg.page_shuffle and n_p > 1:
        sh = ps_mod.shuffle_order(graph, medoid_id, n_p, seed=seed)
        perm = sh["perm"]
        stats.update(sh["stats"])
    t0 = time.time()
    layout = build_layout(ds.vectors, graph, page_bytes=cfg.page_bytes,
                          vec_bytes_per_dim=vec_bytes, perm=perm,
                          all_in_storage=cfg.all_in_storage, pq_m=cfg.pq_m)
    stats["layout_s"] = time.time() - t0
    stats["overlap_ratio"] = overlap_ratio(layout, graph)
    stats["n_p"] = layout.n_p
    stats["sectors_per_page"] = layout.sectors_per_page
    stats["disk_bytes"] = layout.disk_bytes

    cached = None
    if cfg.cache_frac > 0:
        if cfg.cache_policy == "freq":
            rng = np.random.default_rng(seed)
            sample = ds.vectors[rng.choice(ds.n, min(256, ds.n),
                                           replace=False)]
            cached = cache_mod.frequency_cache(graph, ds.vectors, medoid_id,
                                               sample, cfg.cache_frac,
                                               device=device)
        else:
            cached = cache_mod.sssp_cache(graph, medoid_id, cfg.cache_frac)

    memgraph = None
    if cfg.memgraph_frac > 0:
        t0 = time.time()
        memgraph = mg_mod.build_memgraph(ds.vectors, frac=cfg.memgraph_frac,
                                         seed=seed, device=device)
        stats["memgraph_build_s"] = time.time() - t0

    idx = DiskIndex(layout, pq, graph, medoid_id, cfg, memgraph=memgraph,
                    cached=cached, build_stats=stats, device=device)
    stats["memory_bytes"] = idx.memory_bytes()
    return idx
