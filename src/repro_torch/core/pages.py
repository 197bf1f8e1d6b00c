"""Page/layout abstraction — the paper's disk-layout dimension (§4.2).

A page stores n_p records; a record is (vector, degree, neighbor ids) exactly
like DiskANN's page-aligned format (Fig. 1). All-in-Storage (AiSAQ, §4.2.2)
additionally co-locates the PQ codes of the record's neighbors, which shrinks
n_p and grows the on-disk footprint — modeled by `record_bytes`.

A record longer than one page of `page_bytes` (a 960-d float32 vector with
R = 64 neighbours is 4,100 B against a 4,096 B sector) takes the smallest
whole number of such pages that holds it, one record to a page, as
DiskANN's disk format gives a node larger than a sector
ceil(node bytes / sector bytes) sectors (github.com/microsoft/DiskANN,
`PQFlashIndex`): the layout's page is then that many sectors,
`sectors_per_page` says how many, and `page_bytes` and `disk_bytes` state
the real page. Where a record fits a page, the layout is byte for byte the
one of src/repro/core/pages.py; there, `max(1, page_bytes // rec)` packs a
longer record into one page of `page_bytes`, which under-states the read
and the index. That is the one departure of this copy; the port imports
nothing of `repro`.

On the card a page is a (n_p, d) tile of `page_vecs` in device memory that
the page kernels (kernels/csrc/) stage into shared memory.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PageLayout:
    page_bytes: int
    n_p: int                 # records per page
    num_pages: int
    vid2page: np.ndarray     # (n,) int32
    vid2slot: np.ndarray     # (n,) int32
    page_vids: np.ndarray    # (P, n_p) int32, -1 padded
    page_vecs: np.ndarray    # (P, n_p, d) float32   — the "disk"
    page_nbrs: np.ndarray    # (P, n_p, R) int32, -1 padded
    record_bytes: int
    mapping_bytes: int       # in-memory vid->page table cost (page shuffle)
    sectors_per_page: int = 1  # sectors (configured page_bytes) a page spans

    @property
    def disk_bytes(self) -> int:
        return self.num_pages * self.page_bytes


def records_per_page(page_bytes: int, d: int, vec_bytes_per_dim: int, R: int,
                     all_in_storage: bool = False, pq_m: int = 16) -> tuple:
    """DiskANN record: vector + degree(4B) + R neighbor ids (4B each).
    AiSAQ adds own PQ code + R neighbor PQ codes (pq_m bytes each)."""
    rec = d * vec_bytes_per_dim + 4 + 4 * R
    if all_in_storage:
        rec += pq_m * (R + 1)
    return max(1, page_bytes // rec), rec


def build_layout(vectors: np.ndarray, graph: np.ndarray, *,
                 page_bytes: int = 4096, vec_bytes_per_dim: int = 4,
                 perm: Optional[np.ndarray] = None,
                 all_in_storage: bool = False, pq_m: int = 16) -> PageLayout:
    """perm: order[i] = vid stored at global slot i (None => id order).
    `page_bytes` is the sector: a record longer than it gets a page of
    ceil(record_bytes / page_bytes) sectors to itself (n_p = 1)."""
    n, d = vectors.shape
    R = graph.shape[1]
    n_p, rec = records_per_page(page_bytes, d, vec_bytes_per_dim, R,
                                all_in_storage, pq_m)
    sectors = -(-rec // page_bytes)
    order = np.arange(n, dtype=np.int32) if perm is None else perm.astype(np.int32)
    num_pages = (n + n_p - 1) // n_p
    pad = num_pages * n_p - n
    order_p = np.concatenate([order, np.full(pad, -1, np.int32)])
    page_vids = order_p.reshape(num_pages, n_p)

    vid2page = np.empty(n, np.int32)
    vid2slot = np.empty(n, np.int32)
    pg = np.repeat(np.arange(num_pages, dtype=np.int32), n_p)
    sl = np.tile(np.arange(n_p, dtype=np.int32), num_pages)
    valid = order_p >= 0
    vid2page[order_p[valid]] = pg[valid]
    vid2slot[order_p[valid]] = sl[valid]

    safe = np.where(page_vids >= 0, page_vids, 0)
    page_vecs = vectors[safe].astype(np.float32)
    page_nbrs = graph[safe].astype(np.int32)
    page_vecs[~valid.reshape(num_pages, n_p)] = 0.0
    page_nbrs[~valid.reshape(num_pages, n_p)] = -1

    mapping = 8 * n if perm is not None else 0  # vid->(page,slot) table
    return PageLayout(page_bytes=sectors * page_bytes, n_p=n_p,
                      num_pages=num_pages,
                      vid2page=vid2page, vid2slot=vid2slot,
                      page_vids=page_vids, page_vecs=page_vecs,
                      page_nbrs=page_nbrs, record_bytes=rec,
                      mapping_bytes=mapping, sectors_per_page=sectors)


def overlap_ratio(layout: PageLayout, graph: np.ndarray,
                  alive: Optional[np.ndarray] = None) -> float:
    """OR(G) (§3.1): average over u of |B(u) ∩ N(u)| / (n_p - 1).

    `alive` (optional (n,) bool) restricts the average to live vertices —
    the form the streaming-mutation subsystem needs, where the vid space
    carries capacity padding and tombstoned entries that must not dilute
    the locality signal."""
    if layout.n_p <= 1:
        return 0.0
    n = graph.shape[0]
    pages_of_nbrs = np.where(graph >= 0, layout.vid2page[np.maximum(graph, 0)], -2)
    own = layout.vid2page[np.arange(n)][:, None]
    co = (pages_of_nbrs == own).sum(1)
    frac = co / (layout.n_p - 1)
    if alive is not None:
        alive = np.asarray(alive, bool)
        if not alive.any():
            return 0.0
        frac = frac[alive]
    return float(frac.mean())
