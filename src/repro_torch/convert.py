"""Carry a built index of the JAX package over to the port.

`index_from_reference(idx, device)` reads a `repro` DiskIndex by its
attributes, as plain numpy arrays (duck typing: this module imports nothing
of `repro`), and returns the port's `DiskIndex` on `device` with the same
layout, PQ codebook and codes, graph, medoid, cache mask, MemGraph and
search configuration. Both packages can then search the very same index.

`mutable_from_reference(ref_mutable, device)` does the same for a `repro`
MutableIndex: the port's MutableIndex over the converted base index,
restored from the reference's mutable state as `mutable_state` reads it
(snapshot()'s format, without billing a snapshot), so that both packages
hold the same layout, graph, codes, tombstones, delta, page sets and
counters.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.engine import DiskIndex, SearchConfig
from repro_torch.core.memgraph import MemGraph
from repro_torch.core.pages import PageLayout
from repro_torch.core.pq import PQ
from repro_torch.mutation.mutable_index import (MutableIndex, MutationConfig,
                                                mutable_state)


def _arr(a) -> np.ndarray:
    return np.array(a, copy=True)


def config_from_reference(cfg) -> SearchConfig:
    """The port's SearchConfig with every field read from `cfg`."""
    return SearchConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(SearchConfig)})


def index_from_reference(idx, device=None) -> DiskIndex:
    device = resolve_device(device)
    lay = idx.layout
    layout = PageLayout(
        page_bytes=int(lay.page_bytes), n_p=int(lay.n_p),
        num_pages=int(lay.num_pages), vid2page=_arr(lay.vid2page),
        vid2slot=_arr(lay.vid2slot), page_vids=_arr(lay.page_vids),
        page_vecs=_arr(lay.page_vecs), page_nbrs=_arr(lay.page_nbrs),
        record_bytes=int(lay.record_bytes),
        mapping_bytes=int(lay.mapping_bytes))
    pq = PQ(centroids=_arr(idx.pq.centroids), codes=_arr(idx.pq.codes),
            m=int(idx.pq.m), dsub=int(idx.pq.dsub))
    memgraph = None
    if idx.memgraph is not None:
        mg = idx.memgraph
        memgraph = MemGraph(sample_ids=_arr(mg.sample_ids),
                            vectors=_arr(mg.vectors), graph=_arr(mg.graph),
                            medoid=int(mg.medoid), build_s=float(mg.build_s),
                            device=device)
    return DiskIndex(layout, pq, _arr(idx.graph), int(idx.medoid),
                     config_from_reference(idx.cfg), memgraph=memgraph,
                     cached=_arr(idx.cached),
                     build_stats=dict(idx.build_stats), device=device)


def mutable_from_reference(ref_mutable, device=None) -> MutableIndex:
    """The port's MutableIndex with `ref_mutable`'s base index and mutable
    state, on `device`. The journal stays with the reference: the port's
    index has none."""
    device = resolve_device(device)
    mcfg = MutationConfig(**{f.name: getattr(ref_mutable.mcfg, f.name)
                             for f in dataclasses.fields(MutationConfig)})
    idx = MutableIndex(index_from_reference(ref_mutable.base, device), mcfg)
    idx.restore(mutable_state(ref_mutable))
    return idx
