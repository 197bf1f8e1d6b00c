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

`params_from_reference(params, cfg, device)` reads a `repro` model's
parameter tree (nested dicts of arrays, stacked over stages, as
`repro.models.init_params` returns it) and returns the port's
`Transformer` with the same values, one parameter tree per layer;
`params_to_reference(model)` restacks them into the reference's tree.

`place_model(model, specs, mesh)` and `place_cache(cfg, cache, specs,
mesh)` place a `Transformer`'s parameters and a decode cache onto a mesh
by the sharding rules' trees (`parallel.sharding.param_pspecs`,
`cache_pspecs`), each rank keeping only its block; the dry run places its
fake tensors through the same walk.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.core.engine import DiskIndex, SearchConfig
from repro_torch.core.memgraph import MemGraph
from repro_torch.core.pages import PageLayout
from repro_torch.core.pq import PQ
from repro_torch.models.transformer import (Transformer, num_blocks,
                                            reference_cache, reference_tree,
                                            stage_len)
from repro_torch.mutation.mutable_index import (MutableIndex, MutationConfig,
                                                mutable_state)
from repro_torch.parallel.api import P, NamedSharding, distribute
from repro_torch.training.tree import tree_items


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


def _leaf(a, device) -> torch.Tensor:
    """One array of a reference tree as a tensor of its dtype; bfloat16
    (which numpy lacks) goes through float32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32),
                               device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(a, copy=True), device=device)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(params, cfg, device=None) -> Transformer:
    """The port's Transformer holding `params`, a reference parameter tree
    for `cfg`: stage s, position j of the stacked "stages" becomes block
    s * stage_len + j, and each stacked encoder layer an encoder block."""
    device = resolve_device(device)
    sl = stage_len(cfg)

    def leaf(a):
        return _leaf(a, device)

    blocks = [_tree(params["stages"][f"pos{i % sl}"],
                    lambda a, s=i // sl: _leaf(np.asarray(a)[s], device))
              for i in range(num_blocks(cfg))]
    tree = {"embed": _tree(params["embed"], leaf), "blocks": blocks,
            "final_norm": _tree(params["final_norm"], leaf),
            "lm_head": leaf(params["lm_head"])}
    if "encoder" in params:
        tree["encoder"] = [
            _tree(params["encoder"], lambda a, e=e: _leaf(np.asarray(a)[e],
                                                          device))
            for e in range(cfg.encoder_layers)]
        tree["enc_norm"] = _tree(params["enc_norm"], leaf)
    return Transformer(cfg, tree)


def params_to_reference(model: Transformer) -> dict:
    """`model`'s parameters as the reference's tree of numpy arrays, the
    blocks stacked over stages (the inverse of `params_from_reference`).
    bfloat16 leaves come back as float32, exactly, since numpy has no
    bfloat16."""
    def leaf(st):
        v = st.value()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return _tree(reference_tree(model), leaf)


# ---------------------------------------------------------------------------
# placing a model and a cache on a mesh


def _spec_at(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def _stacked_specs(tree, specs) -> Dict[int, P]:
    """{id(tensor): spec} for the tensors of a tree of `StackedLeaf`s (the
    reference's layout), each tensor placed by its leaf's spec, less the
    stage dim for stacked leaves."""
    out = {}
    for path, leaf in tree_items(tree):
        spec = _spec_at(specs, path)
        for t in leaf.params:
            out[id(t)] = P(*spec[1:]) if leaf.stacked else spec
    return out


def _distribute(mesh):
    def leaf(t, spec):
        return distribute(t.detach(), NamedSharding(mesh, spec))
    return leaf


def place_model(model: Transformer, specs, mesh,
                leaf: Optional[Callable] = None) -> Transformer:
    """`model` with each parameter a DTensor on `mesh` placed by `specs`
    (`sharding.param_pspecs`' tree): `leaf(tensor, spec)` makes it, by
    default this rank's block of the tensor copied to the mesh's device
    (`api.distribute`, no communication; every rank holds `model`
    whole)."""
    leaf = leaf or _distribute(mesh)
    by_id = _stacked_specs(reference_tree(model), specs)

    def tree(module: nn.Module):
        out: Dict[str, object] = {
            k: leaf(p, by_id[id(p)])
            for k, p in module.named_parameters(recurse=False)}
        for k, child in module.named_children():
            out[k] = ([tree(c) for c in child]
                      if isinstance(child, nn.ModuleList) else tree(child))
        return out

    return Transformer(model.cfg, tree(model))


def place_cache(cfg, cache, specs, mesh, leaf: Optional[Callable] = None):
    """The per-layer decode cache `cache` (as `init_cache` makes it) as
    DTensors on `mesh` placed by `specs` (`sharding.cache_pspecs`, the
    reference's stacked tree); `leaf` as in `place_model`."""
    leaf = leaf or _distribute(mesh)
    by_id = _stacked_specs(reference_cache(cfg, cache), specs)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        return leaf(x, by_id[id(x)])

    return [place(c) for c in cache]
