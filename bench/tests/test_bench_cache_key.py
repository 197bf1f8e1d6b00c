"""The index cache: its key follows what the build reads, and a built index
is loaded back whole."""
from __future__ import annotations

import copy
import json

import numpy as np

from bench import index_cache
from bench.tests.conftest import ROOT

CONFIG = json.loads((ROOT / "bench/configs/deep1m-octopusann.json").read_text())


def test_key_changes_with_a_build_key():
    key = index_cache.cache_key(ROOT, CONFIG)
    for path in [("n",), ("data_seed",), ("vamana", "R"), ("vamana", "batch"),
                 ("search", "page_shuffle"), ("search", "memgraph_frac")]:
        c = copy.deepcopy(CONFIG)
        d = c
        for p in path[:-1]:
            d = d[p]
        d[path[-1]] = (not d[path[-1]] if isinstance(d[path[-1]], bool)
                       else d[path[-1]] + 1)
        assert index_cache.cache_key(ROOT, c) != key, path


def test_key_ignores_what_only_the_search_reads():
    c = copy.deepcopy(CONFIG)
    c["search"]["L"] += 16
    c["limits"]["id_mismatch"] = 0.5
    assert index_cache.cache_key(ROOT, c) == index_cache.cache_key(ROOT, CONFIG)


def test_built_then_loaded(tiny_cell, tmp_path):
    from repro_torch.core.engine import SearchConfig
    cell = tiny_cell("deep1m-octopusann.batch256")
    cfg = SearchConfig(**cell.config["search"])
    args = (ROOT, cell.config_name, cell.config, cfg, "cpu", lambda m: None,
            tmp_path)
    idx, x, model, info = index_cache.load_or_build(*args)
    idx2, x2, model2, info2 = index_cache.load_or_build(*args)
    assert info["built"] and not info2["built"]
    np.testing.assert_array_equal(idx.graph, idx2.graph)
    np.testing.assert_array_equal(idx.layout.page_vids, idx2.layout.page_vids)
    np.testing.assert_array_equal(x, x2)
    q = model2.queries(4, 8)
    np.testing.assert_array_equal(idx.search(q, cfg).ids,
                                  idx2.search(q, cfg).ids)
    assert [p.name for p in tmp_path.rglob("*part*")] == []
