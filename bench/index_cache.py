"""The built index of a query configuration, kept between runs.

A disk-resident index is built offline and loaded when a server starts. So
the first run of a configuration in a checkout builds its index with the
port's builder and writes it under `build/bench_index/<config>/<key>/`;
every later run loads it. The key hashes what the build reads of the
configuration file (BUILD_KEYS, BUILD_SEARCH_KEYS: not the search's L, beam
or limits), the port's `core/` and `io/` sources and the benchmark files
that make the data and the build, so an edit to any of them builds anew. The whole `DiskIndex` is
pickled as `build_index` returned it, before any search touched it, and the
base vectors are kept beside it.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import time
from pathlib import Path

import numpy as np

from bench import data

KEY_SOURCES = ("src/repro_torch/core", "src/repro_torch/io")
KEY_FILES = ("bench/data.py", "bench/index_cache.py")
BUILD_KEYS = ("dataset", "n", "data_seed", "build_seed", "vamana")
BUILD_SEARCH_KEYS = ("pq_m", "page_bytes", "page_shuffle", "all_in_storage",
                     "cache_frac", "cache_policy", "memgraph_frac")


def cache_key(root: Path, config: dict) -> str:
    """sha256 over what the build reads of `config` and the sources the
    build runs."""
    h = hashlib.sha256()
    build = {k: config[k] for k in BUILD_KEYS}
    build["search"] = {k: config["search"][k] for k in BUILD_SEARCH_KEYS}
    h.update(json.dumps(build, sort_keys=True).encode())
    files = [root / f for f in KEY_FILES]
    for d in KEY_SOURCES:
        files += sorted((root / d).glob("*.py"))
    for f in files:
        h.update(str(f.relative_to(root)).encode())
        h.update(b"\0")
        h.update(f.read_bytes())
        h.update(b"\0")
    return h.hexdigest()[:16]


def cache_dir(root: Path, config_name: str, config: dict,
              base: Path | None = None) -> Path:
    """`base` (default: the checkout's build/bench_index)/<config>/<key>."""
    base = root / "build" / "bench_index" if base is None else base
    return base / config_name / cache_key(root, config)


def build(config: dict, search_cfg, device, log=print):
    """(DiskIndex, base vectors, DataModel, build seconds) built by the
    port's builder: Vamana at the configuration's batch, then `build_index`
    on that graph."""
    from repro_torch.core.builder import build_index
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.vamana import build_vamana
    x, model = data.make_base(config["dataset"], config["n"],
                              config["data_seed"])
    vm = config["vamana"]
    t0 = time.perf_counter()
    graph, med, _ = build_vamana(x, R=vm["R"], L=vm["L_build"],
                                 alpha=vm["alpha"], seed=config["build_seed"],
                                 batch=vm["batch"], device=device)
    log(f"[setup] vamana_s={time.perf_counter() - t0:.3f}")
    d = x.shape[1]
    ds = Dataset(config["dataset"], x, np.zeros((0, d), np.float32),
                 np.zeros((0, 10), np.int32), data.SPECS[config["dataset"]][1])
    index = build_index(ds, search_cfg, R=vm["R"], L_build=vm["L_build"],
                        alpha=vm["alpha"], seed=config["build_seed"],
                        graph=graph, medoid_id=med, device=device)
    return index, x, model, time.perf_counter() - t0


def load_or_build(root: Path, config_name: str, config: dict, search_cfg,
                  device, log=print, base: Path | None = None):
    """(DiskIndex, base vectors, DataModel, {"built": bool, "seconds": s}).
    Writes go to temporary names in the cache directory, renamed once
    complete."""
    where = cache_dir(root, config_name, config, base)
    done = where / "done.json"
    t0 = time.perf_counter()
    if done.exists():
        with open(where / "index.pkl", "rb") as f:
            index, model = pickle.load(f)
        index.device = device
        if index.memgraph is not None:
            index.memgraph.device = device
        x = np.load(where / "vectors.npy")
        return index, x, model, {"built": False,
                                 "seconds": time.perf_counter() - t0}
    index, x, model, build_s = build(config, search_cfg, device, log)
    where.mkdir(parents=True, exist_ok=True)
    tmp = where / f"index.pkl.part{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump((index, model), f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(where / "index.pkl")
    tmp = where / f"vectors.part{os.getpid()}.npy"
    np.save(tmp, x)
    tmp.replace(where / "vectors.npy")
    done.write_text(json.dumps({"build_s": build_s,
                                "build_stats": index.build_stats},
                               default=float))
    log(f"[setup] index built in {build_s:.3f} s, kept in {where}")
    return index, x, model, {"built": True,
                             "seconds": time.perf_counter() - t0}
