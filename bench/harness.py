"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides `correct`.

Everything that belongs to one configuration, traffic mix or metric is
found by name from the cell's entry in BENCHMARK.json:
`bench/configs/<config>.json` (from the configuration's `file`),
`bench/traffic/<traffic>.json`, and `bench/metrics/<metric>.py` (or the
`<base>.py` of a split metric `<base>.<kind>`), a reader with
`read(record) -> float | None` for each metric the cell reports.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench import check, index_cache, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic" /
                      f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and ("workloads" in m or m["moves"] in moved)]
    return Cell(workload, w["chips"], w["config"], config, mix, e2e,
                per_layer)


def reader(root: Path, metric: str):
    """The reader `bench/metrics/<metric>.py`, or else, for a metric split
    by cell kind (`hops_per_query.online`), the shared `<base>.py`."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = path.with_name(metric.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def answers_of(window) -> dict:
    """The program's answers of the window, one row per query answered."""
    st = [c.stats for c in window.calls]
    out = {"rows": np.concatenate([c.rows for c in window.calls])}
    for f in ("ids", "dists", "hops", "page_reads", "cache_hits", "mem_hops"):
        out[f] = np.concatenate([np.asarray(getattr(s, f)) for s in st])
    return out


def program_arrays(index, config: dict) -> dict:
    """What the reference reads of the built index: the graph and medoid,
    the page order, the PQ codebook, the vertex cache and the MemGraph."""
    mg = index.memgraph
    out = {"graph": index.graph, "medoid": int(index.medoid),
           "page_vids": index.layout.page_vids,
           "centroids": index.pq.centroids, "cached": index.cached,
           "build_seed": config["build_seed"]}
    if mg is not None:
        out.update(mem_graph=mg.graph, mem_ids=mg.sample_ids,
                   mem_medoid=int(mg.medoid))
    return out


def record_of(setup_s: float, window, ans: dict, config: dict) -> dict:
    """What the metric readers read."""
    calls = np.array([c.end - c.start for c in window.calls])
    return {"setup_s": setup_s, "window_s": window.seconds,
            "attempted": window.attempted, "answered": len(ans["rows"]),
            "latencies_s": window.latencies, "call_s": calls,
            "counts": {f: float(np.sum(ans[f])) for f in check.COUNTS},
            "memgraph": config["search"]["memgraph_frac"] > 0,
            "cache": config["search"]["cache_frac"] > 0,
            "profile": window.profile}


def run(root: Path, cell: Cell, seed: int, seconds: float, traced: bool,
        device, t_start: float, log, cache_base: Path | None = None
        ) -> dict | None:
    """One run; returns the result line's object, or None where a module
    of the JAX package was loaded. `cache_base` moves the index cache (the
    tests keep theirs in a temporary directory)."""
    from repro_torch.core.engine import SearchConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, mix = cell.config, cell.mix
    cfg = SearchConfig(**config["search"])
    index, vectors, model, info = index_cache.load_or_build(
        root, cell.config_name, config, cfg, device, log, cache_base)
    queries = model.queries(seed, mix["pool"])
    for b in traffic.warm_sizes(mix):
        with trace.span(trace.CALL):
            index.search(queries[:b], cfg, batch=b)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[setup] setup_s={setup_s:.3f} index_built={info['built']} "
        f"index_load_s={info['seconds']:.3f}")

    def search(qb, batch):
        return index.search(qb, cfg, batch=batch)

    window = traffic.drive(search, queries, mix, seconds, traced,
                           lambda: _sync(device), seed)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        log(f"[error] modules of the JAX package loaded: {found}")
        return None
    ans = answers_of(window)
    rec = record_of(setup_s, window, ans, config)
    q = np.percentile(rec["call_s"], [25, 50, 75, 100]) * 1e3
    log(f"[window] {len(window.calls)} calls in {window.seconds:.3f} s; call "
        f"ms p25 {q[0]:.3f} p50 {q[1]:.3f} p75 {q[2]:.3f} max {q[3]:.3f}")
    if window.lateness is not None and len(window.lateness):
        log(f"[window] generator lateness: wake-ups {len(window.lateness)}, "
            f"p50 {np.median(window.lateness) * 1e3:.4f} ms, max "
            f"{window.lateness.max() * 1e3:.4f} ms")
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(root, m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    prog = program_arrays(index, config)
    del index, search
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rx = check.ref_index(vectors, prog, config)
    picks = check.draw_sample(ans["rows"], ans["hops"], mix["sample"], seed)
    values = check.compare_sample(rx, config["search"], queries, ans, picks)
    values["dist_err_max"] = check.dist_err_max(
        vectors, queries[ans["rows"]], ans["ids"], ans["dists"])
    values["start_mismatch"] = check.start_mismatch(rx, prog)
    values["codebook_gap"] = check.codebook_gap(rx, prog)
    recall = check.recall_at_10(vectors, queries, ans["rows"], ans["ids"],
                                device)
    values["recall_gap"] = 1.0 - recall
    correct, checks = check.judge(values, config["limits"])
    correct = correct and window.failed == 0
    log(f"[check] reference_s={time.perf_counter() - t0:.3f} "
        f"sampled={len(picks)} answered={len(ans['rows'])} "
        f"recall_at_10={recall:.6f}")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(window.attempted),
           "failed": int(window.failed), "metrics": metrics, "device": dev}
    if traced and window.profile is not None:
        dev["busy_s"] = window.profile["busy_s"]
        dev["window_s"] = window.profile["window_s"]
        out["breakdown"] = window.profile["breakdown"]
    out["info"] = {"recall_at_10": recall, "setup_s": setup_s,
                   "index_built": info["built"]}
    out["checks"] = checks
    return out
