"""The readings that the limits of `correct` were set from.

    python3 bench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9
    python3 bench/control.py --workload <cell> --codebook

For each of `--seeds`, the program's answers at the cell's call size for
the sample a run would check (drawn from the seed over the pool), compared
with the reference as a run compares them: the lower readings. For each of
`--control-seeds`, the control, the reference computed in bfloat16 put in
the program's place, compared the same way: the upper readings. One JSON
line a seed. The index is loaded (or built) once, in one process.
`--codebook` reads codebook_gap alone, without an index: the program's
`train_pq` as the builder calls it, and the reference's k-means in
bfloat16, each against the reference's in float32.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def readings(rx, cfg: dict, queries, vectors, answers, picks, dev) -> dict:
    from bench import check
    out = check.compare_sample(rx, cfg, queries, answers, picks)
    rows = answers["rows"][picks]
    out["dist_err_max"] = check.dist_err_max(
        vectors, queries[rows], answers["ids"][picks], answers["dists"][picks])
    out["recall_gap"] = 1.0 - check.recall_at_10(
        vectors, queries, rows, answers["ids"][picks], dev)
    return out


def main(argv=None) -> int:
    import torch

    from bench import harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--codebook", action="store_true")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else "cpu"
    cell = harness.load_cell(ROOT, args.workload)
    if args.codebook:
        codebook_report(cell.config, dev)
    else:
        report(cell, args.seeds, args.control_seeds, dev)
    return 0


def codebook_report(config: dict, dev) -> list:
    """codebook_gap of the program's k-means and of the control, without
    building the index."""
    from bench import data
    from bench.reference import codebook
    from repro_torch.core.pq import train_pq
    x, _ = data.make_base(config["dataset"], config["n"], config["data_seed"])
    m, seed = config["search"]["pq_m"], config["build_seed"]
    ref = codebook.train(x, m, seed, **config["pq_train"])
    lines = []
    for kind in ("program", "control"):
        t0 = time.perf_counter()
        if kind == "program":
            mine = train_pq(x, m=m, seed=seed, device=dev).centroids
        else:
            mine = codebook.train(x, m, seed, **config["pq_train"],
                                  precision="bfloat16")
        r = {"kind": kind, "codebook_gap": codebook.gap(mine, ref),
             "seconds": time.perf_counter() - t0}
        lines.append(r)
        print(json.dumps(r), flush=True)
    return lines


def report(cell, seeds: str, control_seeds: str, dev,
           cache_base=None) -> list:
    """Prints one JSON line a seed, and returns them."""
    import numpy as np

    from bench import check, harness, index_cache, traffic
    from repro_torch.core.engine import SearchConfig
    config, mix = cell.config, cell.mix
    cfg = SearchConfig(**config["search"])
    index, vectors, model, _ = index_cache.load_or_build(
        ROOT, cell.config_name, config, cfg, dev,
        lambda m: print(m, file=sys.stderr, flush=True), cache_base)
    cap = traffic.warm_sizes(mix)[-1]
    from bench.reference import codebook
    prog = harness.program_arrays(index, config)
    rx = check.ref_index(vectors, prog, config)
    sc = config["search"]
    gaps = {"program": check.codebook_gap(rx, prog),
            "control": codebook.gap(codebook.train(
                vectors, sc["pq_m"], config["build_seed"],
                **config["pq_train"], precision="bfloat16"), rx.centroids)}
    lines = []
    for kind, text in (("program", seeds), ("control", control_seeds)):
        for seed in [int(s) for s in text.split(",") if s]:
            t0 = time.perf_counter()
            queries = model.queries(seed, mix["pool"])
            rows = np.arange(len(queries))
            picks = check.draw_sample(rows, np.zeros(len(rows)),
                                      mix["sample"], seed)
            if kind == "program":
                parts = [index.search(queries[picks[s:s + cap]], cfg,
                                      batch=cap)
                         for s in range(0, len(picks), cap)]
                ans = {"rows": picks}
                for f in ("ids", "dists") + check.COUNTS:
                    ans[f] = np.concatenate(
                        [np.asarray(getattr(p, f)) for p in parts])
            else:
                ans = check.reference_answers(rx, sc, queries, picks,
                                              "bfloat16")
            at = np.arange(len(picks))
            r = readings(rx, sc, queries, vectors, ans, at, dev)
            r.update(kind=kind, seed=seed, sampled=len(picks),
                     codebook_gap=gaps[kind],
                     seconds=time.perf_counter() - t0)
            lines.append(r)
            print(json.dumps(r), flush=True)
    return lines


if __name__ == "__main__":
    sys.exit(main())
