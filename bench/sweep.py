"""The one-off sweeps that fixed a configuration's L and an open loop's rate.

    python3 bench/sweep.py L --workload <cell> [--values 64,80,96,128,160] [--write]
    python3 bench/sweep.py rate --workload <open-loop cell> --rates 20,25,... \
        [--seeds 0,1] [--seconds 51] [--write]

`L`: searches the pool of seed 0 at each L through DiskIndex.search and
reads recall@10 against the exact top-10; the configuration's L is the
smallest value whose recall reaches `target_recall` (0.90, the paper's
matched-recall point). `rate`: runs the open loop as a run of the cell runs
it, at each rate in ascending order and on each seed; a rate holds on a
seed where its last third of requests waits no more than 1.5 times its
first third at the 95th percentile (no growing backlog) and nothing is
left unanswered. The knee is the highest rate below the first that does
not hold on every seed (the sweep stops there), and the cell's rate is 4/5
of it. `--write` records the readings (and the choice) in the
configuration or traffic file.
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


def say(**kv) -> None:
    print(json.dumps(kv), flush=True)


def main(argv=None) -> int:
    import numpy as np
    import torch

    from bench import check, harness, index_cache, traffic
    from repro_torch.core.engine import SearchConfig
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("L", "rate"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--values", default="64,80,96,128,160")
    ap.add_argument("--target-recall", type=float, default=0.90)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)        # as bench/run.py runs the window
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else "cpu"
    cell = harness.load_cell(ROOT, args.workload)
    config, mix = cell.config, cell.mix
    cfg = SearchConfig(**config["search"])
    index, vectors, model, info = index_cache.load_or_build(
        ROOT, cell.config_name, config, cfg, dev,
        lambda m: print(m, file=sys.stderr, flush=True))
    say(setup=info, device=str(dev))
    queries = model.queries(args.seed, mix["pool"])
    for b in [256] + traffic.warm_sizes(mix):
        index.search(queries[:b], cfg, batch=b)
    if args.what == "L":
        rows = np.arange(len(queries))
        readings = {}
        for L in [int(v) for v in args.values.split(",")]:
            c = cfg.replace(L=L)
            harness._sync(dev)
            t0 = time.perf_counter()
            st = index.search(queries, c, batch=256)
            wall = time.perf_counter() - t0
            r = check.recall_at_10(vectors, queries, rows, st.ids, dev)
            readings[str(L)] = {"recall_at_10": r, "queries_per_s": len(rows) / wall,
                                "hops": float(st.hops.mean()),
                                "page_reads": float(st.page_reads.mean())}
            say(L=L, **readings[str(L)])
        ok = [int(L) for L, v in readings.items()
              if v["recall_at_10"] >= args.target_recall]
        chosen = min(ok) if ok else None
        say(chosen_L=chosen)
        if args.write and chosen is not None:
            path = ROOT / [c for c in json.loads(
                (ROOT / "BENCHMARK.json").read_text())["configs"]
                if c["name"] == cell.config_name][0]["file"]
            conf = json.loads(path.read_text())
            conf["search"]["L"] = chosen
            conf["L_sweep"] = {"seed": args.seed, "queries": len(rows),
                               "target_recall": args.target_recall,
                               "readings": readings, "chosen": chosen}
            path.write_text(json.dumps(conf, indent=1) + "\n")
        return 0
    sweep, knee = {}, None
    for rate in [float(v) for v in args.rates.split(",")]:
        held = True
        for seed in [int(v) for v in args.seeds.split(",")]:
            v = rate_reading(index, cfg, model.queries(seed, mix["pool"]),
                             mix, rate, args.seconds, seed, dev)
            sweep[f"{rate}@{seed}"] = v
            say(rate=rate, seed=seed, **v)
            held = held and not v["failed"] and (
                v["late_p95_ms"] <= 1.5 * v["early_p95_ms"])
        if not held:
            break
        knee = rate
    say(knee=knee, rate=None if knee is None else 0.8 * knee)
    if args.write and knee is not None:
        w = json.loads((ROOT / "BENCHMARK.json").read_text())
        name = {x["name"]: x for x in w["workloads"]}[args.workload]["traffic"]
        path = ROOT / "bench" / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t["rate_per_s"] = round(0.8 * knee, 3)
        t["rate_sweep"] = {"workload": args.workload, "seeds": args.seeds,
                           "seconds": args.seconds,
                           "readings (rate@seed)": sweep, "knee": knee}
        path.write_text(json.dumps(t, indent=1) + "\n")
    return 0


def rate_reading(index, cfg, queries, mix, rate, seconds, seed, dev) -> dict:
    """One open-loop window at `rate`, as a run drives it."""
    import numpy as np

    from bench import harness, traffic
    w = traffic.open_loop(lambda qb, b: index.search(qb, cfg, batch=b),
                          queries, dict(mix, rate_per_s=rate, drain_s=5.0),
                          seconds, False, lambda: harness._sync(dev), seed)
    lat = np.full(w.attempted, np.nan)
    lat[:len(w.latencies)] = w.latencies
    third = max(1, w.attempted // 3)
    head, tail = lat[:third], lat[-third:]
    late = (traffic.nearest_rank(tail[~np.isnan(tail)], 95)
            if (~np.isnan(tail)).any() else float("inf"))
    return {"offered": w.attempted, "failed": w.failed,
            "p50_ms": 1e3 * traffic.nearest_rank(w.latencies, 50),
            "p95_ms": 1e3 * traffic.nearest_rank(w.latencies, 95),
            "early_p95_ms": 1e3 * traffic.nearest_rank(
                head[~np.isnan(head)], 95),
            "late_p95_ms": 1e3 * late,
            "mean_call_size": float(np.mean([len(c.rows) for c in w.calls])),
            "call_ms": 1e3 * float(np.mean([c.end - c.start
                                            for c in w.calls]))}


if __name__ == "__main__":
    sys.exit(main())
