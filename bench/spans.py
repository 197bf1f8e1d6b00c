"""Where a cell's search calls spend their time, by the program's host-clock
spans (`DiskIndex.search(..., tracer=Tracer(clock="host"))`, see
docs/torch_host_clock.md), laid over torch.profiler's trace of the first calls.

    python3 bench/spans.py --workload <name> --seed <n> [--seconds <s>]
        [--cost-pairs 30]

from the root of a checkout runs the cell's set-up and traffic as a run of
bench/run.py does, with a host tracer passed to every call of the window
and torch.profiler over the calls the traffic mix profiles. The last line
of standard output is one JSON object: `split` (the stage times and counts
of the calls after the profiler stopped), `profile` (launches per hop and
device idle time by program span over the profiled calls), `cost` (median
call time with the tracer against without, on one batch, alternating) and
`card`. `--seconds` defaults to BENCHMARK.json's `run_seconds`. It checks no
answer: bench/run.py is the run that decides `correct`.

The two readers, `split` and `over_profile`, take plain records and hold
no state of the run.
"""
from __future__ import annotations

import bisect
import statistics
import time
from collections import defaultdict

STAGES = ("search.memgraph", "search.upload", "search.hops",
          "search.readback", "search.stats")
HOPS = ("search.hop", "mem.hop")
WAITS = ("search.sync", "search.readback")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
OUTSIDE = "outside the program"


def split(spans, first: int = 0) -> dict | None:
    """Means over the search calls whose id is `first` or later, from the
    tracer's spans (Span records on the host clock, us): `call_ms`, each
    stage's ms a call, `stage_cover` (share of the call's time in its
    stages), the call's counts a call, and `sync_wait_share` (% of call
    time inside `search.sync` or `search.readback`, where the host waits
    on the device). None where no such call was recorded."""
    calls = [s for s in spans if s.name == "search.call" and s.parent is None
             and s.qid >= first]
    if not calls:
        return None
    ids = {s.qid for s in calls}
    root = {}
    stage = defaultdict(float)
    waits = 0.0
    for i, s in enumerate(spans):
        if s.qid not in ids:
            continue
        if s.parent is None:
            root[s.qid] = i
        elif s.parent == root.get(s.qid) and s.name in STAGES:
            stage[s.name] += s.dur_us
        if s.name in WAITS:
            waits += s.dur_us
    n = len(calls)
    call_us = sum(s.dur_us for s in calls)
    counts = defaultdict(float)
    for s in calls:
        for k, v in (s.args or {}).items():
            counts[k] += v
    out = {"calls": n, "call_ms": call_us / n / 1e3,
           "stage_ms": {k: stage[k] / n / 1e3 for k in STAGES},
           "stage_cover": sum(stage.values()) / call_us if call_us else None,
           "sync_wait_share": 100.0 * waits / call_us if call_us else None}
    for k in ("queries", "batches", "hop_iters", "mem_iters", "syncs"):
        out[k + "_per_call"] = counts[k] / n
    return out


def _busy_in(busy, starts, s, e) -> float:
    """Time in [s, e] covered by the sorted, merged intervals `busy`."""
    t = 0.0
    j = max(0, bisect.bisect_right(starts, s) - 1)
    while j < len(busy) and busy[j][0] < e:
        t += max(0.0, min(e, busy[j][1]) - max(s, busy[j][0]))
        j += 1
    return t


def _innermost(prog, a, b):
    """(start, end, name) pieces of [a, b], each under the innermost
    program span open then (spans of one thread nest), or OUTSIDE."""
    edges = []
    for s, e, name in prog:
        if e > a and s < b and e > s:
            edges.append((max(s, a), 1, name))
            edges.append((min(e, b), 0, name))
    edges.sort(key=lambda x: (x[0], x[1]))   # an end before a start at a tie
    pieces, stack, t = [], [], a
    for when, opens, name in edges:
        if when > t:
            pieces.append((t, when, stack[-1] if stack else OUTSIDE))
            t = when
        if opens:
            stack.append(name)
        elif stack:
            stack.pop()
    if b > t:
        pieces.append((t, b, stack[-1] if stack else OUTSIDE))
    return pieces


def over_profile(events: list, program: list, calls: int | None = None,
                 call: str = "bench.call") -> dict | None:
    """Reads a torch.profiler Chrome trace's `events` and the program's
    host-clock events moved onto its clock (`program`, from
    repro_torch.obs.export.on_profiler_clock), over the first `calls`
    harness spans named `call` (all of them where None). Returns
    `launches_per_hop` (kernel launches starting inside a `search.hop`
    span, over those spans), `idle_by_span` (s of device idle time under
    the innermost program span then, OUTSIDE under the harness span
    alone), `device_idle_share` and `dispatch_idle_share` (% of the calls'
    time the device is idle, and the part of it with the host inside a
    hop but not in its sync), and for each `search.call` how far its start
    lies from its harness span's and how long before its end it ends
    (us). None where the trace holds no harness span or no device
    operation."""
    from bench.trace import DEVICE_CATS, union
    dev, spans, launches = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, e))
        elif cat == "user_annotation" and ev.get("name") == call:
            spans.append((s, e))
        elif cat == "cuda_runtime" and ev.get("name", "").startswith(LAUNCHES):
            launches.append(s)
    spans.sort()
    spans = spans if calls is None else spans[:calls]
    if not spans or not dev:
        return None
    busy = union(dev)
    starts = [a for a, _ in busy]
    launches.sort()
    # a parent before the child that starts with it
    prog = sorted(((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                    ev["name"]) for ev in program if ev.get("ph") == "X"),
                  key=lambda p: (p[0], -p[1]))
    idle = defaultdict(float)
    call_s = hops = in_hops = 0.0
    lags, margins = [], []
    for a, b in spans:
        call_s += b - a
        for s, e, name in _innermost(prog, a, b):
            idle[name] += (e - s) - _busy_in(busy, starts, s, e)
        for s, e, name in prog:
            if e <= a or s >= b:
                continue
            if name == "search.hop":
                hops += 1
                in_hops += (bisect.bisect_right(launches, e)
                            - bisect.bisect_left(launches, s))
            elif name == "search.call":
                lags.append(s - a)
                margins.append(b - e)
    us = 1e-6
    idle_s = sum(idle.values())
    dispatch = sum(idle[h] for h in HOPS)
    return {"calls": len(spans), "call_s": call_s * us,
            "hop_spans": int(hops), "launches_in_hops": int(in_hops),
            "launches_per_hop": in_hops / hops if hops else None,
            "device_idle_share": 100.0 * idle_s / call_s,
            "dispatch_idle_share": 100.0 * dispatch / call_s,
            "idle_by_span": {k: v * us for k, v in
                             sorted(idle.items(), key=lambda kv: -kv[1])},
            "call_start_lag_us": lags, "call_end_margin_us": margins}


def tracing_cost(search, qb, pairs: int, sync) -> dict:
    """Median wall time of `search(qb, tracer)` with a fresh host tracer
    against `tracer=None`, in alternating order, `pairs` of each; and the
    tracer's own cost a span (one begin and end)."""
    from repro_torch.obs import Tracer
    on, off, spans = [], [], 0
    for i in range(pairs):
        for traced in ((True, False) if i % 2 else (False, True)):
            tracer = Tracer(clock="host") if traced else None
            t0 = time.perf_counter()
            search(qb, tracer)
            sync()
            (on if traced else off).append(time.perf_counter() - t0)
            spans = len(tracer.spans) if traced else spans
    tracer = Tracer(clock="host")
    t0 = time.perf_counter()
    for _ in range(20000):
        tracer.end(tracer.begin("x", "search"))
    per_span = (time.perf_counter() - t0) / 20000
    med_on = statistics.median(on) * 1e3
    med_off = statistics.median(off) * 1e3
    return {"pairs": pairs, "queries": len(qb), "on_ms": med_on,
            "off_ms": med_off, "cost_share": 100.0 * (med_on / med_off - 1),
            "spans_per_call": spans, "us_per_span": per_span * 1e6,
            "spans_ms": spans * per_span * 1e3}


def measure(root, cell, seed: int, seconds: float, cost_pairs: int, device,
            log, cache_base=None) -> dict:
    """One run of `cell` with the program's host tracer on every call of
    the window (see the module's docstring); `cache_base` moves the index
    cache as in harness.run. The window is traffic.drive's, untraced, with
    bench.trace's Profile over the same first calls as in a traced run:
    `step` is given the calls done and the time the last one ended, as the
    generator gives it, but at the start of the next call, so the stop's
    cost falls in that call, which `split` leaves out."""
    t_start = time.perf_counter()
    import json
    import os
    import tempfile

    import numpy as np
    import torch

    from bench import index_cache, trace, traffic
    from repro_torch.core.engine import SearchConfig
    from repro_torch.obs import Tracer
    from repro_torch.obs.export import on_profiler_clock

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    mix = cell.mix
    cfg = SearchConfig(**cell.config["search"])
    index, _, model, info = index_cache.load_or_build(
        root, cell.config_name, cell.config, cfg, device, log, cache_base)
    queries = model.queries(seed, mix["pool"])
    for b in traffic.warm_sizes(mix):
        with trace.span(trace.CALL):
            index.search(queries[:b], cfg, batch=b,
                         tracer=Tracer(clock="host"))
    sync()
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(clock="host")
    state = {"calls": 0, "profiled": None, "te": 0.0}

    def ended():
        sync()
        state["te"] = time.perf_counter() - t0

    def search(qb, batch):
        if prof.on:
            prof.step(state["calls"], state["te"])
            if not prof.on:
                state["profiled"] = state["calls"]
        state["calls"] += 1
        return index.search(qb, cfg, batch=batch, tracer=tracer)

    prof = trace.Profile(calls=mix.get("profile_calls"),
                         seconds=mix.get("profile_seconds"))
    t0 = time.perf_counter()
    window = traffic.drive(search, queries, mix, seconds, False, ended, seed)
    if state["profiled"] is None:
        prof.stop()
        state["profiled"] = state["calls"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    res = over_profile(doc["traceEvents"], on_profiler_clock(
        tracer.to_chrome(), int(doc.get("baseTimeNanoseconds", 0))),
        calls=state["profiled"])
    if res is not None:
        log("[trace] idle by span (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in res["idle_by_span"].items()))
    # the call in which the profiler stopped is left out too
    first = state["profiled"] + 1
    later = [c.stats for c in window.calls[first:]]
    size = mix["batch"] if mix["loop"] == "closed" else mix["max_batch"]
    cost = tracing_cost(
        lambda qb, tr: index.search(qb, cfg, batch=size, tracer=tr),
        queries[:size], cost_pairs, sync)
    return {"workload": cell.name, "seed": seed, "setup_s": setup_s,
            "index_built": info["built"], "window_calls": len(window.calls),
            "window_s": window.seconds, "profiled_calls": state["profiled"],
            "split": split(tracer.spans, first=first),
            "hops_per_query": (float(np.mean(np.concatenate(
                [s.hops for s in later]))) if later else None),
            "mem_hops_per_query": (float(np.mean(np.concatenate(
                [s.mem_hops for s in later]))) if later else None),
            "profile": res, "cost": cost,
            "card": (torch.cuda.get_device_name(device) if on_card
                     else "cpu")}


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    for p in (root / "src", root):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window; BENCHMARK.json's run_seconds if left out")
    ap.add_argument("--cost-pairs", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from bench import harness
    seconds = args.seconds
    if seconds is None:
        seconds = json.loads((root / "BENCHMARK.json").read_text())[
            "run_seconds"]
    torch.set_num_threads(1)
    out = measure(root, harness.load_cell(root, args.workload), args.seed,
                  seconds, args.cost_pairs, args.device,
                  lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
