#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: n = 1,000,000 vectors
    python3 chip_smoke.py --n 50000  # a quick rehearsal at a smaller n
    python3 chip_smoke.py --n 100000 --vamana-batch 1024  # the builder's batch

Phases, each printed on its own line; any failure raises and exits non-zero:

1. device   the card's name and power limit (nvidia-smi), torch and CUDA
            versions, TF32 off for matmul and cuDNN, and the seconds
            taken to build the CUDA kernels from kernels/csrc/ with nvcc.
2. build    make_dataset("deep-like", n, nq=1000) with its ground truth on
            the card; the Vamana graph once, with the builder's defaults
            (R=64, L_build=125, alpha=1.2) but 8192 nodes per batch
            (--vamana-batch); then
            build_index on that graph (PQ, page layout, page shuffle, cache,
            MemGraph) for each index the presets need.
3. search   presets baseline, diskann, starling, pipeann, octopusann and
            pipeline with pipeline="fused", through DiskIndex.search: recall@10
            against the exact ground truth, mean page reads and hops, the
            modelled QPS of the SSD model, the measured queries/s of the
            search on the card, and for the fused run its mean
            measured_step_us. The kernels' launch counts are set to 0 just
            before the fused search and the split measurement of its page
            schedule (measure_step_us(mode="split")), and read just after.
4. parity   the same small index searched on the card and on the CPU (the
            plain PyTorch path) must agree.
5. kernels  on the fused run's page schedule, each kernel against its plain
            version on the card (exact part rtol 1e-5, atol 1e-5*d; ADC
            rtol 1e-4, atol 1e-3), with its device time (`ms`: a CUDA graph
            of back-to-back bare launches on prebuilt buffers, replayed),
            the launcher's time as the wrapper calls it (`launcher_ms`, with
            its prep ops and host dispatch), the plain version's time, its
            bound from bytes or operations at the H100's spec peaks, and a
            PyTorch library call's time where one computes the function.

The last lines are the kernels' JSON, the card's name and power limit, and
{"ok": true, "device": {...}}. It needs one card, and exits non-zero without
one, or when run without the rest of the repository.
"""
from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NQ = 1000
# Vamana inserts this many nodes per batch by default, not the builder's
# 1024: at n = 1M the build is bound by the host launching one batch's ops
# per hop, so 8x larger batches make it several times shorter (see PERF.md)
VAMANA_BATCH = 8192
# run -> (index it searches, preset, overrides); octopusann adds only a
# search-time option to starling's index
RUNS = {"baseline": ("baseline", "baseline", {}),
        "diskann": ("diskann", "diskann", {}),
        "starling": ("starling", "starling", {}),
        "pipeann": ("pipeann", "pipeann", {}),
        "octopusann": ("starling", "octopusann", {}),
        "pipeline-fused": ("baseline", "pipeline", {"pipeline": "fused"})}
KERNELS = {
    "page_scan": ("src/repro_torch/kernels/csrc/page_scan.cu",
                  "src/repro/kernels/page_scan.py:39"),
    "page_adc": ("src/repro_torch/kernels/csrc/page_adc.cu",
                 "src/repro/kernels/fused_search.py:132"),
    "fused_page_rank": ("src/repro_torch/kernels/csrc/fused_page_rank.cu",
                        "src/repro/kernels/fused_search.py:76"),
}


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean time of one fn() call over `reps` calls issued from the host,
    by CUDA events, after three warm-up calls: it includes the host's
    dispatch of every op fn() issues."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int, replays: int = 5) -> float:
    """Mean device time of one fn() call: `reps` calls captured in one CUDA
    graph and replayed `replays` times, by CUDA events, so that no host
    dispatch falls between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def phase_build(rt, n: int, vamana_batch: int):
    from repro_torch.core.vamana import build_vamana
    t0 = time.perf_counter()
    ds = rt.make_dataset("deep-like", n=n, nq=NQ, seed=0)
    say("build", dataset="deep-like", n=n, nq=NQ, d=ds.d,
        dataset_and_gt_s=round(time.perf_counter() - t0, 3))
    # the builder's graph defaults (R=64, L_build=125, alpha=1.2); every
    # index shares the graph
    graph, med, gst = build_vamana(ds.vectors, batch=vamana_batch)
    say("build", vamana_s=round(gst["build_s"], 3), R=gst["R"],
        L_build=gst["L"], alpha=gst["alpha"], batch=vamana_batch)
    indexes = {}
    for name in ("baseline", "diskann", "starling", "pipeann"):
        idx = rt.build_index(ds, rt.get_preset(name), graph=graph,
                             medoid_id=med)
        st = idx.build_stats
        say("build", index=name, pq_s=round(st["pq_build_s"], 3),
            layout_s=round(st["layout_s"], 3),
            shuffle_s=round(st.get("shuffle_s", 0.0), 3),
            memgraph_s=round(st.get("memgraph_build_s", 0.0), 3),
            n_p=st["n_p"], overlap_ratio=round(st["overlap_ratio"], 4))
        indexes[name] = idx
    return ds, indexes


def phase_search(rt, torch, ds, indexes):
    from repro_torch import kernels as ops
    from repro_torch.core.search_kernel import measure_step_us
    model = rt.SSDModel()
    out = {}
    for run, (index_name, preset, over) in RUNS.items():
        idx = indexes[index_name]
        cfg = rt.get_preset(preset, **over)
        fused = cfg.pipeline == "fused"
        if fused:
            ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = idx.search(ds.queries, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        extra = {}
        if fused:
            store = idx.page_store(use_cache=False)
            split = measure_step_us(store, idx.pq, ds.queries[:256],
                                    st.page_trace[:256], mode="split")
            torch.cuda.synchronize()
            launches = dict(ops.launches)
            extra = {"measured_step_us_mean":
                     round(float(st.measured_step_us.mean()), 3),
                     "split_us_per_page": round(split["us_per_page"], 4),
                     "launches": json.dumps(launches).replace(" ", "")}
            missing = [k for k, v in launches.items() if v == 0]
            if missing:
                raise RuntimeError(f"main path launched no {missing}")
            out["launches"] = launches
            out["trace"] = st.page_trace
            out["index"] = idx
        summ = st.summary(model, d=ds.d, pq_m=cfg.pq_m,
                          page_bytes=cfg.page_bytes,
                          pipeline=bool(cfg.pipeline))
        recall = rt.recall_at_k(st.ids, ds.gt, 10)
        if not (np.isfinite(st.dists).all() and st.ids.shape == (NQ, 10)):
            raise RuntimeError(f"{run}: malformed result")
        if recall < 0.7:
            raise RuntimeError(f"{run}: recall@10 {recall} below 0.7")
        say("search", preset=run, recall_at_10=round(recall, 4),
            mean_page_reads=round(float(st.page_reads.mean()), 3),
            mean_hops=round(float(st.hops.mean()), 3),
            modelled_qps=round(summ["qps"], 1),
            measured_qps_on_card=round(NQ / wall, 1),
            search_s=round(wall, 3), **extra)
    return out


def phase_parity(rt):
    """A small index searched on the card and by the plain path on the
    CPU: the contract the CPU tests hold the port to against JAX."""
    from repro_torch.convert import index_from_reference
    ds = rt.make_dataset("deep-like", n=2048, nq=64, seed=1, device="cpu")
    cpu_idx = rt.build_index(ds, rt.get_preset("baseline"), R=16,
                             L_build=32, device="cpu")
    gpu_idx = index_from_reference(cpu_idx, "cuda")
    for name in ("baseline", "pagesearch", "dynamicwidth", "pipeline"):
        cfg = rt.get_preset(name)
        a = cpu_idx.search(ds.queries, cfg)
        b = gpu_idx.search(ds.queries, cfg)
        same = np.all(a.ids == b.ids, axis=1)
        ok = (same.sum() >= 63
              and np.allclose(b.dists[same], a.dists[same], rtol=1e-6)
              and abs(b.page_reads.mean() - a.page_reads.mean())
              <= 0.03 * a.page_reads.mean()
              and abs(b.hops.mean() - a.hops.mean()) <= 0.03 * a.hops.mean())
        say("parity", preset=name, rows_identical=f"{same.sum()}/64",
            ok=ok)
        if not ok:
            raise RuntimeError(f"card and CPU disagree on {name}")


def phase_kernels(torch, search_out, d: int):
    from repro_torch import kernels as ops
    from repro_torch.core.device_model import H100_SXM
    from repro_torch.core.search_kernel import (_page_codes,
                                                _pq_device_arrays,
                                                hop_major_schedule,
                                                query_luts)
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import (_pad_ids, bucket_size,
                                         launch_fused_page_rank,
                                         launch_page_adc, launch_page_scan)
    idx = search_out["index"]
    store = idx.page_store(use_cache=False)
    sched = hop_major_schedule(search_out["trace"][:256])[:256]
    _, vecs, _, _, _ = store.kernel_arrays()
    codes = _page_codes(store, idx.pq)
    qb = torch.as_tensor(search_out["queries"][:256], device="cuda")
    lut = query_luts(_pq_device_arrays(idx.pq, "cuda")[0], qb)
    ids = torch.as_tensor(sched.astype(np.int32), device="cuda")
    padded = _pad_ids(ids, bucket_size(len(ids)))
    w, n_p, nq, m = len(sched), vecs.shape[1], qb.shape[0], codes.shape[2]
    w_u = len(np.unique(sched))
    say("kernels", schedule_pages=w, unique_pages=w_u, padded_to=len(padded),
        n_p=n_p, d=d, M=m, Q=nq)

    exact_ref, adc_ref = ref.fused_page_rank_ref(vecs, codes, ids, qb, lut)
    if lut.shape != (m, 256, nq):
        raise RuntimeError(f"query_luts gave {tuple(lut.shape)}, not the "
                           f"kernels' (M, 256, Q) = {(m, 256, nq)}")
    got = {"page_scan": (ops.page_scan(vecs, ids, qb),),
           "page_adc": (ops.page_adc(codes, ids, lut),),
           "fused_page_rank": ops.fused_page_rank(vecs, codes, ids, qb, lut)}
    torch.cuda.synchronize()
    checks = {"page_scan": [(got["page_scan"][0], exact_ref, 1e-5, 1e-5 * d)],
              "page_adc": [(got["page_adc"][0], adc_ref, 1e-4, 1e-3)],
              "fused_page_rank": [
                  (got["fused_page_rank"][0], exact_ref, 1e-5, 1e-5 * d),
                  (got["fused_page_rank"][1], adc_ref, 1e-4, 1e-3)]}

    # the work this schedule needs: each distinct page read once, every
    # output written once, f32 operations at the non-tensor-core peak
    q_bytes, ids_bytes = nq * d * 4, w * 4
    out_bytes = w * n_p * nq * 4
    scan_bytes = w_u * n_p * d * 4 + q_bytes + ids_bytes + out_bytes
    scan_ops = 2 * w_u * n_p * nq * d
    adc_bytes = w_u * n_p * m + nq * m * 256 * 4 + ids_bytes + out_bytes
    adc_ops = w_u * n_p * nq * m
    work = {"page_scan": (scan_bytes, scan_ops),
            "page_adc": (adc_bytes, adc_ops),
            "fused_page_rank": (scan_bytes + adc_bytes - ids_bytes,
                                scan_ops + adc_ops)}
    launch = {
        "page_scan": lambda: launch_page_scan(vecs, padded, qb),
        "page_adc": lambda: launch_page_adc(codes, padded, lut),
        "fused_page_rank": lambda: launch_fused_page_rank(vecs, codes,
                                                          padded, qb, lut)}
    # the bare kernel launches, on buffers made once, for a CUDA graph; the
    # replayed outputs are held to the same tolerances
    qsq = torch.sum(torch.square(qb.float()), -1)
    bufs = [torch.empty((len(padded), n_p, nq), device="cuda")
            for _ in range(2)]
    bare = {
        "page_scan": lambda: launch_page_scan(vecs, padded, qb, qsq,
                                              bufs[0]),
        "page_adc": lambda: launch_page_adc(codes, padded, lut, bufs[0]),
        "fused_page_rank": lambda: launch_fused_page_rank(
            vecs, codes, padded, qb, lut, qsq, tuple(bufs))}
    plain = {
        "page_scan": lambda: ref.page_scan_ref(vecs, ids, qb),
        "page_adc": lambda: ref.page_adc_ref(codes, ids, lut),
        "fused_page_rank": lambda: ref.fused_page_rank_ref(vecs, codes, ids,
                                                           qb, lut)}
    # yardsticks, one library call each on inputs gathered beforehand:
    # page_scan, L2 (not squared) of the page tiles to the queries;
    # page_adc, a sum of LUT rows, one bag of M rows per record.
    # fused_page_rank has two outputs, and no one call computes both.
    gathered = vecs[ids.long()].reshape(-1, d)
    bags = (codes[ids.long()].reshape(-1, m).long()
            + 256 * torch.arange(m, device="cuda"))
    lut_rows = lut.reshape(m * 256, nq)
    library = {
        "page_scan": lambda: torch.cdist(gathered, qb),
        "page_adc": lambda: torch.nn.functional.embedding_bag(
            bags, lut_rows, mode="sum")}
    torch.testing.assert_close(library["page_adc"]().reshape(w, n_p, nq),
                               adc_ref, rtol=1e-4, atol=1e-3)
    rows = []
    for name, (source, replaces) in KERNELS.items():
        err = 0.0
        for g, want, rtol, atol in checks[name]:
            if g.shape != want.shape or not torch.isfinite(g).all():
                raise RuntimeError(f"{name}: malformed output {g.shape}")
            torch.testing.assert_close(g, want, rtol=rtol, atol=atol)
            err = max(err, float((g - want).abs().max()))
        nbytes, nops = work[name]
        bound_s, bound_by = H100_SXM.bound_s(nbytes, nops)
        ms = graph_ms(torch, bare[name], 200)
        for buf, (_, want, rtol, atol) in zip(bufs, checks[name]):
            torch.testing.assert_close(buf[:w], want, rtol=rtol, atol=atol)
        launcher_ms = cuda_ms(torch, launch[name], 200)
        plain_ms = cuda_ms(torch, plain[name], 50)
        lib_ms = (cuda_ms(torch, library[name], 200) if name in library
                  else None)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": search_out["launches"][name],
               "max_abs_err": err, "ms": ms, "launcher_ms": launcher_ms,
               "plain_ms": plain_ms,
               "bound_ms": bound_s * 1e3, "bound_by": bound_by,
               "library_ms": lib_ms}
        say("kernels", **{k: v for k, v in row.items()
                          if k not in ("source", "replaces")})
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="base vectors (deep-like, d=96)")
    ap.add_argument("--vamana-batch", type=int, default=VAMANA_BATCH,
                    help="nodes Vamana inserts per batch (the builder's "
                         "own default is 1024)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch as rt
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repository's src/repro_torch is missing "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    say("device", nvidia_smi=json.dumps(smi), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32)
    build_s = _build.build_all()
    say("device", kernel_build_s=round(build_s, 3))
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("ptxas", source=name, report=json.dumps(line.strip()))

    t_all = time.perf_counter()
    ds, indexes = phase_build(rt, args.n, args.vamana_batch)
    search_out = phase_search(rt, torch, ds, indexes)
    search_out["queries"] = ds.queries
    phase_parity(rt)
    rows = phase_kernels(torch, search_out, ds.d)
    say("done", phases_s=round(time.perf_counter() - t_all, 3),
        peak_device_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
        peak_host_gib=round(resource.getrusage(resource.RUSAGE_SELF)
                            .ru_maxrss / 2**20, 3))
    print("kernels: " + ", ".join(f"{r['name']} ok" for r in rows))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
