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
            bound from bytes or operations at the H100's spec peaks, each
            block's dynamic shared memory, and one PyTorch library call
            that computes the same function (page_scan: a full-f32 addmm of
            the gathered tiles, TF32 off; page_adc: embedding_bag), held to
            the kernel's tolerances and timed both ways: `library_ms` by
            graph replay, `library_launcher_ms` from the host.
6. pq_adc   the PQ filter scan of the paper's memory layout (§4.1.1): the
            bucketed pq_adc over the baseline index's N PQ codes against
            the LUTs of the first 8 queries, over 65,536 random codes
            (the microbench shape), and the raw kernel at n = 1000 with
            keep_pad. The launch count is set to 0 just before and read
            just after. Each result is held against pq_adc_ref on the card
            (rtol 1e-5), the first query's against the host PQ.adc
            (rtol 1e-4), and the pad tail must be +inf. It prints the
            kernel's device time, the launcher's, the plain version's, its
            bound, and `embedding_bag`'s time as the library yardstick
            (graph replay and launcher, as in [kernels]).
7. io       the I/O stack on the baseline index: the 1000 queries through
            page_store(batched=True) with the per-query page bitmaps and
            traces, their cross-query coalescing, and replays of the
            traces through LRU, FIFO and 2Q caches of 2% of the index's
            page bytes, LRU with prefetch 2, and 4 shards in each
            placement, asserting the conservation identities of each.

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
    "pq_adc": ("src/repro_torch/kernels/csrc/pq_adc.cu",
               "src/repro/kernels/pq_adc.py:49"),
}
# the kernels of the fused search's path; pq_adc has its own ([pq_adc])
SEARCH_KERNELS = ("page_scan", "page_adc", "fused_page_rank")
# the PQ filter's microbench shape (benchmarks/kernels.py): one query's LUT
# against this many random codes
PQ_MICRO_N = 65_536
# [io]: the dynamic caches hold this share of the index's page bytes
IO_CACHE_FRAC = 0.02


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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
            launches = {k: ops.launches[k] for k in SEARCH_KERNELS}
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
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.ops import (_pad_ids, bucket_size,
                                         launch_fused_page_rank,
                                         launch_page_adc, launch_page_scan)
    from repro_torch.kernels.timing import cuda_ms, graph_ms
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
    # each page kernel's dynamic shared memory per block at these shapes
    say("kernels", smem_bytes=json.dumps({
        "page_scan": _build.library("page_scan").page_scan_smem(d),
        "page_adc": _build.library("page_adc").page_adc_smem(m),
        "fused_page_rank": _build.library("fused_page_rank")
        .fused_page_rank_smem(d, m)}).replace(" ", ""))

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
    bufs = [torch.empty((len(padded), n_p, nq), device="cuda")
            for _ in range(2)]
    bare = {
        "page_scan": lambda: launch_page_scan(vecs, padded, qb, bufs[0]),
        "page_adc": lambda: launch_page_adc(codes, padded, lut, bufs[0]),
        "fused_page_rank": lambda: launch_fused_page_rank(
            vecs, codes, padded, qb, lut, tuple(bufs))}
    plain = {
        "page_scan": lambda: ref.page_scan_ref(vecs, ids, qb),
        "page_adc": lambda: ref.page_adc_ref(codes, ids, lut),
        "fused_page_rank": lambda: ref.fused_page_rank_ref(vecs, codes, ids,
                                                           qb, lut)}
    # yardsticks, one library call each computing the kernel's function on
    # inputs made beforehand: page_scan, the full-f32 product of the
    # gathered tiles with q^T, times -2, onto |x|^2 + |q|^2 (addmm);
    # page_adc, a sum of LUT rows, one bag of M rows per record.
    # fused_page_rank has two outputs, and no one call computes both.
    torch.backends.cuda.matmul.allow_tf32 = False
    gathered = vecs[ids.long()].reshape(-1, d).float()
    norms = (torch.sum(gathered * gathered, -1)[:, None]
             + torch.sum(qb.float() * qb.float(), -1)[None, :])
    q_t = qb.float().t()
    bags = (codes[ids.long()].reshape(-1, m).long()
            + 256 * torch.arange(m, device="cuda"))
    lut_rows = lut.reshape(m * 256, nq)
    library = {
        "page_scan": lambda: torch.addmm(norms, gathered, q_t, alpha=-2.0),
        "page_adc": lambda: torch.nn.functional.embedding_bag(
            bags, lut_rows, mode="sum")}
    torch.testing.assert_close(library["page_scan"]().reshape(w, n_p, nq),
                               exact_ref, rtol=1e-5, atol=1e-5 * d)
    torch.testing.assert_close(library["page_adc"]().reshape(w, n_p, nq),
                               adc_ref, rtol=1e-4, atol=1e-3)
    rows = []
    for name in SEARCH_KERNELS:
        source, replaces = KERNELS[name]
        err = 0.0
        for g, want, rtol, atol in checks[name]:
            if g.shape != want.shape or not torch.isfinite(g).all():
                raise RuntimeError(f"{name}: malformed output {g.shape}")
            torch.testing.assert_close(g, want, rtol=rtol, atol=atol)
            err = max(err, float((g - want).abs().max()))
        nbytes, nops = work[name]
        bound_s, bound_by = H100_SXM.bound_s(nbytes, nops)
        ms = graph_ms(bare[name], 200)
        for buf, (_, want, rtol, atol) in zip(bufs, checks[name]):
            torch.testing.assert_close(buf[:w], want, rtol=rtol, atol=atol)
        launcher_ms = cuda_ms(launch[name], 200)
        plain_ms = cuda_ms(plain[name], 50)
        lib = library.get(name)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": search_out["launches"][name],
               "max_abs_err": err, "ms": ms, "launcher_ms": launcher_ms,
               "plain_ms": plain_ms,
               "bound_ms": bound_s * 1e3, "bound_by": bound_by,
               "library_ms": graph_ms(lib, 200) if lib else None,
               "library_launcher_ms": (cuda_ms(lib, 200) if lib
                                       else None)}
        say("kernels", **{k: v for k, v in row.items()
                          if k not in ("source", "replaces")})
        rows.append(row)
    return rows


def phase_pq_adc(rt, torch, ds, indexes):
    """The PQ filter scan over the baseline index's real codes."""
    from repro_torch import kernels as ops
    from repro_torch.core.device_model import H100_SXM
    from repro_torch.core.search_kernel import _pq_device_arrays
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import bucket_size
    from repro_torch.kernels.pq_adc import launch_pq_adc, pq_adc
    from repro_torch.kernels.timing import cuda_ms, graph_ms
    pq = indexes["baseline"].pq
    codes = _pq_device_arrays(pq, "cuda")[1]          # the search's copy
    n, m = codes.shape
    luts = [torch.as_tensor(pq.lut(q), device="cuda")
            for q in ds.queries[:8]]
    rng = np.random.default_rng(0)
    micro_codes = torch.as_tensor(rng.integers(0, 256, (PQ_MICRO_N, m))
                                  .astype(np.uint8), device="cuda")
    micro_lut = torch.as_tensor((rng.normal(size=(m, 256)) ** 2)
                                .astype(np.float32), device="cuda")
    say("pq_adc", N=n, M=m, luts=len(luts), micro_N=PQ_MICRO_N)

    # the main path, counted: 8 queries over the index, the microbench
    # shape, and a length inside a bucket with its padded tail kept
    ops.reset_launches()
    torch.cuda.synchronize()
    got = [ops.pq_adc(codes, lut) for lut in luts]
    got_micro = ops.pq_adc(micro_codes, micro_lut)
    padded = pq_adc(codes[:1000], luts[0], keep_pad=True)
    torch.cuda.synchronize()
    launches = ops.launches["pq_adc"]
    if launches == 0:
        raise RuntimeError("the [pq_adc] path launched no pq_adc kernel")

    err = 0.0
    for g, c, lut in [(g, codes, lut) for g, lut in zip(got, luts)] + [
            (got_micro, micro_codes, micro_lut)]:
        want = ref.pq_adc_ref(c, lut)
        if g.shape != want.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"pq_adc: malformed output {tuple(g.shape)}")
        torch.testing.assert_close(g, want, rtol=1e-5, atol=0)
        err = max(err, float((g - want).abs().max()))
    host = pq.adc(ds.queries[0], np.arange(n))
    np.testing.assert_allclose(got[0].cpu().numpy(), host, rtol=1e-4)
    tail = padded[1000:]
    if padded.shape[0] != 1024 or not (torch.isinf(tail).all()
                                       and (tail > 0).all()):
        raise RuntimeError(f"pq_adc: the pad tail of {tuple(padded.shape)} "
                           f"is not all +inf")
    torch.testing.assert_close(padded[:1000], got[0][:1000], rtol=0, atol=0)
    say("pq_adc", launches=launches, max_abs_err=err,
        host_adc_rtol=1e-4, pad_rows=int(tail.numel()), pad_all_inf=True)

    timed = {}
    for label, c, lut in (("index", codes, luts[0]),
                          ("micro", micro_codes, micro_lut)):
        rows = c.shape[0]
        n_out = bucket_size(rows, floor=min(512, bucket_size(rows)))
        out = torch.empty(n_out, device="cuda")
        ms = graph_ms(lambda: launch_pq_adc(c, lut, n_out, rows, out),
                      200)
        torch.testing.assert_close(out[:rows], ref.pq_adc_ref(c, lut),
                                   rtol=1e-5, atol=0)
        bags = c.long() + 256 * torch.arange(m, device="cuda")
        lut_rows = lut.reshape(m * 256, 1)
        library = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
            bags, lut_rows, mode="sum")
        torch.testing.assert_close(library()[:, 0], ref.pq_adc_ref(c, lut),
                                   rtol=1e-5, atol=1e-5)
        # each code read once, the LUT once, each of the N distances
        # written once; N*M f32 additions
        bound_s, bound_by = H100_SXM.bound_s(rows * m + m * 256 * 4
                                             + rows * 4, rows * m)
        timed[label] = {
            "ms": ms,
            "launcher_ms": cuda_ms(lambda: ops.pq_adc(c, lut), 200),
            "plain_ms": cuda_ms(lambda: ref.pq_adc_ref(c, lut), 50),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": graph_ms(library, 200),
            "library_launcher_ms": cuda_ms(library, 200)}
        say("pq_adc", shape=label, N=rows, n_out=n_out,
            bound_us=round(bound_s * 1e6, 3),
            **{k: v for k, v in timed[label].items() if k != "bound_ms"})
    source, replaces = KERNELS["pq_adc"]
    return {"name": "pq_adc", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            **timed["index"]}


def phase_io(rt, torch, ds, indexes):
    """The I/O stack on a real search of the baseline index."""
    from repro_torch.core.search_kernel import search_batched
    from repro_torch.io import build_store, profile_from_trace
    t0 = time.perf_counter()
    idx = indexes["baseline"]
    cfg = rt.get_preset("baseline")
    store = idx.page_store(batched=True)
    bottom = store.inner
    before = bottom.counters.pages_fetched
    st = search_batched(store, idx.pq, cfg, ds.queries, medoid=idx.medoid,
                        collect_visited=True, collect_trace=True)
    torch.cuda.synchronize()
    reads = int(st.page_reads.sum())
    requested = issued = 0
    for s in range(0, NQ, 256):
        acct = store.coalesce(st.visited_pages[s:s + 256])
        requested += acct["requested"]
        issued += acct["issued"]
    checks = [requested == int(st.visited_pages.sum()), issued <= requested,
              store.savings() == requested - issued,
              bottom.counters.pages_fetched - before == reads + issued]
    say("io", path="coalesce", page_reads=reads, requested=requested,
        issued=issued, savings=store.savings(), ok=all(checks))
    if not all(checks):
        raise RuntimeError(f"coalesce broke conservation: {checks}")

    lay = idx.layout
    cache_bytes = int(IO_CACHE_FRAC * lay.num_pages * lay.page_bytes)
    profile = profile_from_trace(st.page_trace, lay.num_pages)
    stacks = {"lru": dict(cache_policy="lru"),
              "fifo": dict(cache_policy="fifo"),
              "2q": dict(cache_policy="2q"),
              "lru-prefetch2": dict(cache_policy="lru", prefetch=2)}
    for placement in ("round-robin", "contiguous", "replicated"):
        stacks[f"shards4-{placement}"] = dict(
            cache_policy="lru", shards=4, placement=placement,
            page_profile=profile if placement == "replicated" else None)
    for name, kw in stacks.items():
        top = build_store(lay, batched=True, cache_bytes=cache_bytes,
                          device="cuda", **kw)
        acc = {"requested": 0, "issued": 0, "hits": 0, "prefetch_issued": 0}
        for s in range(0, NQ, 256):
            acct = top.replay_batch(st.page_trace[s:s + 256])
            for k in acc:
                acc[k] += acct[k]
        base = top
        while hasattr(base, "inner"):
            base = base.inner
        demand = acc["issued"] - acc["prefetch_issued"]
        checks = [acc["requested"] == reads, demand <= acc["requested"],
                  acc["hits"] + demand == acc["requested"],
                  base.counters.pages_fetched == acc["issued"],
                  top.counters.pages_fetched == acc["issued"]]
        shards = ([[r["pages_fetched"], r["cache_hits"]]
                   for r in top.shard_rows()]
                  if hasattr(top, "shard_rows") else None)
        if shards is not None:
            checks.append(sum(r[0] for r in shards) == acc["issued"])
        say("io", stack=name, cache_pages=cache_bytes // lay.page_bytes,
            hit_rate=round(top.hit_rate(), 4), requested=acc["requested"],
            issued=acc["issued"], prefetch_issued=acc["prefetch_issued"],
            shard_fetched_hits=json.dumps(shards).replace(" ", ""),
            ok=all(checks))
        if not all(checks):
            raise RuntimeError(f"{name}: replay broke conservation: {checks}")
    say("io", phase_s=round(time.perf_counter() - t0, 3))


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
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                say("ptxas", source=name, report=json.dumps(line.strip()))

    t_all = time.perf_counter()
    ds, indexes = phase_build(rt, args.n, args.vamana_batch)
    search_out = phase_search(rt, torch, ds, indexes)
    search_out["queries"] = ds.queries
    phase_parity(rt)
    rows = phase_kernels(torch, search_out, ds.d)
    t0 = time.perf_counter()
    rows.append(phase_pq_adc(rt, torch, ds, indexes))
    say("pq_adc", phase_s=round(time.perf_counter() - t0, 3))
    phase_io(rt, torch, ds, indexes)
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
