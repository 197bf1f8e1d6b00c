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
            before each search and read just after it (for the fused run,
            after the split measurement of its page schedule,
            measure_step_us(mode="split")): every search must have launched
            the pool merge's kernel (dedup_merge_topL), the fused one the
            page kernels too.
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
            graph replay, `library_launcher_ms` from the host. Then the
            search pool's merge (dedup_merge_topL, csrc/merge_topl.cu) at
            the benchmark's hop shapes, deep's (B, N, L, K, F) =
            (256, 2368, 96, 2, 2) and sift's (2, 616, 96, 2, 2), on
            search-like rows: byte for byte against its plain version on
            the card, `ms` by graph replay of the wrapper's calls (their
            outputs drawn from the graph's pool at capture), the
            launcher's time, the plain version's time both ways, and its
            bound from the bytes a row reads and writes, (N + L)(8 + 4K +
            F). There is no library call that computes it.
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
8. serve    AnnServer (src/repro_torch/serving) over the baseline index:
            (a) the closed loop, default ServerConfig (max_batch 16), 32
                workers x 32 rounds of ds.queries; its ids must equal
                DiskIndex.search of the same queries; it prints the report
                row, recall@10 and the served queries/s on the card (host
                clock, synchronised);
            (b) the open loop under overload control: an LRU cache of
                IO_CACHE_FRAC of the page bytes, admission "degrade",
                Poisson arrivals at twice (a)'s modelled QPS for about 1000
                arrivals, with the sanitizer armed: offered == admitted +
                shed, and queue + service + interference == latency for
                every query;
            (c) streaming, durable and traced: a MutableIndex over the
                baseline index with a MutationJournal (group commit 8),
                served with pipeline="fused" under MutationMix(insert 0.1,
                delete 0.05, threshold compaction) from a pool of 10,000
                fresh deep-like vectors, with a Tracer. The fused_page_rank
                launch count is set to 0 just before the window and read
                just after (it must be above 0); the Chrome trace must
                validate. The window's first served batch, the first after
                each flush or compaction and its last are run again through
                fused_page_rank on the tiles they read (Q = 16, max_batch)
                and held against the plain version on the host layout's
                copy of the same pages, which a stale code or vector tile
                fails. Each served search is timed, those that re-upload
                the layout after a rewrite apart. recover(base, journal)
                must equal the live index in tombstones, free list, dirty
                set, overlap_ratio and the ids and dists of 64 queries. It
                prints the seconds of the MutableIndex's construction, of
                each flush and compaction, and of the recovery, and times
                the 1M graph's reverse adjacency built edge by edge as the
                reference does beside the port's, whose sets of 10,000
                sampled vertices must equal it.
9. fleet    FleetServer (src/repro_torch/serving/fleet.py) over the baseline
            index with pipeline="fused": 2 replica groups of 4 shards in the
            replicated placement (hot set ranked by profile_from_trace of
            the fused [search] run's traces), LRU at IO_CACHE_FRAC of the
            page bytes, least-work routing, MigrationConfig() and
            AutoscaleConfig(min_groups=1, max_groups=4); Poisson arrivals at
            twice [serve] (a)'s modelled QPS for about 1000 arrivals, with
            the sanitizer armed and a Tracer. The fused_page_rank count is
            set to 0 just before the window and read just after (it must be
            above 0). The served ids must equal DiskIndex.search of the same
            queries, the attribution residual must be at most 1e-3 us and the
            Chrome trace must validate; the first batch served on each group
            is run again through fused_page_rank and held to the plain
            version on the host layout (max abs error at most 1e-4). It
            prints the report row, the migration volume, the scale events,
            the served queries/s on the card, the peak device memory, and for
            each group the seconds of its store build and the device bytes
            it allocated.
10. lm      the LM decode server (src/repro_torch/serving/engine.py):
            (a) repro_torch.launch.serve.main(["--rag"]) as a user runs it
                (the tinyllama smoke config; an OctopusANN index of 2048
                deep-like vectors on the card);
            (b) TinyLlama-1.1B at its full published width
                (get_config("tinyllama-1.1b"): 22 layers, d_model 2048,
                32/4 heads, d_ff 5632, vocab 32000), bf16 parameters drawn
                from torch.Generator(device="cuda") seeded 0, LMServer(
                max_len=256) on 8 RAG prompts (8 ids retrieved for each of
                the first 8 queries by the baseline [search] run, modulo the
                vocabulary, then 8 question tokens), 32 new tokens each: the
                prefill ms, the decode ms per token, tokens/s, the device's
                busy share of the decode steps (torch.profiler) and the peak
                device memory;
            (c) the same model in float32 (TF32 off): decode after a
                half-length prefill against the full prefill's logits (the
                check of tests/test_arch_smoke.py:57) at B = 2, S = 32: within
                that test's tolerance (rtol = atol = 2e-2), and a max abs
                logit error of at most 2e-2;
            (d) the same check for the smoke config of each of the 10
                ARCH_IDS.
11. train   training on the card (src/repro_torch/launch/train.py), with
            [lm]'s models freed first:
            (a) launch.train.main(TRAIN_ARGS) as a user runs it:
                TinyLlama-1.1B at full width in float32 (TF32 off), 20
                steps of 8 x 128 tokens from the launcher's seeded
                parameters and pipeline: ms per step (median of steps
                2-19, each ending in a read of the loss) against the bound
                6 x (parameters outside the embedding) x tokens at the
                H100's f32 peak, tokens/s, the device's busy share of 3
                more steps (torch.profiler), the peak device memory, and
                the first and last loss; the last must be below the first;
            (b) the die-and-resume drill, each half a process of its own
                (python -m repro_torch.launch.train): checkpoints every 10
                steps into a temporary directory under build/, a run that
                dies at step 15 (exit 42), and a --resume run that restarts
                at step 10 and must end within rtol 1e-4 of (a)'s last
                loss; it prints the free disk, each save's and restore's
                seconds, the checkpoint's size, and whether the resumed
                losses are (a)'s bit for bit; the directory is deleted;
            (c) launch.train.first_step of the tinyllama smoke config (the
                launcher's first step from seeded parameters and batch) on
                the card and on the CPU, plain, accum=2 and compress=True:
                the parameters within rtol 1e-4, atol 1e-5; with
                compression an element whose int8 code rounds the other
                way on the card may move by the lr more, and at most 1e-3
                of the codes may (launch.train.step_difference).

12. mesh    the mesh code (src/repro_torch/parallel, launch/mesh.py) on the
            card, with [train]'s models freed first; f32, TF32 off:
            (a) a one-rank NCCL mesh (1, 1) (launch.mesh.make_local_mesh)
                and TinyLlama-1.1B at its full published width, parameters
                from torch.Generator(device="cuda") seeded 0: loss_fn and
                its gradients on 2 x 128 tokens with parallel=ctx against
                parallel=None (the loss bit for bit, each gradient leaf
                within rtol 1e-5 plus 2**-20 of its largest magnitude: the
                embedding's backward adds with atomics), and LMServer
                (parallel=ctx) greedy tokens for 8 prompts of 16 tokens, 16
                new tokens each, equal to parallel=None's;
            (b) expert parallelism for one qwen2-moe-a2.7b MoE layer at its
                published width (60 experts padded to 64, top-4, d_model
                2048, d_ff_expert 1408, 4 shared experts, capacity factor
                1.25: 2.2 GB of f32 expert weights), B = 4, S = 256, in 2
                processes (model = 2) and in 4 (data = 2, model = 2) on the
                one card over gloo (launch.mesh.run_in_processes): each
                rank's output and aux equal the local path on its data
                shard within rtol 1e-5, atol 1e-5, and again with
                gather_quant=True against the local path on fp8-rounded
                expert weights where the layer gathers them; each call is
                timed twice, the first with the groups' first contact;
            (c) gpipe in the 4 processes: 4 stages of tanh(h @ W_s) at
                D = 2048, B = 64, n_micro = 8, equal to the sequential
                stack within 1e-5;
            (d) compressed_psum in the 4 processes of a 2048 x 5632 f32
                gradient per rank (torch.Generator seeded by the rank),
                equal bit for bit to one process's sum of the four int8
                code tensors times the max scale;
            (e) checkpoint.restore(shardings=) of a checkpoint of
                TinyLlama's embedding and first block, placed by
                param_pspecs under the "tp" profile (P("model", None) /
                P(None, "model")), onto (a)'s mesh and, in the 2
                processes, onto a (data 1, model 2) mesh: each rank's block
                equals its slice of the saved array;
            (f) LMServer on a mesh of real ranks: (a)'s TinyLlama-1.1B
                (f32, the same seeded parameters, drawn in each rank and
                placed by param_pspecs, each rank keeping its block) serves
                (a)'s 8 prompts of 16 tokens, 16 new tokens each, in 2
                processes on (data 1, model 2) under "tp" and in 4 on
                (data 2, model 2) under "2d" with seq_shard, all sharing
                the card over gloo. On every rank the greedy tokens must
                equal (a)'s one-device server's, the prefill logits
                (prefill_step on the placed batch and cache) (a)'s within
                rtol 1e-4, atol 1e-5, every parameter block, logit and
                cache tensor must be on the card, and every collective's
                transport "gloo-host". It prints the prefill ms, the decode
                ms per token (generate's seconds less the prefill's, over
                the new tokens), the seconds of the host copies, each
                rank's parameter and device bytes, and the smallest top-2
                logit margin of the greedy picks (a one-device forward
                over the prompts and (a)'s tokens).
            It prints the seconds of each part and the transport each
            collective used ("nccl", or "gloo-host": CUDA tensors copied
            through host memory under gloo).
13. dryrun  the dry run (src/repro_torch/launch/dryrun.py) on fake ranks:
            (a) the launcher's `main`, as `python -m
                repro_torch.launch.dryrun` runs it, once per cell in one
                subprocess, on fake "cuda" tensors of a fake process
                group of 256 ranks (16, 16) for tinyllama-1.1b x
                {train_4k, prefill_32k, decode_32k}, qwen2-moe-a2.7b
                train_4k (2d, expert-parallel) and rwkv6-3b long_500k
                (tp), and of 512 ranks (2, 16, 16) for kimi-k2-1t-a32b
                decode_32k; every record must be ok, and each prints its
                profile, per-device FLOPs, collective bytes, memory and
                seconds;
            (b) TinyLlama-1.1B at full width, as [train] takes its step
                (float32, 8 x 128 tokens, AdamW, remat "none"), in a
                subprocess: the dry run's record on a one-rank fake mesh
                against the real step on the card: its FLOPs must equal FlopCounterMode's around
                the real step and its argument bytes the real parameters',
                AdamW state's and batch's, exactly; its peak (arguments
                plus temporaries) is printed beside
                torch.cuda.max_memory_allocated() of the real step.

The last lines are the kernels' JSON, the card's name and power limit, and
{"ok": true, "device": {...}}. It needs one card, and exits non-zero without
one, or when run without the rest of the repository.
"""
from __future__ import annotations

import argparse
import json
import os
import re
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
    "dedup_merge_topL": ("src/repro_torch/kernels/csrc/merge_topl.cu",
                         "none: the reference's merge is jnp, "
                         "src/repro/core/searchutils.py:50"),
}
# the kernels of the fused search's path; pq_adc has its own ([pq_adc]);
# every search launches the pool merge's
SEARCH_KERNELS = ("page_scan", "page_adc", "fused_page_rank")
# [kernels]: the pool merge's (B, N, L, K, F) at deep's batch disk hop and
# at sift's online one
MERGE_CASES = {"deep": (256, 2368, 96, 2, 2), "sift": (2, 616, 96, 2, 2)}
# the PQ filter's microbench shape (benchmarks/kernels.py): one query's LUT
# against this many random codes
PQ_MICRO_N = 65_536
# [io]: the dynamic caches hold this share of the index's page bytes
IO_CACHE_FRAC = 0.02
# [serve]: arrivals per open-loop window, the streaming window's insert
# pool, and its compaction threshold: a dirty-page fraction of 1e-4 is
# about 17 of the 1M index's 166,667 pages (the default 0.25 would never
# fire inside one window)
SERVE_ARRIVALS = 1000
SERVE_POOL = 10_000
SERVE_COMPACT_THRESHOLD = 1e-4
# [serve]: vertices whose reverse-adjacency sets are compared at 1M
REV_SAMPLE = 10_000
# [fleet]: arrivals in the window
FLEET_ARRIVALS = 1000
# [lm]: the RAG prompts of the full-width model, and the decode check's shape
LM_PROMPTS, LM_RETRIEVED, LM_QUESTION, LM_NEW = 8, 8, 8, 32
LM_CHECK_B, LM_CHECK_S = 2, 32
LM_TOL = 2e-2
# [lm]: the same check with the decode caches in float32, where decode and
# prefill differ only in their sums' order
LM_F32_CACHE_TOL = 1e-4


# [train]: TinyLlama-1.1B trained at full width with the launcher's default
# batch and sequence; the die-and-resume drill's checkpoint interval and
# failure step; the resumed run's tolerance (the reference's,
# tests/test_training_checkpoint.py:83) and the card-against-CPU step's
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_ARGS = ["--arch", "tinyllama-1.1b", "--steps", "20", "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
TRAIN_CKPT_EVERY, TRAIN_DIE_AT = 10, 15
TRAIN_RESUME_RTOL = 1e-4
TRAIN_CPU_RTOL, TRAIN_CPU_ATOL = 1e-4, 1e-5
# ... with int8 compression, the share of codes that may round the other
# way on the card (gradients on a rounding boundary; a broken quantizer
# would flip about half)
TRAIN_MAX_FLIP_SHARE = 1e-3
# [train]: steps under the profiler for the device's busy share
TRAIN_PROFILED_STEPS = 3


# [mesh]: (a)'s tokens, prompts and new tokens; the gradients' tolerance
# and the floor under it, a share of each leaf's largest magnitude
MESH_B, MESH_S = 2, 128
MESH_PROMPTS, MESH_PROMPT_LEN, MESH_NEW = 8, 16, 16
MESH_GRAD_RTOL, MESH_GRAD_FLOOR = 1e-5, 2.0 ** -20
# (b) the MoE layer's tokens and tolerance; (c) gpipe's shape; (d) the
# gradient compressed_psum sums; the ranks' time limit
MESH_MOE_B, MESH_MOE_S, MESH_MOE_TOL = 4, 256, 1e-5
MESH_PIPE_STAGES, MESH_PIPE_D, MESH_PIPE_B, MESH_PIPE_MICRO = 4, 2048, 64, 8
MESH_PIPE_TOL = 1e-5
MESH_PSUM_SHAPE = (2048, 5632)
MESH_RANK_TIMEOUT = 300
# (f) the meshes the server runs on (processes, shape, profile), its
# serving length, and the prefill logits' tolerance
MESH_SERVE = [(2, (1, 2), "tp"), (4, (2, 2), "2d")]
MESH_SERVE_MAX_LEN = 64
MESH_LOGITS_RTOL, MESH_LOGITS_ATOL = 1e-4, 1e-5
# [dryrun] (a): (mesh, arch, shape) cells, each a call of the launcher's
# `main`, all in one process; (b): [train]'s batch and sequence
DRYRUN_CELLS = [("single", "tinyllama-1.1b", "all"),
                ("single", "qwen2-moe-a2.7b", "train_4k"),
                ("single", "rwkv6-3b", "long_500k"),
                ("multi", "kimi-k2-1t-a32b", "decode_32k")]
DRYRUN_TIMEOUT = 600
DRYRUN_B, DRYRUN_S = 8, 128


# device memory peaks of the run before each phase that resets the counter
PEAKS = []


def _reset_peak(torch) -> None:
    PEAKS.append(torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


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
    out = {"merge_launches": {}}
    for run, (index_name, preset, over) in RUNS.items():
        idx = indexes[index_name]
        cfg = rt.get_preset(preset, **over)
        fused = cfg.pipeline == "fused"
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = idx.search(ds.queries, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        merges = ops.launches["dedup_merge_topL"]
        if merges == 0:
            raise RuntimeError(f"{run}: the search launched no "
                               f"dedup_merge_topL")
        out["merge_launches"][run] = merges
        extra = {"merge_launches": merges}
        if fused:
            store = idx.page_store(use_cache=False)
            split = measure_step_us(store, idx.pq, ds.queries[:256],
                                    st.page_trace[:256], mode="split")
            torch.cuda.synchronize()
            launches = {k: ops.launches[k] for k in SEARCH_KERNELS}
            extra |= {"measured_step_us_mean":
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
                          page_bytes=idx.layout.page_bytes,
                          pipeline=bool(cfg.pipeline))
        if run == "baseline":
            out["baseline_ids"] = st.ids
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


def phase_merge(torch, merge_launches):
    """The pool merge's kernel at MERGE_CASES: byte for byte against its
    plain version on the card, timed as phase_kernels times the page
    kernels. `merge_launches`: each search's launch count ([search])."""
    from repro_torch import kernels as ops
    from repro_torch.core.device_model import H100_SXM
    from repro_torch.core.searchutils import INF, SENTINEL
    from repro_torch.kernels import ref
    from repro_torch.kernels.timing import cuda_ms, graph_ms
    source, replaces = KERNELS["dedup_merge_topL"]
    kw = {"sentinel": SENTINEL, "inf": INF}
    rows = []
    for shape, (b, n, L, k, f) in MERGE_CASES.items():
        # search-like rows: ids from 4 N values, so that some repeat, a
        # quarter SENTINEL; continuous keys, a quarter INF; random flags
        gen = torch.Generator(device="cuda").manual_seed(b * n)

        def rand(*size):
            return torch.rand(size, device="cuda", generator=gen)
        ids = torch.randint(0, 4 * n, (b, n), device="cuda", generator=gen)
        ids = torch.where(rand(b, n) < 0.25, SENTINEL, ids)
        keys = torch.where(rand(b, n, k) < 0.25, INF, rand(b, n, k) * 100)
        flags = rand(b, n, f) < 0.5
        got = ops.dedup_merge_topL(ids, keys, flags, L, **kw)
        want = ref.dedup_merge_topL_ref(ids, keys, flags, L, **kw)
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(
                    g.view(torch.uint8), w.view(torch.uint8)):
                raise RuntimeError(f"dedup_merge_topL at {shape}'s shape "
                                   f"differs from its plain version")
        nbytes = b * (n + L) * (8 + 4 * k + f)
        bound_s, bound_by = H100_SXM.bound_s(nbytes, 0)
        row = {"name": "dedup_merge_topL", "shape": shape, "route": "cuda",
               "source": source, "replaces": replaces,
               "B_N_L_K_F": [b, n, L, k, f],
               "launches": merge_launches, "max_abs_err": 0.0,
               "ms": graph_ms(lambda: ops.dedup_merge_topL(ids, keys, flags,
                                                           L, **kw), 200),
               "launcher_ms": cuda_ms(lambda: ops.dedup_merge_topL(
                   ids, keys, flags, L, **kw), 200),
               "plain_ms": cuda_ms(lambda: ref.dedup_merge_topL_ref(
                   ids, keys, flags, L, **kw), 50),
               "plain_graph_ms": graph_ms(lambda: ref.dedup_merge_topL_ref(
                   ids, keys, flags, L, **kw), 20),
               "bound_ms": bound_s * 1e3, "bound_by": bound_by,
               "library_ms": None, "library_launcher_ms": None}
        say("kernels", **{k_: json.dumps(v).replace(" ", "")
                          if isinstance(v, (dict, list)) else v
                          for k_, v in row.items()
                          if k_ not in ("source", "replaces")})
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


def _row(rep) -> str:
    return json.dumps(rep.row(), separators=(",", ":"))


def _plain_reverse_adjacency(graph):
    """The reference's reverse adjacency v -> {u : u->v}, built edge by
    edge (src/repro/mutation/mutable_index.py:177-181)."""
    rev = [set() for _ in range(graph.shape[0])]
    src, col = np.nonzero(graph >= 0)
    for u, v in zip(src.tolist(), graph[src, col].tolist()):
        rev[v].add(int(u))
    return rev


def _served_batch(store, pq, queries, page_trace):
    """What one served batch's fused_page_rank launch read: the store's
    device vector and code tiles (on the card, copies of the host arrays
    that a rewrite replaces and never writes, so holding them keeps what
    this batch read), its schedule and queries, and the same pages'
    vectors and codes copied from the host layout and PQ codes at this
    moment, the plain version's inputs."""
    from repro_torch.core.search_kernel import (MEASURE_PAGES_CAP,
                                                hop_major_schedule)
    sched = hop_major_schedule(page_trace)[:MEASURE_PAGES_CAP]
    if len(sched) == 0:                # measure_step_us launched nothing
        return None
    lay = store.layout
    vids = lay.page_vids[sched]
    codes = pq.codes[np.clip(vids, 0, pq.codes.shape[0] - 1)]
    codes[vids < 0] = 0
    return {"vecs": store.kernel_arrays()[1],
            "codes": store.__dict__["_device_page_codes"],
            "sched": sched, "queries": np.array(queries, np.float32),
            "plain_vecs": lay.page_vecs[sched].copy(), "plain_codes": codes}


def _check_served_batch(torch, pq, batch) -> float:
    """fused_page_rank on one served batch's own device tiles, held
    against the plain version on the host layout's copy of the same pages,
    at the [kernels] tolerances; returns the larger max abs error."""
    from repro_torch import kernels as ops
    from repro_torch.core.search_kernel import _pq_device_arrays, query_luts
    from repro_torch.kernels import ref
    dev = batch["vecs"].device
    d = batch["vecs"].shape[2]
    qb = torch.as_tensor(batch["queries"], device=dev)
    lut = query_luts(_pq_device_arrays(pq, dev)[0], qb)
    ids = torch.as_tensor(batch["sched"].astype(np.int32), device=dev)
    got = ops.fused_page_rank(batch["vecs"], batch["codes"], ids, qb, lut)
    want = ref.fused_page_rank_ref(
        torch.as_tensor(batch["plain_vecs"], device=dev),
        torch.as_tensor(batch["plain_codes"], device=dev),
        torch.arange(len(batch["sched"]), dtype=torch.int32, device=dev),
        qb, lut)
    err = 0.0
    for g, w, rtol, atol in zip(got, want, (1e-5, 1e-4), (1e-5 * d, 1e-3)):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"served fused_page_rank: malformed output "
                               f"{tuple(g.shape)}")
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
        err = max(err, float((g - w).abs().max()))
    return err


def phase_serve(rt, torch, ds, indexes):
    """AnnServer on the card: closed loop, overloaded open loop, and a
    streaming, journaled, traced window with a recovery."""
    from repro_torch import kernels as ops
    from repro_torch import sanitize
    from repro_torch.core import search_kernel
    from repro_torch.mutation import (JournalConfig, MutableIndex,
                                      MutationJournal, MutationMix, recover)
    from repro_torch.mutation.mutable_index import _ReverseAdjacency
    from repro_torch.obs import (CONSERVATION_TOL_US, Tracer,
                                 validate_chrome_trace)
    from repro_torch.serving import (AdmissionConfig, AnnServer,
                                     ServerConfig, ann_server)
    t_phase = time.perf_counter()
    idx = indexes["baseline"]
    cfg = rt.get_preset("baseline")
    model = rt.SSDModel()

    # (a) closed loop
    srv = AnnServer(idx, cfg, model=model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = srv.serve_closed_loop(ds.queries, workers=32, rounds=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the facade on the same queries in the server's batch shape
    want = idx.search(ds.queries[rep.query_indices], cfg,
                      batch=srv.server_cfg.max_batch)
    same = int(np.all(rep.stats.ids == want.ids, axis=1).sum())
    recall = rt.recall_at_k(rep.stats.ids, ds.gt[rep.query_indices], 10)
    say("serve", part="closed", queries=rep.queries,
        ids_equal_facade=f"{same}/{rep.queries}",
        recall_at_10=round(recall, 4),
        served_qps_on_card=round(rep.queries / wall, 1),
        serve_s=round(wall, 3), modelled_row=_row(rep))
    if same != rep.queries or not np.isfinite(rep.stats.dists).all():
        raise RuntimeError("closed loop: the server's results are not the "
                           "facade's")
    if recall < 0.7:
        raise RuntimeError(f"closed loop: recall@10 {recall} below 0.7")

    # (b) open loop under overload control
    lay = idx.layout
    cache_bytes = int(IO_CACHE_FRAC * lay.num_pages * lay.page_bytes)
    rate = 2.0 * rep.qps
    srv = AnnServer(idx, cfg, model=model, server_cfg=ServerConfig(
        cache_policy="lru", cache_bytes=cache_bytes,
        admission=AdmissionConfig(policy="degrade")))
    prev = sanitize.set_enabled(True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep_o = srv.serve_open_loop(ds.queries, rate_qps=rate,
                                    duration_us=SERVE_ARRIVALS / rate * 1e6,
                                    seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sanitize.set_enabled(prev)
    at = rep_o.attribution
    resid = float(np.abs(at["queue_us"] + at["service_us"]
                         + at["interference_us"] - at["latency_us"]).max())
    say("serve", part="open-degrade", rate_qps=round(rate, 1),
        offered=rep_o.offered, admitted=rep_o.admitted, shed=rep_o.shed,
        degraded=rep_o.degraded, attribution_max_residual_us=resid,
        served_qps_on_card=round(rep_o.completed / wall, 1),
        serve_s=round(wall, 3), modelled_row=_row(rep_o))
    if rep_o.offered != rep_o.admitted + rep_o.shed or \
            rep_o.completed != rep_o.admitted:
        raise RuntimeError("open loop: admission conservation broken")
    if resid > CONSERVATION_TOL_US or float(min(
            at["queue_us"].min(), at["interference_us"].min())) < 0:
        raise RuntimeError("open loop: latency attribution broken")

    # (c) streaming, durable and traced
    times = {"flush": [], "compact": []}

    class TimedMutableIndex(MutableIndex):
        def flush(self):
            t0 = time.perf_counter()
            out = super().flush()
            torch.cuda.synchronize()
            times["flush"].append(round(time.perf_counter() - t0, 3))
            return out

        def compact(self, max_pages=None):
            t0 = time.perf_counter()
            out = super().compact(max_pages)
            torch.cuda.synchronize()
            times["compact"].append(round(time.perf_counter() - t0, 3))
            return out

    pool = rt.make_dataset("deep-like", n=SERVE_POOL, nq=1, seed=1).vectors
    journal = MutationJournal(JournalConfig(group_commit=8))
    t0 = time.perf_counter()
    live = TimedMutableIndex(idx, journal=journal)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fused = rt.get_preset("pipeline", pipeline="fused")
    srv = AnnServer(live, fused, model=model)
    mix = MutationMix(insert_frac=0.1, delete_frac=0.05,
                      compaction="threshold",
                      threshold=SERVE_COMPACT_THRESHOLD)
    tracer = Tracer()
    rate = rep.qps
    # Each served search is timed (synchronised), split by whether it
    # re-uploads the layout the last flush or compaction dropped; the
    # fused_page_rank inputs of the window's first batch, of the first
    # batch after each rewrite and of its last batch are kept for a check
    # against the plain version after the window.
    search_s = {"rewrite": [], "other": []}
    served = {"rewrites": [], "last": None}

    def timed_search(store, *a, **kw):
        bottom = store
        while hasattr(bottom, "inner"):
            bottom = bottom.inner
        fresh = bottom._kernel_cache is None
        t0 = time.perf_counter()
        out = real_search(store, *a, **kw)
        torch.cuda.synchronize()
        search_s["rewrite" if fresh else "other"].append(
            time.perf_counter() - t0)
        if fresh:                      # measure_and_keep ran inside
            served["rewrites"].append(served["last"])
        return out

    def measure_and_keep(store, pq, queries, page_trace, **kw):
        out = real_measure(store, pq, queries, page_trace, **kw)
        served["last"] = _served_batch(store, pq, queries, page_trace)
        return out

    real_search = ann_server.search_batched
    real_measure = search_kernel.measure_step_us
    ann_server.search_batched = timed_search
    search_kernel.measure_step_us = measure_and_keep
    prev = sanitize.set_enabled(True)
    try:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep_m = srv.serve_open_loop(ds.queries, rate_qps=rate,
                                    duration_us=SERVE_ARRIVALS / rate * 1e6,
                                    seed=0, mutation_mix=mix,
                                    insert_pool=pool, tracer=tracer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
    finally:
        sanitize.set_enabled(prev)
        ann_server.search_batched = real_search
        search_kernel.measure_step_us = real_measure
    checked = [b for b in served["rewrites"] + [served["last"]]
               if b is not None]
    if not checked:
        raise RuntimeError("the streaming window kept no served batch")
    served_err = max(_check_served_batch(torch, live.pq, b)
                     for b in checked)
    other_mean = float(np.mean(search_s["other"]))
    rewrite_excess = sum(search_s["rewrite"]) - other_mean * len(
        search_s["rewrite"])
    doc = tracer.to_chrome()
    problems = validate_chrome_trace(doc)
    say("serve", part="streaming", rate_qps=round(rate, 1),
        inserts=rep_m.inserts, deletes=rep_m.deletes,
        flushes=rep_m.flushes, compactions=rep_m.compactions,
        journal_writes=rep_m.journal_writes,
        fused_page_rank_launches=launches["fused_page_rank"],
        measured_step_us=round(rep_m.measured_step_us, 3),
        trace_events=len(doc["traceEvents"]),
        trace_problems=len(problems),
        served_batches_checked=len(checked),
        served_fused_max_abs_err=served_err,
        searches=len(search_s["rewrite"]) + len(search_s["other"]),
        rewrite_search_s=json.dumps([round(t, 4) for t in
                                     search_s["rewrite"]]).replace(" ", ""),
        other_search_s_mean=round(other_mean, 5),
        rewrite_excess_s=round(rewrite_excess, 4),
        rewrite_excess_share=round(rewrite_excess / wall, 4),
        served_qps_on_card=round(rep_m.completed / wall, 1),
        serve_s=round(wall, 3), modelled_row=_row(rep_m))
    if launches["fused_page_rank"] == 0:
        raise RuntimeError("the streaming window launched no "
                           "fused_page_rank kernel")
    if problems:
        raise RuntimeError(f"the Chrome trace does not validate: "
                           f"{problems[:5]}")
    if rep_m.flushes == 0 or rep_m.compactions == 0:
        raise RuntimeError("the streaming window ran no flush or no "
                           "compaction")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = recover(idx, journal)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    q64 = ds.queries[:64]
    a, b = live.search(q64), rec.search(q64)
    checks = {"tombstones": rec.pending_tombstones == live.pending_tombstones,
              "free": rec.free_pages == live.free_pages,
              "dirty": rec.dirty_pages == live.dirty_pages,
              "overlap_ratio": rec.overlap_ratio() == live.overlap_ratio(),
              "ids": bool(np.array_equal(a.ids, b.ids)),
              "dists": bool(np.array_equal(a.dists, b.dists))}
    # the reverse adjacency of the 1M graph, the reference's way (edge by
    # edge into a list of sets) and the port's (one sort by target, each
    # set made on first read); the sets of REV_SAMPLE vertices must agree
    # (reading all 1M of the port's takes about 40 s)
    t0 = time.perf_counter()
    plain_rev = _plain_reverse_adjacency(idx.graph)
    plain_rev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    port_rev = _ReverseAdjacency(idx.graph, idx.device)
    torch.cuda.synchronize()
    port_rev_s = time.perf_counter() - t0
    sample = np.random.default_rng(0).choice(len(plain_rev), REV_SAMPLE,
                                             replace=False)
    t0 = time.perf_counter()
    rev_equal = (len(port_rev) == len(plain_rev)
                 and all(port_rev[v] == plain_rev[v] for v in sample))
    rev_read_s = time.perf_counter() - t0
    del plain_rev, port_rev
    say("serve", part="recovery", mutable_index_build_s=round(build_s, 3),
        flush_s=json.dumps(times["flush"]).replace(" ", ""),
        compact_s=json.dumps(times["compact"]).replace(" ", ""),
        recover_s=round(recover_s, 3),
        recovery_us_modelled=round(rec.last_recovery_us, 1),
        ops_replayed=rec.ops_applied,
        rev_plain_s=round(plain_rev_s, 3), rev_port_s=round(port_rev_s, 3),
        rev_port_read_s=round(rev_read_s, 3), rev_sampled=REV_SAMPLE,
        rev_equal_plain=rev_equal, equal=json.dumps(checks).replace(" ", ""))
    if not all(checks.values()):
        raise RuntimeError(f"the recovered index differs from the live "
                           f"one: {checks}")
    if not rev_equal:
        raise RuntimeError("the port's reverse adjacency differs from the "
                           "reference's edge-by-edge sets")
    say("serve", phase_s=round(time.perf_counter() - t_phase, 3))
    return {"launches": launches["fused_page_rank"], "closed_qps": rep.qps}


def phase_fleet(rt, torch, ds, indexes, search_out, closed_qps):
    """FleetServer on the card: replica groups over the baseline index,
    with migration and autoscaling, on the fused served path."""
    from repro_torch import kernels as ops
    from repro_torch import sanitize
    from repro_torch.core import search_kernel
    from repro_torch.io import profile_from_trace
    from repro_torch.obs import (CONSERVATION_TOL_US, Tracer,
                                 validate_chrome_trace)
    from repro_torch.serving import (AutoscaleConfig, FleetConfig,
                                     FleetServer, MigrationConfig,
                                     ServerConfig)
    t_phase = time.perf_counter()
    idx = indexes["baseline"]
    lay = idx.layout
    cfg = rt.get_preset("pipeline", pipeline="fused")
    profile = profile_from_trace(search_out["trace"], lay.num_pages)
    scfg = ServerConfig(
        shards=4, placement="replicated", cache_policy="lru",
        cache_bytes=int(IO_CACHE_FRAC * lay.num_pages * lay.page_bytes))
    fcfg = FleetConfig(replica_groups=2, routing="least-work",
                       migration=MigrationConfig(),
                       autoscale=AutoscaleConfig(min_groups=1, max_groups=4))
    builds = []

    class TimedFleet(FleetServer):
        """Times each group's store build and the device bytes it
        allocates."""

        def _activate_group(self, now_us):
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            r = super()._activate_group(now_us)
            torch.cuda.synchronize()
            builds.append({"group": r.rid, "at_us": round(now_us, 1),
                           "build_s": round(time.perf_counter() - t0, 4),
                           "device_bytes": torch.cuda.memory_allocated()
                           - m0})
            return r

    torch.cuda.synchronize()
    _reset_peak(torch)
    base_bytes = torch.cuda.memory_allocated()
    srv = TimedFleet(idx, cfg, server_cfg=scfg, fleet_cfg=fcfg,
                     page_profile=profile)
    # the first batch served on each group is kept for a check against
    # the plain version after the window
    routed = {"rid": None}
    firsts = {}
    real_route = srv._route
    real_measure = search_kernel.measure_step_us

    def route(routable):
        r = real_route(routable)
        routed["rid"] = r.rid
        return r

    def measure_and_keep(store, pq, queries, page_trace, **kw):
        out = real_measure(store, pq, queries, page_trace, **kw)
        if routed["rid"] not in firsts:
            firsts[routed["rid"]] = _served_batch(store, pq, queries,
                                                  page_trace)
        return out

    srv._route = route
    search_kernel.measure_step_us = measure_and_keep
    rate = 2.0 * closed_qps
    tracer = Tracer()
    prev = sanitize.set_enabled(True)
    try:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = srv.serve_fleet(ds.queries, rate_qps=rate,
                              duration_us=FLEET_ARRIVALS / rate * 1e6,
                              seed=0, tracer=tracer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches["fused_page_rank"]
    finally:
        sanitize.set_enabled(prev)
        search_kernel.measure_step_us = real_measure
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    above_gib = peak_gib - base_bytes / 2**30
    # which stores hold device copies of the layout: the server's kernel
    # store (every group's batches search it) and any group store
    def bottom(store):
        while hasattr(store, "inner"):
            store = store.inner
        return store

    def device_bytes(store):
        b = bottom(store)
        arrays = list(b._kernel_cache or ())
        codes = store.__dict__.get("_device_page_codes")
        return sum(a.numel() * a.element_size()
                   for a in arrays + ([codes] if codes is not None else []))
    kernel_store_bytes = device_bytes(srv.store)
    group_uploads = [r.rid for r in srv.replicas
                     if bottom(r.store)._kernel_cache is not None]
    checked = [b for b in firsts.values() if b is not None]
    if len(checked) < len([r for r in srv.replicas if r.batches]):
        raise RuntimeError("[fleet] kept no first batch for some group")
    served_err = max(_check_served_batch(torch, idx.pq, b) for b in checked)

    want = idx.search(ds.queries[rep.query_indices], cfg,
                      batch=scfg.max_batch)
    same = int(np.all(rep.stats.ids == want.ids, axis=1).sum())
    at = rep.attribution
    resid = float(np.abs(at["queue_us"] + at["service_us"]
                         + at["interference_us"] - at["latency_us"]).max())
    doc = tracer.to_chrome()
    problems = validate_chrome_trace(doc)
    events = [e for e in (rep.timeline or []) if e[3]]
    say("fleet", rate_qps=round(rate, 1), offered=rep.offered,
        completed=rep.completed, shed=rep.shed,
        ids_equal_facade=f"{same}/{rep.completed}",
        attribution_max_residual_us=resid,
        fused_page_rank_launches=launches,
        served_batches_checked=len(checked),
        served_fused_max_abs_err=served_err,
        trace_events=len(doc["traceEvents"]), trace_problems=len(problems),
        migrations=rep.migrations, promoted_pages=rep.promoted_pages,
        demoted_pages=rep.demoted_pages,
        mig_pages_read=rep.mig_pages_read,
        mig_pages_written=rep.mig_pages_written,
        mig_io_us=round(rep.mig_io_us, 1),
        scale_events=json.dumps(events).replace(" ", ""),
        groups_final=rep.groups_final,
        per_replica=json.dumps(rep.per_replica).replace(" ", ""))
    say("fleet", group_builds=json.dumps(builds).replace(" ", ""),
        group_stores_uploaded=json.dumps(group_uploads),
        kernel_store_device_gib=round(kernel_store_bytes / 2**30, 3),
        peak_device_gib=round(peak_gib, 3),
        peak_device_gib_above_earlier_phases=round(above_gib, 3),
        served_qps_on_card=round(rep.completed / wall, 1),
        serve_s=round(wall, 3), modelled_row=_row(rep))
    if same != rep.completed or not np.isfinite(rep.stats.dists).all():
        raise RuntimeError("[fleet]: the fleet's results are not the "
                           "facade's")
    if resid > CONSERVATION_TOL_US:
        raise RuntimeError(f"[fleet]: attribution residual {resid} us")
    if problems:
        raise RuntimeError(f"[fleet]: the Chrome trace does not validate: "
                           f"{problems[:5]}")
    if launches == 0:
        raise RuntimeError("[fleet] launched no fused_page_rank kernel")
    if served_err > 1e-4:
        raise RuntimeError(f"[fleet]: a served batch's fused_page_rank is "
                           f"{served_err} from the plain version")
    say("fleet", phase_s=round(time.perf_counter() - t_phase, 3))
    return launches


def _decode_vs_prefill(torch, params, cfg):
    """Decode of the second half of LM_CHECK_B x LM_CHECK_S seeded tokens
    after a half-length prefill against the full prefill's next-token
    logits (tests/test_arch_smoke.py:57), on the parameters' device, once
    in the reference's bfloat16 caches (held at LM_TOL) and once in float32
    caches (held at LM_F32_CACHE_TOL). For each: (max abs difference, the
    largest excess over allclose's tolerance, |a - b| - tol * (1 + |b|),
    which must not be positive)."""
    from repro_torch.serving.engine import decode_vs_prefill
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (LM_CHECK_B, LM_CHECK_S))
    frames = (rng.normal(0, 0.1, (LM_CHECK_B, cfg.num_frames, cfg.d_model))
              .astype(np.float32) if cfg.frontend == "audio_stub" else None)
    out = {}
    for name, dtype, tol in (("bf16", torch.bfloat16, LM_TOL),
                             ("f32", torch.float32, LM_F32_CACHE_TOL)):
        lg, full = decode_vs_prefill(params, cfg, toks, frames,
                                     cache_dtype=dtype)
        if lg.shape != full.shape or not torch.isfinite(lg).all():
            raise RuntimeError(f"{cfg.name}: malformed logits "
                               f"{tuple(lg.shape)}")
        diff = (lg.float() - full.float()).abs()
        excess = diff - tol * (1.0 + full.float().abs())
        out[name] = (float(diff.max()), float(excess.max()))
    return out


def _decode_vs_prefill_failures(errs):
    """The checks of `_decode_vs_prefill` results that fail."""
    tols = {"bf16": LM_TOL, "f32": LM_F32_CACHE_TOL}
    return {(k, c): e for k, r in errs.items() for c, e in r.items()
            if not (e[1] <= 0 and e[0] <= tols[c])}


def _kernel_ms(torch, fn) -> dict:
    """The device time of each kernel `fn` launches, by name, in ms, from
    torch.profiler: the rows of the device's own events (a CPU operator's
    row repeats its kernels' time, so it is not added). Raises where the
    profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    if not sum(rows.values()) > 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return rows


def _device_busy_ms(torch, fn):
    """The device time of the kernels `fn` launches (_kernel_ms)."""
    return sum(_kernel_ms(torch, fn).values())


def phase_lm(rt, torch, ds, search_out):
    """The LM decode server on the card: the RAG launcher, TinyLlama-1.1B
    at full width, and decode-vs-prefill checks."""
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step)
    from repro_torch.serving.engine import LMServer, _fit
    t_phase = time.perf_counter()

    # (a) the launcher, as a user runs it
    t0 = time.perf_counter()
    served = serve.main(["--rag"])
    torch.cuda.synchronize()
    say("lm", part="launch-serve-rag", requests_served=served,
        seconds=round(time.perf_counter() - t0, 3))
    if served != 12:
        raise RuntimeError(f"launch.serve served {served} of 12 requests")

    # (b) TinyLlama-1.1B at full width, bf16, on RAG prompts
    cfg = get_config("tinyllama-1.1b")
    torch.cuda.synchronize()
    _reset_peak(torch)
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    ctx = (search_out["baseline_ids"][:LM_PROMPTS, :LM_RETRIEVED]
           % cfg.vocab_size).astype(np.int32)
    question = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (LM_PROMPTS, LM_QUESTION)).astype(np.int32)
    prompts = np.concatenate([ctx, question], axis=1)
    server = LMServer(params, cfg, max_len=256)
    server.generate(prompts, new_tokens=2)               # warm-up
    batch = {"tokens": torch.as_tensor(prompts, device="cuda").long()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = prefill_step(params, cfg, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = server.generate(prompts, new_tokens=LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    decode_ms = (gen_s * 1e3 - prefill_ms) / LM_NEW
    first = torch.argmax(logits, -1).cpu().numpy()
    # four decode steps under the profiler: device busy time against the
    # steps' wall time
    with torch.inference_mode():
        _, cache = prefill_step(params, cfg, batch)
        cache = [_fit(d, c) for d, c in zip(
            init_cache(cfg, LM_PROMPTS, 256, device="cuda"), cache)]
        tok = batch["tokens"][:, -1:]
        state = {"cache": cache}

        def steps():
            for i in range(4):
                _, state["cache"] = decode_step(
                    params, cfg, tok, state["cache"], prompts.shape[1] + i)
        steps()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        steps_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = _device_busy_ms(torch, steps)
    peak_gib = (torch.cuda.max_memory_allocated() - base_bytes) / 2**30
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    say("lm", part="tinyllama-1.1b-bf16", layers=cfg.num_layers,
        d_model=cfg.d_model, heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, params=n_params,
        weight_gb=round(weight_bytes / 1e9, 3), init_s=round(init_s, 3),
        prompts=json.dumps(list(prompts.shape)), new_tokens=LM_NEW,
        prefill_ms=round(prefill_ms, 3),
        decode_ms_per_token=round(decode_ms, 3),
        tokens_per_s=round(LM_PROMPTS * LM_NEW / gen_s, 1),
        generate_s=round(gen_s, 3),
        decode_4_steps_ms=round(steps_ms, 3),
        decode_4_steps_device_busy_ms=round(busy_ms, 3),
        device_busy_share=round(busy_ms / steps_ms, 4),
        peak_device_gib_above_earlier_phases=round(peak_gib, 3),
        first_tokens=json.dumps(out[:2, :8].tolist()).replace(" ", ""))
    if out.shape != (LM_PROMPTS, LM_NEW) or not (
            (out >= 0) & (out < cfg.padded_vocab)).all():
        raise RuntimeError(f"TinyLlama generated {out.shape} tokens out of "
                           f"range")
    if not (out[:, 0] == first).all():
        raise RuntimeError("the first generated token is not the prefill's "
                           "argmax")
    del server, params, logits, cache, state
    torch.cuda.empty_cache()

    # (c) the same model in float32: decode against prefill
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.float32)
    errs = _decode_vs_prefill(torch, params, cfg)
    for c, tol in (("bf16", LM_TOL), ("f32", LM_F32_CACHE_TOL)):
        say("lm", part="tinyllama-1.1b-f32-decode-vs-prefill", cache=c,
            B=LM_CHECK_B, S=LM_CHECK_S, max_abs_logit_err=errs[c][0],
            rtol=tol, atol=tol, max_excess_over_tol=errs[c][1])
    if _decode_vs_prefill_failures({cfg.name: errs}):
        raise RuntimeError(f"TinyLlama f32 decode differs from prefill: "
                           f"{errs}")
    del params
    torch.cuda.empty_cache()

    # (d) the same check for every smoke config
    errs = {}
    for arch in ARCH_IDS:
        scfg = get_smoke_config(arch)
        p = init_params(scfg, torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.float32)
        errs[arch] = _decode_vs_prefill(torch, p, scfg)
    for c, tol in (("bf16", LM_TOL), ("f32", LM_F32_CACHE_TOL)):
        say("lm", part="smoke-configs-decode-vs-prefill", cache=c,
            max_abs_logit_err=json.dumps({a: e[c][0] for a, e in
                                          errs.items()}).replace(" ", ""),
            rtol=tol, atol=tol,
            max_excess_over_tol=max(e[c][1] for e in errs.values()))
    bad = _decode_vs_prefill_failures(errs)
    if bad:
        raise RuntimeError(f"decode differs from prefill: {bad}")
    say("lm", phase_s=round(time.perf_counter() - t_phase, 3))


def _train_cpu_pair(compress: bool, accum: int) -> dict:
    """launch.train.first_step of the tinyllama smoke config on the card
    against the CPU (launch.train.step_difference)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import first_step, step_difference
    cfg = get_smoke_config("tinyllama-1.1b")
    return step_difference(first_step(cfg, "cuda", compress, accum),
                           first_step(cfg, "cpu", compress, accum),
                           TRAIN_CPU_RTOL, TRAIN_CPU_ATOL)


def _run_train(args, tag: str):
    """`python -m repro_torch.launch.train args` in a process of its own:
    (return code, seconds, its output's [ckpt] and [resume] seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")})
    secs = time.perf_counter() - t0
    saves = [float(x) for x in re.findall(r"\[ckpt\] saved step \d+ in "
                                          r"([0-9.]+)s", r.stdout)]
    restores = [float(x) for x in re.findall(r"\[resume\] restored step "
                                             r"\d+ .* in ([0-9.]+)s",
                                             r.stdout)]
    if r.returncode not in (0, 42):
        raise RuntimeError(f"[train] {tag} exited {r.returncode}:\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return r.returncode, secs, saves, restores


def phase_train(torch):
    """Training on the card: TinyLlama-1.1B at full width through the
    launcher, the die-and-resume drill in processes of its own, and one
    step of the smoke config on the card against the CPU."""
    import os
    import shutil
    import statistics
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.device_model import H100_SXM
    from repro_torch.launch import train
    from repro_torch.models import abstract_params, init_params
    from repro_torch.training import compression, optim
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()              # [lm]'s models are gone by now
    cfg = get_config("tinyllama-1.1b")
    n_params = sum(p.numel() for p in abstract_params(cfg).parameters())
    n_dense = n_params - cfg.padded_vocab * cfg.d_model   # outside the table
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    tokens = batch * seq
    bound_s = 6 * n_dense * tokens / H100_SXM.peak_flops_f32
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="train-", dir=ROOT / "build"))
    try:
        # (a) the launcher, as a user runs it
        torch.cuda.synchronize()
        _reset_peak(torch)
        base_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        losses = train.main(TRAIN_ARGS + ["--log-every", "5",
                                          "--metrics-out",
                                          str(work / "a.json")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gib = (torch.cuda.max_memory_allocated() - base_bytes) / 2**30
        step_s = json.load(open(work / "a.json"))["step_s"]
        step_ms = statistics.median(step_s[2:]) * 1e3
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise RuntimeError(f"[train] the loss did not fall: {losses}")

        # the device's busy share of TRAIN_PROFILED_STEPS steps
        opt = optim.for_model(cfg, lr=1e-3, warmup_steps=10,
                              total_steps=20)
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), dtype=torch.float32)
        state = {"opt": optim.init_state(params, opt),
                 "err": compression.init_error_state(params)}
        step_fn = train.make_train_step(cfg, opt)
        toks = torch.randint(1, cfg.vocab_size, (batch, seq),
                             device="cuda", generator=torch.Generator(
                                 device="cuda").manual_seed(1))

        def steps():
            for _ in range(TRAIN_PROFILED_STEPS):
                _, state["opt"], state["err"], _ = step_fn(
                    params, state["opt"], state["err"], {"tokens": toks})
        steps()                                           # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        steps_ms = (time.perf_counter() - t0) * 1e3
        kernels = _kernel_ms(torch, steps)
        busy_ms = sum(kernels.values())
        gemm_ms = sum(v for k, v in kernels.items()
                      if "gemm" in k.lower() or "cutlass" in k.lower())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        del params, state, step_fn
        torch.cuda.empty_cache()
        say("train", part="tinyllama-1.1b-f32", layers=cfg.num_layers,
            d_model=cfg.d_model, heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
            d_ff=cfg.d_ff, vocab=cfg.vocab_size, params=n_params,
            params_outside_embedding=n_dense, batch=batch, seq=seq,
            steps=len(losses), run_s=round(run_s, 3),
            ms_per_step_median_2_19=round(step_ms, 3),
            tokens_per_s=round(tokens / step_ms * 1e3, 1),
            bound_ms_6NT_f32=round(bound_s * 1e3, 3),
            ms_over_bound=round(step_ms / (bound_s * 1e3), 3),
            profiled_steps_ms=round(steps_ms, 3),
            profiled_steps_device_busy_ms=round(busy_ms, 3),
            device_busy_share=round(busy_ms / steps_ms, 4),
            gemm_share_of_busy=round(gemm_ms / busy_ms, 4),
            top_kernels_ms=json.dumps({k[:60]: round(v, 3) for k, v in top}
                                      ).replace(" ", ""),
            peak_device_gib=round(peak_gib, 3),
            first_loss=losses[0], last_loss=losses[-1])

        # (b) die and resume, each half a process of its own
        ck = work / "ck"
        free_gb = shutil.disk_usage(work).free / 1e9
        drill = TRAIN_ARGS + ["--ckpt-dir", str(ck), "--ckpt-every",
                              str(TRAIN_CKPT_EVERY), "--log-every", "5"]
        rc1, s1, saves1, _ = _run_train(drill + ["--die-at",
                                                 str(TRAIN_DIE_AT)], "die")
        ck_gb = sum(f.stat().st_size for f in ck.iterdir()) / 1e9
        rc2, s2, saves2, restores = _run_train(
            drill + ["--resume", "--metrics-out", str(work / "b.json")],
            "resume")
        res = json.load(open(work / "b.json"))
        resumed = np.asarray(res["losses"])
        want = np.asarray(losses[res["start"]:])
        diff = float(np.abs(resumed - want).max())
        say("train", part="die-and-resume", free_disk_gb=round(free_gb, 1),
            die_rc=rc1, die_run_s=round(s1, 3), resume_rc=rc2,
            resume_run_s=round(s2, 3), start=res["start"],
            checkpoint_gb=round(ck_gb, 3),
            save_s=json.dumps(saves1 + saves2), restore_s=json.dumps(
                restores), resumed_last_loss=float(resumed[-1]),
            uninterrupted_last_loss=losses[-1],
            max_abs_loss_diff_resumed_steps=diff,
            bits_equal=bool((resumed == want).all()))
        if rc1 != 42 or rc2 != 0 or res["start"] != TRAIN_CKPT_EVERY:
            raise RuntimeError(f"[train] drill: rc {rc1}, {rc2}, start "
                               f"{res['start']}")
        if not np.allclose(resumed[-1], losses[-1], rtol=TRAIN_RESUME_RTOL,
                           atol=0):
            raise RuntimeError(f"[train] the resumed run ends on "
                               f"{resumed[-1]}, the uninterrupted one on "
                               f"{losses[-1]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (c) one step of the smoke config on the card against the CPU
    for compress, accum in ((False, 1), (False, 2), (True, 1)):
        r = _train_cpu_pair(compress, accum)
        say("train", part="card-vs-cpu", arch="tinyllama-1.1b-smoke",
            compress=compress, accum=accum, rtol=TRAIN_CPU_RTOL,
            atol=TRAIN_CPU_ATOL, **r)
        if (r["max_excess_over_tol"] > 0 or r["code_flips"]
                > TRAIN_MAX_FLIP_SHARE * r["elements"]):
            raise RuntimeError(f"[train] the card's step differs from the "
                               f"CPU's: {r}")
    say("train", phase_s=round(time.perf_counter() - t_phase, 3))


def _tf32_off(torch) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sync_s(torch, t0: float) -> float:
    torch.cuda.synchronize()
    return round(time.perf_counter() - t0, 3)


def _restore_check(torch, ckpt, mesh, cfg) -> dict:
    """restore(shardings=) of [mesh] (e)'s checkpoint onto `mesh`: each
    leaf's block against its slice of the saved array, cut by hand from
    the spec (the entries name "model" or nothing)."""
    from repro_torch.parallel import ParallelContext
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.api import NamedSharding
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.tree import tree_items, tree_map
    saved = np.load(ckpt / "step_00000001.proc0.npz")
    target = {}
    for key in saved.files:
        node = target
        *parents, name = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = torch.empty(saved[key].shape, device="meta")
    specs = sh.param_pspecs(ParallelContext(mesh, profile="tp"), cfg,
                            target)
    shd = tree_map(lambda t, spec: NamedSharding(mesh, spec), target, specs)
    t0 = time.perf_counter()
    tree, _ = ck.restore(ckpt, target, shardings=shd,
                         device=mesh.device_type)
    restore_s = _sync_s(torch, t0)
    m, me = mesh.size(mesh_dim=1), mesh.get_local_rank("model")
    sharded = 0
    for path, leaf in tree_items(tree):
        want = saved["/".join(path)]
        spec = specs
        for k in path:
            spec = spec[k]
        for dim, entry in enumerate(spec):
            if entry == "model":
                n = want.shape[dim] // m
                want = want.take(range(me * n, (me + 1) * n), axis=dim)
                sharded += 1
        if not np.array_equal(leaf.to_local().cpu().numpy(), want):
            raise RuntimeError(f"[mesh] restore: {path} differs from its "
                               f"slice of the saved array")
    return {"leaves": len(saved.files), "sharded_leaves": sharded,
            "restore_s": restore_s}


def _moe_case(torch, cfg, mesh, quant: bool) -> dict:
    """[mesh] (b) on this rank: apply_moe on `mesh` against the local path
    on this rank's data shard."""
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import ParallelContext, comm
    ctx = ParallelContext(mesh, gather_quant=quant)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = MOE.init_moe(gen, cfg, torch.float32)
    x = torch.randn((MESH_MOE_B, MESH_MOE_S, cfg.d_model), device="cuda",
                    generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux = MOE.apply_moe(p, x, cfg, parallel=ctx)
    ep_first_s = _sync_s(torch, t0)     # with the groups' first contact
    t0 = time.perf_counter()
    y2, _ = MOE.apply_moe(p, x, cfg, parallel=ctx)
    ep_s = _sync_s(torch, t0)
    w = ctx.moe_weight_axes(cfg)
    if quant and (w["d_ff"] or w["d_model"]):
        p = dict(p, **{k: p[k].to(torch.float8_e4m3fn).float()
                       for k in ("wi", "wg", "wo")})
    shards = x.chunk(mesh.size(mesh_dim=0))
    t0 = time.perf_counter()
    y_loc, _ = MOE.apply_moe(p, shards[mesh.get_local_rank("data")], cfg)
    local_s = _sync_s(torch, t0)
    aux_loc = torch.stack([MOE.apply_moe(p, xs, cfg)[1]
                           for xs in shards]).mean()
    # each call against the local path: the dispatch's index_add_ adds with
    # atomics on the card, so two calls may differ in their last bits
    ys = [y.to_local(), y2.to_local()]
    ok = (all(torch.allclose(v, y_loc, rtol=MESH_MOE_TOL, atol=MESH_MOE_TOL)
              for v in ys)
          and torch.allclose(aux.to_local(), aux_loc, rtol=MESH_MOE_TOL,
                             atol=MESH_MOE_TOL))
    return {"ok": bool(ok),
            "max_abs_err": max(float((v - y_loc).abs().max()) for v in ys),
            "aux": float(aux.to_local()), "aux_local": float(aux_loc),
            "ep_first_s": ep_first_s, "ep_s": ep_s, "local_s": local_s,
            "gathers": [a for a in (w["d_ff"], w["d_model"]) if a],
            "transport": comm.transport(mesh.get_group("model"), y.device)}


def _mesh_rank2(rank, world, ckpt):
    """[mesh] (b) at model = 2 and (e)'s two-rank restore."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    _tf32_off(torch)
    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    out = {}
    for quant in (False, True):
        t0 = time.perf_counter()
        out[f"moe-model2-quant{int(quant)}"] = dict(
            _moe_case(torch, get_config("qwen2-moe-a2.7b"), mesh, quant),
            seconds=_sync_s(torch, t0))
    t0 = time.perf_counter()
    out["restore-2-ranks"] = dict(
        _restore_check(torch, Path(ckpt), mesh,
                       get_config("tinyllama-1.1b")),
        seconds=_sync_s(torch, t0))
    return out


def _mesh_rank4(rank, world):
    """[mesh] (b) at data = 2, model = 2, (c) gpipe and (d)
    compressed_psum."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import gpipe
    from repro_torch.training.compression import compressed_psum, quantize
    _tf32_off(torch)
    out = {}
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    for quant in (False, True):
        t0 = time.perf_counter()
        out[f"moe-data2-model2-quant{int(quant)}"] = dict(
            _moe_case(torch, get_config("qwen2-moe-a2.7b"), mesh, quant),
            seconds=_sync_s(torch, t0))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pod = init_device_mesh("cuda", (world,), mesh_dim_names=("pod",))
    gen = torch.Generator(device="cuda").manual_seed(2)
    w = torch.randn((MESH_PIPE_STAGES, MESH_PIPE_D, MESH_PIPE_D),
                    device="cuda", generator=gen) / MESH_PIPE_D ** 0.5
    x = torch.randn((MESH_PIPE_B, MESH_PIPE_D), device="cuda", generator=gen)
    t1 = time.perf_counter()
    y = gpipe(lambda w_s, h: torch.tanh(h @ w_s), w, x, MESH_PIPE_MICRO,
              axis="pod", mesh=pod)
    pipe_s = _sync_s(torch, t1)
    seq = x
    for w_s in w:
        seq = torch.tanh(seq @ w_s)
    err = float((y - seq).abs().max())
    out["gpipe"] = {"ok": err < MESH_PIPE_TOL, "max_abs_err": err,
                    "gpipe_s": pipe_s, "seconds": _sync_s(torch, t0),
                    "transport": comm.transport(pod.get_group("pod"),
                                                y.device)}

    t0 = time.perf_counter()
    data = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))

    def grad(r):
        return torch.randn(MESH_PSUM_SHAPE, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(100 + r))
    t1 = time.perf_counter()
    s = compressed_psum(grad(rank), data.get_group("data"))
    psum_s = _sync_s(torch, t1)
    codes = [quantize(grad(r)) for r in range(world)]
    want = (sum(q.to(torch.int32) for q, _ in codes).to(torch.float32)
            * torch.stack([sc for _, sc in codes]).max())
    out["compressed_psum"] = {
        "ok": bool(torch.equal(s, want)),
        "max_abs_err": float((s - want).abs().max()),
        "psum_s": psum_s, "seconds": _sync_s(torch, t0),
        "transport": comm.transport(data.get_group("data"), s.device)}
    return out


def _mesh_serve_rank(rank, world, shape, profile, prompts, want_tokens,
                     want_logits):
    """[mesh] (f) on this rank: (a)'s model placed on a mesh of `shape`
    under `profile`, its prefill logits and served tokens against (a)'s."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import seq_shard
    from repro_torch.models import init_params, prefill_step
    from repro_torch.parallel import ParallelContext, comm
    from repro_torch.serving.engine import (LMServer, place_batch, whole,
                                            zero_cache)
    _tf32_off(torch)
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    cfg = get_config("tinyllama-1.1b")
    ctx = ParallelContext(mesh, profile=profile, seq_shard=seq_shard(cfg))
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.float32)
    srv = LMServer(params, cfg, max_len=MESH_SERVE_MAX_LEN, parallel=ctx)
    del params
    torch.cuda.empty_cache()
    place_s = _sync_s(torch, t0)
    blocks = [p.to_local() for p in srv.params.parameters()]
    param_bytes = sum(t.numel() * t.element_size() for t in blocks)
    comm.reset_host_stats()
    b, s = prompts.shape
    with torch.inference_mode(), implicit_replication():
        t1 = time.perf_counter()
        batch = place_batch(ctx, cfg, {"tokens": torch.as_tensor(
            prompts, device="cuda").long()})
        lg, cache = prefill_step(srv.params, cfg, batch, parallel=ctx,
                                 cache=zero_cache(ctx, cfg, b, s))
        logits = whole(lg).float().cpu().numpy()
        prefill_s = time.perf_counter() - t1
        tensors = blocks + [lg.to_local()] + [
            t.to_local() for c in cache for kind in c.values()
            for t in kind.values()]
    transports = dict(comm.host_stats["transports"])
    comm.reset_host_stats()
    t1 = time.perf_counter()
    toks = srv.generate(prompts, MESH_NEW)     # returns host memory
    generate_s = time.perf_counter() - t1
    stats = dict(comm.host_stats)
    for k, n in stats["transports"].items():
        transports[k] = transports.get(k, 0) + n
    err = float(np.abs(logits - want_logits).max())
    return {
        "ok": bool(np.array_equal(toks, want_tokens) and np.allclose(
            logits, want_logits, rtol=MESH_LOGITS_RTOL,
            atol=MESH_LOGITS_ATOL) and all(t.is_cuda for t in tensors)
            and set(transports) == {"gloo-host"}),
        "tokens_equal": bool(np.array_equal(toks, want_tokens)),
        "logits_max_abs_err": err, "on_card": all(t.is_cuda
                                                  for t in tensors),
        "transports": json.dumps(transports),
        "prefill_ms": prefill_s * 1e3,
        # generate's prefill taken as long as the one above
        "decode_ms_per_token": (generate_s - prefill_s) * 1e3 / MESH_NEW,
        "host_copy_s": round(stats["seconds"], 4),
        "host_copies": stats["copies"], "host_copy_mb": round(
            stats["bytes"] / 1e6, 1),
        "dtensor_moves": stats["dtensor_moves"],
        "param_bytes": param_bytes,
        "device_bytes": torch.cuda.memory_allocated(),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "place_s": place_s,
        "coordinate": json.dumps(mesh.get_coordinate())}


def _mesh_leaves(torch, params) -> dict:
    """[mesh] (e)'s checkpoint: the embedding and the first block's
    parameters, as nested dicts keyed as the reference keys them."""
    tree = {"embed": {"table": params.embed.table.detach()}}
    for name, t in params.blocks[0].named_parameters():
        node = tree.setdefault("block", {})
        *parents, leaf = name.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t.detach()
    return tree


def phase_mesh(torch):
    """The mesh code on the card: a one-rank NCCL mesh through the model
    and the LM server, then expert parallelism, gpipe, compressed_psum and
    restore onto a mesh in processes sharing the card over gloo."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh, run_in_processes
    from repro_torch.models import forward, init_params, loss_fn, prefill_step
    from repro_torch.parallel import ParallelContext, comm
    from repro_torch.serving.engine import LMServer
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.accumulate import value_and_grad
    from repro_torch.training.tree import tree_items
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()              # [train]'s models are gone by now
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="mesh-", dir=ROOT / "build"))
    try:
        # (a) a one-rank NCCL mesh through the model and the server
        t0 = time.perf_counter()
        mesh = make_local_mesh()
        ctx = ParallelContext(mesh)
        cfg = get_config("tinyllama-1.1b")
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), dtype=torch.float32)
        batch = {"tokens": torch.randint(
            1, cfg.vocab_size, (MESH_B, MESH_S), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(1))}
        t1 = time.perf_counter()
        (loss, _), grads = value_and_grad(
            lambda p, b: loss_fn(p, cfg, b, parallel=ctx), params, batch)
        ctx_s = _sync_s(torch, t1)
        (loss0, _), grads0 = value_and_grad(
            lambda p, b: loss_fn(p, cfg, b), params, batch)
        excess = rel = 0.0
        want = dict(tree_items(grads0))
        for path, g in tree_items(grads):
            w = want[path]
            d = (g - w).abs()
            tol = (MESH_GRAD_RTOL * w.abs()
                   + MESH_GRAD_FLOOR * float(w.abs().max()))
            excess = max(excess, float((d - tol).max()))
            rel = max(rel, float((d / w.abs().clamp_min(1e-30)).max()))
        del grads, grads0
        prompts = torch.randint(
            1, cfg.vocab_size, (MESH_PROMPTS, MESH_PROMPT_LEN),
            generator=torch.Generator().manual_seed(2)).numpy()
        t1 = time.perf_counter()
        toks = LMServer(params, cfg, max_len=MESH_SERVE_MAX_LEN,
                        parallel=ctx).generate(prompts, new_tokens=MESH_NEW)
        serve_s = _sync_s(torch, t1)
        toks0 = LMServer(params, cfg, max_len=MESH_SERVE_MAX_LEN).generate(
            prompts, new_tokens=MESH_NEW)
        with torch.inference_mode():     # (f)'s prefill logits
            logits0 = prefill_step(params, cfg, {"tokens": torch.as_tensor(
                prompts, device="cuda").long()})[0].float().cpu().numpy()
            # the smallest gap between the two largest logits of a greedy
            # pick: every position's logits over the prompts and the picks
            seq = torch.as_tensor(np.concatenate([prompts, toks0[:, :-1]],
                                                 1), device="cuda").long()
            top = torch.topk(forward(params, cfg, seq)["logits"][
                :, MESH_PROMPT_LEN - 1:].float(), 2, dim=-1).values
            margin = float((top[..., 0] - top[..., 1]).min())
        say("mesh", part="one-rank-nccl", arch="tinyllama-1.1b-f32",
            mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
            backend=dist.get_backend(), loss=float(loss),
            loss_bits_equal=float(loss) == float(loss0),
            grad_leaves=len(want), grad_max_rel_err=rel,
            grad_max_excess_over_tol=excess, loss_and_grads_ctx_s=ctx_s,
            lm_tokens_equal=bool((toks == toks0).all()),
            lm_generate_ctx_s=serve_s, seconds=_sync_s(torch, t0))
        if float(loss) != float(loss0) or excess > 0 or not (
                toks == toks0).all():
            raise RuntimeError("[mesh] (a): the one-rank mesh changed the "
                               "loss, the gradients or the tokens")

        # (e) the checkpoint, restored onto the one-rank mesh
        t0 = time.perf_counter()
        ckpt = work / "ckpt"
        ck.save(ckpt, 1, _mesh_leaves(torch, params))
        save_s = _sync_s(torch, t0)
        del params
        torch.cuda.empty_cache()
        r = _restore_check(torch, ckpt, mesh, cfg)
        say("mesh", part="restore-one-rank", save_s=save_s,
            checkpoint_mb=round(sum(f.stat().st_size for f in
                                    ckpt.iterdir()) / 1e6, 1), **r,
            seconds=_sync_s(torch, t0))
        dist.destroy_process_group()

        # (b) - (e) in processes sharing the card over gloo
        for world, fn, args in ((4, _mesh_rank4, ()),
                                (2, _mesh_rank2, (str(ckpt),))):
            t0 = time.perf_counter()
            ranks = run_in_processes(fn, world, *args, store_dir=work,
                                     timeout=MESH_RANK_TIMEOUT)
            wall = round(time.perf_counter() - t0, 3)
            for part in ranks[0]:
                rows = [rk[part] for rk in ranks]
                say("mesh", part=part, ranks=world, ok=all(
                    r.get("ok", True) for r in rows),
                    **{k: v for k, v in rows[0].items() if k != "ok"},
                    max_abs_err_all_ranks=max(r.get("max_abs_err", 0.0)
                                              for r in rows))
                if not all(r.get("ok", True) for r in rows):
                    raise RuntimeError(f"[mesh] {part}: {rows}")
            say("mesh", part=f"processes-{world}", wall_s=wall)

        # (f) the LM server on meshes of real ranks sharing the card
        for world, shape, profile in MESH_SERVE:
            t0 = time.perf_counter()
            ranks = run_in_processes(
                _mesh_serve_rank, world, shape, profile, prompts, toks0,
                logits0, store_dir=work, timeout=MESH_RANK_TIMEOUT)
            for r in ranks:
                say("mesh", part="lm-server", arch="tinyllama-1.1b-f32",
                    ranks=world, mesh=json.dumps(dict(zip(
                        ("data", "model"), shape))), profile=profile,
                    prompts=MESH_PROMPTS, prompt_len=MESH_PROMPT_LEN,
                    new_tokens=MESH_NEW, min_top2_margin=margin,
                    nvidia_smi=json.dumps(nvidia_smi()), **r)
            say("mesh", part=f"lm-server-processes-{world}",
                wall_s=round(time.perf_counter() - t0, 3))
            if not all(r["ok"] for r in ranks):
                raise RuntimeError(f"[mesh] (f) on {shape} under "
                                   f"{profile}: {ranks}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("mesh", phase_s=round(time.perf_counter() - t_phase, 3))


def phase_dryrun(torch):
    """The dry run on fake ranks, and its record held against the real
    step on the card."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # (a) the launcher's `main` as `python -m repro_torch.launch.dryrun`
    # calls it, once per cell, all in one process of its own (its fake
    # process group must not meet a real one)
    tag = "chip-smoke"
    out_dir = ROOT / "build" / f"dryrun_{tag}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argvs = [["--arch", arch, "--shape", shape, "--mesh", mesh, "--force",
              "--tag", tag] for mesh, arch, shape in DRYRUN_CELLS]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; from repro_torch.launch import dryrun\n"
         "for argv in json.loads(sys.argv[1]): dryrun.main(argv)",
         json.dumps(argvs)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=DRYRUN_TIMEOUT)
    wall = round(time.perf_counter() - t0, 3)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"[dryrun] (a): exit {proc.returncode}")
    n_cells = 0
    for mesh, arch, shape in DRYRUN_CELLS:
        for rec_path in sorted((out_dir / mesh).glob(
                f"{arch}__{'*' if shape == 'all' else shape}.json")):
            rec = json.loads(rec_path.read_text())
            n_cells += 1
            coll = rec.get("collectives", {})
            say("dryrun", part="cell", mesh=mesh, arch=rec["arch"],
                shape=rec["shape"], ok=rec["ok"], profile=rec.get("profile"),
                n_devices=rec.get("n_devices"), flops=rec.get("flops"),
                traffic_bytes=rec.get("traffic_bytes"),
                collective_bytes=sum(v for k, v in coll.items()
                                     if not k.endswith("_count")),
                collectives=json.dumps(coll), memory=json.dumps(
                    rec.get("memory")), trace_s=rec.get("trace_s"),
                total_s=rec["total_s"])
            if not rec["ok"]:
                raise RuntimeError(f"[dryrun] {rec['arch']}/{rec['shape']}: "
                                   f"{rec['error']}")
    say("dryrun", part="process", cells=n_cells, wall_s=wall)

    # (b) the dry run against the real step on the card, in a process of
    # its own too (its fake process group must not meet a real one)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c",
         "import json; from repro_torch.launch import dryrun; "
         "print(json.dumps(dryrun.hold_against_real_step("
         f"'tinyllama-1.1b', batch={DRYRUN_B}, seq={DRYRUN_S})))"],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"[dryrun] (b): exit {proc.returncode}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    say("dryrun", part="against-the-card", arch="tinyllama-1.1b-f32",
        batch=DRYRUN_B, seq=DRYRUN_S, **r,
        flops_equal=r["dry_flops"] == r["real_flops"],
        argument_bytes_equal=(r["dry_argument_bytes"]
                              == r["real_argument_bytes"]),
        dry_peak_gib=round(r["dry_peak_bytes"] / 2**30, 3),
        real_peak_gib=round(r["real_peak_bytes"] / 2**30, 3),
        peak_ratio_dry_over_real=round(r["dry_peak_bytes"]
                                       / r["real_peak_bytes"], 4),
        seconds=round(time.perf_counter() - t0, 3))
    if (r["dry_flops"] != r["real_flops"]
            or r["dry_argument_bytes"] != r["real_argument_bytes"]):
        raise RuntimeError("[dryrun] (b): the dry run's FLOPs or argument "
                           "bytes differ from the real step's")
    say("dryrun", phase_s=round(time.perf_counter() - t_phase, 3))


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
    rows += phase_merge(torch, search_out["merge_launches"])
    t0 = time.perf_counter()
    rows.append(phase_pq_adc(rt, torch, ds, indexes))
    say("pq_adc", phase_s=round(time.perf_counter() - t0, 3))
    phase_io(rt, torch, ds, indexes)
    serve_out = phase_serve(rt, torch, ds, indexes)
    fleet_launches = phase_fleet(rt, torch, ds, indexes, search_out,
                                 serve_out["closed_qps"])
    phase_lm(rt, torch, ds, search_out)
    phase_train(torch)
    phase_mesh(torch)
    phase_dryrun(torch)
    for row in rows:
        if row["name"] == "fused_page_rank":
            row["serve_launches"] = serve_out["launches"]
            row["fleet_launches"] = fleet_launches
    say("done", phases_s=round(time.perf_counter() - t_all, 3),
        peak_device_gib=round(max(PEAKS + [torch.cuda.max_memory_allocated()])
                              / 2**30, 3),
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
