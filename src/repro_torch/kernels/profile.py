"""Where the page kernels' device time goes, on the card.

    python -m repro_torch.kernels.profile              # the kernels of csrc/
    python -m repro_torch.kernels.profile --width 8    # 8 scheduled pages
    python -m repro_torch.kernels.profile --earlier DIR

Two measurements at the smoke's shape (W = 256 scheduled pages of a
166,667-page index, n_p = 6, d = 96, M = 16, Q = 256, f32; random data
from a seed):

- parts: variants of a kernel with parts taken out (a text patch of its
  source each), built with nvcc beside the kernel itself and timed by
  CUDA-graph replay, with the full-f32 `addmm` that computes page_scan's
  function beside them. The difference between two variants is what the
  part costs.
- phases: thread 0 of each block writes %globaltimer and clock64 at the
  boundaries of the exact half's phases (and after the ADC half in
  fused_page_rank); the medians over the blocks of each phase's clocks.

`--earlier DIR` times the earlier one-block-per-page design instead (its
csrc/ directory, as `git archive f26a36d src/repro_torch/kernels/csrc`
unpacks it): its query staging, FMA loop, stores and page loads taken out
one at a time. Nothing here is used by the kernels; a patch whose anchor
is missing raises, so the tool follows the sources it was written for.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.timing import graph_ms

P, N_P, D, W, Q, M = 166_667, 6, 96, 256, 256, 16

EXACT_CALL = "exact_tile<T, VEC>(pages, q, out, rows, d, Q, t, [] {}, [] {});"
NOSTORE = [("common.cuh", "      if (q0 + ql < Q)\n",
            "      if (q0 + ql < Q && v[h] == 12345.f)\n")]
NOFMA = [("common.cuh", "    for (int k = 4 * g; k < kc4; k += 4 * KS) {",
          "    for (int k = kc4; k < kc4; k += 4 * KS) {")]
NONORM = [("common.cuh", "    add_norms(kc4, t);\n", "")]
# page_scan of csrc/, cumulatively: what each line adds to the one above
PARTS = {
    "launch and schedule lookup": [
        ("page_scan.cu", EXACT_CALL,
         "__syncthreads();\n  if (t.row[0] == -7) out[0] = 1.f;")],
    "+ staging": NOSTORE + NOFMA + NONORM,
    "+ norms": NOSTORE + NOFMA,
    "+ FMAs": NOSTORE,
    "+ reduction and stores (the kernel)": [],
}
# the earlier design's page_scan, each line one part taken out
EARLIER = {
    "the kernel": [],
    "no global loads in the query staging": [(
        "common.cuh",
        "? to_f32(q[static_cast<size_t>(qq) * d + dd]) : 0.f;",
        "? 1e-3f * (qq + dd) : 0.f;")],
    "the query tile staged once": [
        ("common.cuh",
         "      __syncthreads();\n      for (int i = t; i < QT * DC;",
         "      if (c0 == 0 && r0 == 0) {\n      __syncthreads();\n"
         "      for (int i = t; i < QT * DC;"),
        ("common.cuh", "      __syncthreads();\n      const int kc =",
         "      __syncthreads();\n      }\n      const int kc =")],
    "no FMA loop": [("common.cuh", "      for (int k = 0; k < kc; ++k) {",
                     "      for (int k = 0; k < 0; ++k) {")],
    "no stores": [("common.cuh", "        if (r < n_p)\n          out[",
                   "        if (r < n_p && acc[j] == 1234.5f)\n          out[")],
    "no page loads": [("common.cuh", "xs[i] = to_f32(src[i]);",
                       "xs[i] = 1e-3f * i + pid;")],
    "launch only": [(
        "page_scan.cu",
        "  stage_page(pages, page_ids[w], n_p, d, xs, x2);\n"
        "  exact_tile(xs, x2, q, qsq, qs, out, w, n_p, d, Q);",
        "  if (page_ids[w] < 0) out[0] = 1.f;")],
}

STAMP = """
__device__ unsigned long long g_stamp[4096 * 16];
__device__ long long g_clk[4096 * 16];
#define STAMP(n) if (threadIdx.x == 0) { \\
  unsigned long long gt_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt_)); \\
  const int at_ = (blockIdx.y * gridDim.x + blockIdx.x) * 16 + (n); \\
  g_stamp[at_] = gt_; g_clk[at_] = clock64(); }
"""
READ = """
extern "C" int read_stamps(void* gt, void* clk) {
  cudaMemcpyFromSymbol(gt, g_stamp, sizeof(g_stamp));
  return static_cast<int>(cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk)));
}
"""
PHASES = ["entry", "schedule looked up", "query copies issued",
          "rows visible", "row copies issued", "copies landed", "norms",
          "FMAs", "all FMAs done", "partials written", "stores", "ADC"]
CLOCKS = [
    ("common.cuh", "#include <stdint.h>\n", "#include <stdint.h>\n" + STAMP),
    ("common.cuh", "  float acc[ER][EQ] = {};\n",
     "  STAMP(1)\n  float acc[ER][EQ] = {};\n"),
    ("common.cuh", "    if (c0 == 0) __syncthreads();           // the rows",
     "    STAMP(2)\n    if (c0 == 0) __syncthreads();           // the rows"),
    ("common.cuh", "    for (int k0 = 0; k0 < kc4; k0 += SC)\n"
     "      stage<T, VEC>(BR, record",
     "    STAMP(3)\n    for (int k0 = 0; k0 < kc4; k0 += SC)\n"
     "      stage<T, VEC>(BR, record"),
    ("common.cuh", "    if (c0 == 0) staged();\n",
     "    if (c0 == 0) staged();\n    STAMP(4)\n"),
    ("common.cuh", "    cp_async_wait_all();\n    __syncthreads();\n",
     "    cp_async_wait_all();\n    __syncthreads();\n    STAMP(5)\n"),
    ("common.cuh", "    add_norms(kc4, t);\n",
     "    add_norms(kc4, t);\n    STAMP(6)\n"),
    ("common.cuh", "  __syncthreads();              // every read",
     "  STAMP(7)\n  __syncthreads();              // every read"),
    ("common.cuh", "  float* mine = t.part", "  STAMP(8)\n  float* mine = t.part"),
    ("common.cuh", "  __syncthreads();\n  // Thread (g, lt) finishes",
     "  __syncthreads();\n  STAMP(9)\n  // Thread (g, lt) finishes"),
    ("common.cuh", "  }\n}\n\n// Stage the block's (BR, M) code tile",
     "  }\n  STAMP(10)\n}\n\n// Stage the block's (BR, M) code tile"),
    ("page_scan.cu", "  const Tile t = carve(smem, tile_cols(d));\n",
     "  const Tile t = carve(smem, tile_cols(d));\n  STAMP(0)\n"),
    ("fused_page_rank.cu", "  const Tile t = carve(smem, tile_cols(d));\n",
     "  const Tile t = carve(smem, tile_cols(d));\n  STAMP(0)\n"),
    ("fused_page_rank.cu", "  adc.finish(out_adc, rows);\n",
     "  adc.finish(out_adc, rows);\n  STAMP(11)\n"),
]


def _build_variants(csrc: Path, jobs: dict, out: Path) -> dict:
    """Patch and compile each (name -> (kernel, patches, read)) at once;
    returns name -> loaded library."""
    procs = {}
    for i, (name, (kernel, patches, read)) in enumerate(jobs.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        files = {f: (csrc / f).read_text()
                 for f in ("common.cuh", f"{kernel}.cu")}
        for f, old, new in patches:
            if f not in files:
                continue
            if old not in files[f]:
                raise RuntimeError(f"{name}: no anchor {old!r} in {f}")
            files[f] = files[f].replace(old, new)
        if read:
            files[f"{kernel}.cu"] += READ
        for f, text in files.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / f"{kernel}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"v{i}" / "lib.so"))
    return libs


def _inputs():
    g = torch.Generator(device="cuda").manual_seed(0)
    pages = torch.randn((P, N_P, D), device="cuda", generator=g)
    codes = torch.randint(0, 256, (P, N_P, M), device="cuda", generator=g,
                          dtype=torch.uint8)
    ids = torch.randint(0, P, (W,), device="cuda", generator=g,
                        dtype=torch.int32)
    q = torch.randn((Q, D), device="cuda", generator=g)
    lut = torch.rand((M, 256, Q), device="cuda", generator=g)
    return pages, codes, ids, q, lut


def _caller(lib, kernel: str, x, earlier: bool):
    pages, codes, ids, q, lut, qsq, out, out2 = x
    v = ctypes.c_void_p

    def stream():
        return v(torch.cuda.current_stream().cuda_stream)
    if kernel == "page_scan" and earlier:
        return lambda: lib.page_scan_f32(
            v(pages.data_ptr()), v(ids.data_ptr()), v(q.data_ptr()),
            v(qsq.data_ptr()), v(out.data_ptr()), W, N_P, D, Q, stream())
    if kernel == "page_scan":
        return lambda: lib.page_scan_f32(
            v(pages.data_ptr()), v(ids.data_ptr()), v(q.data_ptr()),
            v(out.data_ptr()), W, N_P, D, Q, stream())
    return lambda: lib.fused_page_rank_f32(
        v(pages.data_ptr()), v(codes.data_ptr()), v(ids.data_ptr()),
        v(q.data_ptr()), v(lut.data_ptr()), v(out.data_ptr()),
        v(out2.data_ptr()), W, N_P, D, M, Q, stream())


def main() -> int:
    global W
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier", type=Path, default=None,
                    help="csrc/ of the earlier design: time its parts")
    ap.add_argument("--width", type=int, default=W,
                    help="scheduled pages W (the smoke's is 256)")
    args = ap.parse_args()
    W = args.width
    if not torch.cuda.is_available():
        print("profile: no CUDA device; this runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    earlier = args.earlier is not None
    csrc = args.earlier if earlier else _build.CSRC
    if earlier:
        jobs = {n: ("page_scan", p, False) for n, p in EARLIER.items()}
    else:
        jobs = {n: ("page_scan", p, False) for n, p in PARTS.items()}
        jobs["clocks: page_scan"] = ("page_scan", CLOCKS, True)
        jobs["clocks: fused_page_rank"] = ("fused_page_rank", CLOCKS, True)
    libs = _build_variants(csrc, jobs, _build.BUILD_DIR / "profile")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    pages, codes, ids, q, lut = _inputs()
    qsq = (q * q).sum(-1)
    out = torch.empty((W, N_P, Q), device="cuda")
    x = (pages, codes, ids, q, lut, qsq, out, torch.empty_like(out))
    rows = pages[ids.long()].reshape(-1, D)
    norms = (rows * rows).sum(-1)[:, None] + qsq[None, :]
    q_t = q.t()
    timed = {n: _caller(libs[n], jobs[n][0], x, earlier)
             for n in jobs if not n.startswith("clocks")}
    timed["torch.addmm (full f32), the yardstick"] = (
        lambda: torch.addmm(norms, rows, q_t, alpha=-2.0))
    print("[parts] graph-replayed device us, two rounds")
    res = {n: [] for n in timed}
    for _ in range(2):
        for n, fn in timed.items():
            res[n].append(graph_ms(fn, 200) * 1e3)
    for n, us in res.items():
        print(f"  {n:44s} " + " ".join(f"{u:8.3f}" for u in us))
    for n in [n for n in jobs if n.startswith("clocks")]:
        kernel = jobs[n][0]
        fn = _caller(libs[n], kernel, x, False)
        us = graph_ms(fn, 200) * 1e3
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        gt = np.zeros(4096 * 16, np.uint64)
        clk = np.zeros(4096 * 16, np.int64)
        libs[n].read_stamps(ctypes.c_void_p(gt.ctypes.data),
                            ctypes.c_void_p(clk.ctypes.data))
        blocks = ((W * N_P + 47) // 48) * ((Q + 63) // 64)
        gt = gt[:blocks * 16].reshape(blocks, 16).astype(np.int64)
        clk = clk[:blocks * 16].reshape(blocks, 16)
        last = 11 if kernel == "fused_page_rank" else 10
        span = gt[:, last].max() - gt[:, 0].min()
        print(f"[phases] {kernel}: {us:.3f} us a launch with the clocks in, "
              f"{span} ns from the first block's entry to the last one's "
              f"end; medians over {blocks} blocks")
        for i in range(1, last + 1):
            cyc = np.median(clk[:, i] - clk[:, i - 1])
            ns = np.median(gt[:, i] - gt[:, i - 1])
            print(f"  {PHASES[i - 1]:>20s} -> {PHASES[i]:<20s} "
                  f"{cyc:8.0f} cycles {ns:7.0f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
