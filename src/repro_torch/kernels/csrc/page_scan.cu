// page_scan: exact squared L2 from every record of each scheduled page to
// every query, out (W, n_p, Q) f32 = |x|^2 - 2 x.q + |q|^2.
//
// Replaces the Pallas kernel `page_scan` in src/repro/kernels/page_scan.py.
//
// Bound on an H100 at the main path's shapes (W = 256 scheduled pages,
// n_p = 6, d = 96, Q = 256, f32): it moves about 2.3 MB (the scheduled page
// tiles 0.59 MB, the queries 0.1 MB, the output 1.57 MB), 0.7 us at
// 3.35 TB/s, and does 2 W n_p Q d = 75.5 MFLOP, 1.1 us at the 67 TFLOP/s of
// f32 outside the tensor cores. So it is bound by operations, and only just.
//
// Design: one block per (scheduled page, tile of 128 queries). The block
// reads its own page id, stages the (n_p, d) tile in shared memory once,
// computes each record's |x|^2 there, and gives each thread one query, so
// the stores along Q are coalesced. The query tile comes in through shared
// memory 32 columns at a time. Plain loads; no cp.async/TMA ring yet, and no
// tensor cores: a page is only n_p rows, fewer than wgmma's 64.
#include "common.cuh"

using namespace repro_torch;

template <typename T>
__global__ void page_scan_kernel(const T* __restrict__ pages,
                                 const int* __restrict__ page_ids,
                                 const T* __restrict__ q,
                                 const float* __restrict__ qsq,
                                 float* __restrict__ out, int n_p, int d,
                                 int Q) {
  extern __shared__ float smem[];
  float* xs = smem;                 // n_p * d
  float* x2 = xs + n_p * d;         // n_p
  float* qs = x2 + n_p;             // DC * (QT + 1)
  const int w = blockIdx.x;
  stage_page(pages, page_ids[w], n_p, d, xs, x2);
  exact_tile(xs, x2, q, qsq, qs, out, w, n_p, d, Q);
}

template <typename T>
static int launch(const void* pages, const void* page_ids, const void* q,
                  const void* qsq, void* out, int W, int n_p, int d, int Q,
                  void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(n_p) * d + n_p +
                                       DC * (QT + 1));
  cudaError_t err = allow_smem(page_scan_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(W, (Q + QT - 1) / QT);
  page_scan_kernel<T><<<grid, QT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pages), static_cast<const int*>(page_ids),
      static_cast<const T*>(q), static_cast<const float*>(qsq),
      static_cast<float*>(out), n_p, d, Q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int page_scan_f32(const void* pages, const void* page_ids,
                             const void* q, const void* qsq, void* out, int W,
                             int n_p, int d, int Q, void* stream) {
  return launch<float>(pages, page_ids, q, qsq, out, W, n_p, d, Q, stream);
}

extern "C" int page_scan_bf16(const void* pages, const void* page_ids,
                              const void* q, const void* qsq, void* out, int W,
                              int n_p, int d, int Q, void* stream) {
  return launch<__nv_bfloat16>(pages, page_ids, q, qsq, out, W, n_p, d, Q,
                               stream);
}
