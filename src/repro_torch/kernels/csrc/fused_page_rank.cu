// fused_page_rank: page_scan's exact distances and page_adc's ADC distances
// of the same scheduled pages in one pass, out (exact, adc) each
// (W, n_p, Q) f32.
//
// Replaces the Pallas kernel `fused_page_rank` in
// src/repro/kernels/fused_search.py.
//
// Bound on an H100 at the main path's shapes (W = 256, n_p = 6, d = 96,
// M = 16, Q = 256, f32): it moves about 8.0 MB (the LUT 4.19 MB, the two
// outputs 3.15 MB, the page tiles 0.59 MB, the queries 0.1 MB), 2.4 us at
// 3.35 TB/s, against 82 MFLOP, 1.2 us at 67 TFLOP/s of f32. So it is bound
// by bytes: the outputs and the LUT, not the pages.
//
// Design: one block per (scheduled page, tile of 128 queries) stages the
// vector tile and the code tile once and writes both outputs from them,
// where the split pair reads its page id, and launches, twice. The exact
// half is page_scan's (shared-memory tile, one query per thread, coalesced
// stores), the ADC half is page_adc's (direct gathers from the (M, 256, Q),
// L2-resident LUT). Plain loads; the Pallas double buffer becomes a
// cp.async/TMA ring in a later change.
#include "common.cuh"

using namespace repro_torch;

template <typename T>
__global__ void fused_page_rank_kernel(const T* __restrict__ pages,
                                       const uint8_t* __restrict__ codes,
                                       const int* __restrict__ page_ids,
                                       const T* __restrict__ q,
                                       const float* __restrict__ qsq,
                                       const float* __restrict__ lut_t,
                                       float* __restrict__ out_exact,
                                       float* __restrict__ out_adc, int n_p,
                                       int d, int M, int Q) {
  extern __shared__ float smem[];
  float* xs = smem;                                  // n_p * d
  float* x2 = xs + n_p * d;                          // n_p
  float* qs = x2 + n_p;                              // DC * (QT + 1)
  int* cs = reinterpret_cast<int*>(qs + DC * (QT + 1));  // n_p * M
  const int w = blockIdx.x;
  const int pid = page_ids[w];
  stage_codes(codes, pid, n_p, M, cs);
  stage_page(pages, pid, n_p, d, xs, x2);   // its barriers publish cs too
  exact_tile(xs, x2, q, qsq, qs, out_exact, w, n_p, d, Q);
  adc_tile(cs, lut_t, out_adc, w, n_p, M, Q);
}

template <typename T>
static int launch(const void* pages, const void* codes, const void* page_ids,
                  const void* q, const void* qsq, const void* lut_t,
                  void* out_exact, void* out_adc, int W, int n_p, int d,
                  int M, int Q, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(n_p) * d + n_p +
                                       DC * (QT + 1)) +
                      sizeof(int) * static_cast<size_t>(n_p) * M;
  cudaError_t err = allow_smem(fused_page_rank_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(W, (Q + QT - 1) / QT);
  fused_page_rank_kernel<T>
      <<<grid, QT, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(pages), static_cast<const uint8_t*>(codes),
          static_cast<const int*>(page_ids), static_cast<const T*>(q),
          static_cast<const float*>(qsq), static_cast<const float*>(lut_t),
          static_cast<float*>(out_exact), static_cast<float*>(out_adc), n_p, d,
          M, Q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_page_rank_f32(const void* pages, const void* codes,
                                   const void* page_ids, const void* q,
                                   const void* qsq, const void* lut_t,
                                   void* out_exact, void* out_adc, int W,
                                   int n_p, int d, int M, int Q,
                                   void* stream) {
  return launch<float>(pages, codes, page_ids, q, qsq, lut_t, out_exact,
                       out_adc, W, n_p, d, M, Q, stream);
}

extern "C" int fused_page_rank_bf16(const void* pages, const void* codes,
                                    const void* page_ids, const void* q,
                                    const void* qsq, const void* lut_t,
                                    void* out_exact, void* out_adc, int W,
                                    int n_p, int d, int M, int Q,
                                    void* stream) {
  return launch<__nv_bfloat16>(pages, codes, page_ids, q, qsq, lut_t,
                               out_exact, out_adc, W, n_p, d, M, Q, stream);
}
