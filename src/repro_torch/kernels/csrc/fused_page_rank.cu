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
// by bytes. In practice it takes page_scan's time (common.cuh) plus what
// the ADC gathers add: one float4 of the L2-resident LUT per (record,
// subspace, 4 queries), 25.2 MB of L2 reads at that shape for 4.19 MB of
// distinct LUT.
//
// Design: page_scan's block (48 stacked records x 64 queries, common.cuh)
// with the records' (48, M) code tile staged beside the vector rows. The
// exact half is page_scan's routine, so the two kernels' exact outputs
// agree bit for bit. The ADC half reuses the block's rows and queries: a
// thread gathers one float4 of LUT along Q for each of its 3 records and
// subspace, and these gathers run inside the exact half's column loop,
// 3 subspaces a step, added one step after they are issued, so they are
// in flight while the FMAs run. The sums take page_adc's order, so the
// ADC output equals page_adc's bit for bit. Staging LUT slices in shared
// memory would not cut the L2 bytes: a block's 48 records use about 17% of
// the 256 codes of a subspace, and a slice for its 64 queries is 1 MB.
#include "common.cuh"

using namespace repro_torch;

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_page_rank_kernel(const T* __restrict__ pages,
                       const uint8_t* __restrict__ codes,
                       const int* __restrict__ page_ids,
                       const T* __restrict__ q,
                       const float* __restrict__ lut_t,
                       float* __restrict__ out_exact,
                       float* __restrict__ out_adc, int rows, int n_p, int d,
                       int M, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = carve(smem, tile_cols(d));
  find_rows(page_ids, n_p, rows, t);
  // the code tile is copied beside the first round of vector rows and is
  // waited for and published with them; the ADC gathers then run inside
  // the exact half's column loop
  AdcPipe<VEC, 3> adc(lut_t, t, M, Q);
  exact_tile<T, VEC>(pages, q, out_exact, rows, d, Q, t,
                     [&] { stage_codes(codes, M, t); }, [&] { adc.step(); });
  adc.finish(out_adc, rows);
}

template <typename T>
static int launch(const void* pages, const void* codes, const void* page_ids,
                  const void* q, const void* lut_t, void* out_exact,
                  void* out_adc, int W, int n_p, int d, int M, int Q,
                  void* stream) {
  const size_t smem = tile_bytes(tile_cols(d), M);
  const int rows = W * n_p;
  const bool vec = (d * sizeof(T)) % 16 == 0 && Q % 4 == 0 &&
                   aligned16(pages) && aligned16(q) && aligned16(lut_t) &&
                   aligned16(out_exact) && aligned16(out_adc);
  auto args = [&](auto kernel) {
    return launch_tiles(kernel, smem, rows, Q, stream,
                        static_cast<const T*>(pages),
                        static_cast<const uint8_t*>(codes),
                        static_cast<const int*>(page_ids),
                        static_cast<const T*>(q),
                        static_cast<const float*>(lut_t),
                        static_cast<float*>(out_exact),
                        static_cast<float*>(out_adc), rows, n_p, d, M, Q);
  };
  return vec ? args(fused_page_rank_kernel<T, true>)
             : args(fused_page_rank_kernel<T, false>);
}

extern "C" int fused_page_rank_f32(const void* pages, const void* codes,
                                   const void* page_ids, const void* q,
                                   const void* lut_t, void* out_exact,
                                   void* out_adc, int W, int n_p, int d,
                                   int M, int Q, void* stream) {
  return launch<float>(pages, codes, page_ids, q, lut_t, out_exact, out_adc,
                       W, n_p, d, M, Q, stream);
}

extern "C" int fused_page_rank_bf16(const void* pages, const void* codes,
                                    const void* page_ids, const void* q,
                                    const void* lut_t, void* out_exact,
                                    void* out_adc, int W, int n_p, int d,
                                    int M, int Q, void* stream) {
  return launch<__nv_bfloat16>(pages, codes, page_ids, q, lut_t, out_exact,
                               out_adc, W, n_p, d, M, Q, stream);
}

// Dynamic shared memory of one block for width d and M subspaces.
extern "C" int fused_page_rank_smem(int d, int M) {
  return static_cast<int>(tile_bytes(tile_cols(d), M));
}
