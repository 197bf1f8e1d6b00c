// page_adc: each query's ADC distance to every record of each scheduled
// page, out (W, n_p, Q) f32 = sum_j lut[q, j, code[r, j]].
//
// Replaces the Pallas kernel `page_adc` in src/repro/kernels/fused_search.py
// (the ADC half of `fused_page_rank`, run alone).
//
// Bound on an H100 at the main path's shapes (W = 256, n_p = 6, M = 16,
// Q = 256): it moves about 5.8 MB (the LUT 4.19 MB, the output 1.57 MB, the
// scheduled code tiles 25 KB), 1.7 us at 3.35 TB/s, and does only
// W n_p Q M = 6.3 M additions. So it is bound by bytes, and the LUT is
// most of them; in practice by the 25.2 MB of L2 gathers below.
//
// Design: the TPU kernel turned each lookup into a one-hot matmul because
// gathers are weak on its vector unit; here each thread gathers its LUT
// entries directly. The LUT comes laid out (M, 256, Q) (query_luts builds
// it so), so for one (subspace, code) a thread reads its 4 queries as one
// float4 and 16 threads read 256 contiguous bytes; the 4 MB LUT stays in
// the 50 MB L2 across the blocks. The block is fused_page_rank's (48
// stacked records x 64 queries, common.cuh), with only the (48, M) code
// tile staged; a thread issues the gathers of 16 subspaces before it adds
// them, so they are in flight together.
#include "common.cuh"

using namespace repro_torch;

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
page_adc_kernel(const uint8_t* __restrict__ codes,
                const int* __restrict__ page_ids,
                const float* __restrict__ lut_t, float* __restrict__ out,
                int rows, int n_p, int M, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = carve(smem, 0);
  find_rows(page_ids, n_p, rows, t);
  __syncthreads();
  stage_codes(codes, M, t);
  cp_async_wait_all();
  __syncthreads();
  AdcPipe<VEC, 16>(lut_t, t, M, Q).finish(out, rows);
}

extern "C" int page_adc_f32(const void* codes, const void* page_ids,
                            const void* lut_t, void* out, int W, int n_p,
                            int M, int Q, void* stream) {
  const size_t smem = tile_bytes(0, M);
  const int rows = W * n_p;
  const bool vec = Q % 4 == 0 && aligned16(lut_t) && aligned16(out);
  auto args = [&](auto kernel) {
    return launch_tiles(kernel, smem, rows, Q, stream,
                        static_cast<const uint8_t*>(codes),
                        static_cast<const int*>(page_ids),
                        static_cast<const float*>(lut_t),
                        static_cast<float*>(out), rows, n_p, M, Q);
  };
  return vec ? args(page_adc_kernel<true>) : args(page_adc_kernel<false>);
}

// Dynamic shared memory of one block for M subspaces.
extern "C" int page_adc_smem(int M) {
  return static_cast<int>(tile_bytes(0, M));
}
