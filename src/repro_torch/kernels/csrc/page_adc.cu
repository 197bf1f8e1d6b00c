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
// most of them.
//
// Design: the TPU kernel turned each lookup into a one-hot matmul because
// gathers are weak on its vector unit; here each thread gathers its LUT
// entries directly. The LUT comes laid out (M, 256, Q) (query_luts builds
// it so), so for one (subspace, code) the 32 threads of a warp read 32
// consecutive queries: every gather is one coalesced row, and the 4 MB LUT
// stays in the 50 MB L2 across the blocks. One block per (scheduled page,
// tile of 128 queries); the block stages its (n_p, M) code tile in shared
// memory.
#include "common.cuh"

using namespace repro_torch;

__global__ void page_adc_kernel(const uint8_t* __restrict__ codes,
                                const int* __restrict__ page_ids,
                                const float* __restrict__ lut_t,
                                float* __restrict__ out, int n_p, int M,
                                int Q) {
  extern __shared__ int cs[];       // n_p * M
  const int w = blockIdx.x;
  stage_codes(codes, page_ids[w], n_p, M, cs);
  __syncthreads();
  adc_tile(cs, lut_t, out, w, n_p, M, Q);
}

extern "C" int page_adc_f32(const void* codes, const void* page_ids,
                            const void* lut_t, void* out, int W, int n_p,
                            int M, int Q, void* stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(n_p) * M;
  cudaError_t err = allow_smem(page_adc_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(W, (Q + QT - 1) / QT);
  page_adc_kernel<<<grid, QT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(page_ids),
      static_cast<const float*>(lut_t), static_cast<float*>(out), n_p, M, Q);
  return static_cast<int>(cudaGetLastError());
}
