// pq_adc: the ADC lookup-table scan of the memory-layout PQ filter (paper
// §4.1.1), out (n_out,) f32 with out[i] = sum_j lut[j, codes[i, j]] for
// i < nvalid and +inf for every row at or past nvalid.
//
// Replaces the Pallas kernel `pq_adc` in src/repro/kernels/pq_adc.py.
//
// Rows past the n_rows rows of `codes` (up to n_out) are the zero-code pad
// rows of the reference's padded buffer: they are never read, and score
// sum_j lut[j, 0] if nvalid reaches them, +inf otherwise. So the wrappers
// pad by length without copying the codes.
//
// Supported: 1 <= M <= 64 subspaces (a 64 KB LUT in shared memory; the
// reference's sweeps use 8, 16 and 32), n_out < 2^30.
//
// Bound on an H100 at the smoke's shape (N = 1,000,000, M = 16): it moves
// 16 MB of codes in and 4 MB of distances out, about 6.0 us at 3.35 TB/s,
// and does 16 M additions, 0.24 us at the f32 peak. So it is bound by bytes.
// The 16 M lookups at 32 a clock per SM with no bank conflicts would take
// about 1.9 us; random codes make lookups of one subspace from one warp
// collide on banks (code % 32), about 3.5-way at worst on average for 32
// random codes, which may bring the lookups near the memory bound.
//
// Design: the TPU kernel turned each subspace into a one-hot matmul because
// the TPU gathers poorly; here the (M, 256) LUT is staged once per block in
// shared memory and each thread gathers from it directly. Each thread owns a
// row: it reads the row's M code bytes (16-byte vector loads when M % 16 == 0
// and the codes are 16-byte aligned, so a warp reads 512 contiguous bytes at
// M = 16), sums the M lookups in j order, and writes one coalesced f32. The
// grid is capped at the blocks the card holds at once and strides over the
// rows, so the LUT is staged a few hundred times, not once per 512 rows.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MAX_M = 64;

template <bool VEC16>
__global__ void __launch_bounds__(THREADS)
pq_adc_kernel(const uint8_t* __restrict__ codes,
              const float* __restrict__ lut, float* __restrict__ out,
              int n_rows, int nvalid, int n_out, int M) {
  extern __shared__ float s_lut[];  // M * 256
  for (int i = threadIdx.x; i < M * 256; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < n_out;
       row += stride) {
    if (row >= nvalid) {
      out[row] = CUDART_INF_F;
      continue;
    }
    float acc = 0.f;
    if (row < n_rows) {
      const uint8_t* c = codes + static_cast<size_t>(row) * M;
      if (VEC16) {
        for (int j0 = 0; j0 < M; j0 += 16) {
          const uint4 v = *reinterpret_cast<const uint4*>(c + j0);
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const int code = (w[k >> 2] >> (8 * (k & 3))) & 0xff;
            acc += s_lut[(j0 + k) * 256 + code];
          }
        }
      } else {
        for (int j = 0; j < M; ++j) acc += s_lut[j * 256 + c[j]];
      }
    } else {
      for (int j = 0; j < M; ++j) acc += s_lut[j * 256];  // zero-code pad
    }
    out[row] = acc;
  }
}

// Blocks of `kernel` the whole card holds at once with `smem` bytes each.
template <typename K>
cudaError_t resident_blocks(K kernel, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <bool VEC16>
int launch(const void* codes, const void* lut, void* out, int n_rows,
           int nvalid, int n_out, int M, void* stream) {
  if (M < 1 || M > MAX_M || n_out < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 256 * static_cast<size_t>(M);
  cudaError_t err = repro_torch::allow_smem(pq_adc_kernel<VEC16>, smem);
  // the card's capacity for each M, found once (the process runs one kind
  // of card)
  static int cap[MAX_M + 1] = {0};
  if (err == cudaSuccess && cap[M] == 0)
    err = resident_blocks(pq_adc_kernel<VEC16>, smem, &cap[M]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int need = (n_out + THREADS - 1) / THREADS;
  const int grid = need < cap[M] ? need : cap[M];
  pq_adc_kernel<VEC16><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(lut),
      static_cast<float*>(out), n_rows, nvalid, n_out, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec16 != 0 asks for the 16-byte code loads: the caller guarantees
// M % 16 == 0 and a 16-byte aligned `codes`.
extern "C" int pq_adc_f32(const void* codes, const void* lut, void* out,
                          int n_rows, int nvalid, int n_out, int M, int vec16,
                          void* stream) {
  return vec16 ? launch<true>(codes, lut, out, n_rows, nvalid, n_out, M, stream)
               : launch<false>(codes, lut, out, n_rows, nvalid, n_out, M, stream);
}
