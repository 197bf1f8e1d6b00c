// Shared pieces of the page kernels: element loads, block shape, and the
// shared-memory opt-in every launcher applies before it launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Queries handled by one block: one thread per query, so every output store
// (out[w, r, q0 + t]) is one coalesced 512-byte row per warp group.
constexpr int QT = 128;
// Feature columns of the query tile staged in shared memory at a time.
constexpr int DC = 32;
// Records of a page scored per pass (accumulators held in registers).
constexpr int RC = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Dynamic shared memory above the 48 KB default needs an explicit opt-in.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Stage page `pid`'s (n_p, d) vector tile into xs as f32 and write each
// record's squared norm into x2. Called by all threads of the block.
template <typename T>
__device__ void stage_page(const T* __restrict__ pages, int pid, int n_p,
                           int d, float* xs, float* x2) {
  const T* src = pages + static_cast<size_t>(pid) * n_p * d;
  for (int i = threadIdx.x; i < n_p * d; i += blockDim.x) xs[i] = to_f32(src[i]);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < n_p; r += nwarps) {
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s += xs[r * d + k] * xs[r * d + k];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) x2[r] = s;
  }
  __syncthreads();
}

// exact[w, r, q] = x2[r] - 2 x_r . q + qsq[q] for every record r of the
// staged tile and this block's QT queries. The query tile is staged
// DC columns at a time, transposed and padded to QT + 1 so that neither
// the staging writes nor the per-thread reads conflict on a bank.
template <typename T>
__device__ void exact_tile(const float* xs, const float* x2,
                           const T* __restrict__ q,
                           const float* __restrict__ qsq, float* qs,
                           float* __restrict__ out, int w, int n_p, int d,
                           int Q) {
  const int t = threadIdx.x;
  const int q0 = blockIdx.y * QT;
  const int qi = q0 + t;
  for (int r0 = 0; r0 < n_p; r0 += RC) {
    float acc[RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += DC) {
      __syncthreads();
      for (int i = t; i < QT * DC; i += blockDim.x) {
        const int tq = i / DC, k = i % DC;
        const int qq = q0 + tq, dd = c0 + k;
        qs[k * (QT + 1) + tq] =
            (qq < Q && dd < d) ? to_f32(q[static_cast<size_t>(qq) * d + dd]) : 0.f;
      }
      __syncthreads();
      const int kc = min(DC, d - c0);
      for (int k = 0; k < kc; ++k) {
        const float qv = qs[k * (QT + 1) + t];
#pragma unroll
        for (int j = 0; j < RC; ++j) {
          const int r = r0 + j;
          if (r < n_p) acc[j] = fmaf(xs[r * d + c0 + k], qv, acc[j]);
        }
      }
    }
    if (qi < Q) {
      const float qq2 = qsq[qi];
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const int r = r0 + j;
        if (r < n_p)
          out[(static_cast<size_t>(w) * n_p + r) * Q + qi] = x2[r] - 2.f * acc[j] + qq2;
      }
    }
  }
}

// adc[w, r, q] = sum_j lut_t[j, code[r, j], q] for every record of the
// staged code tile. lut_t is (M, 256, Q): for a fixed (j, code) the threads
// of a warp read consecutive queries, so each gather is one coalesced row.
__device__ inline void adc_tile(const int* cs, const float* __restrict__ lut_t,
                                float* __restrict__ out, int w, int n_p, int M,
                                int Q) {
  const int qi = blockIdx.y * QT + threadIdx.x;
  if (qi >= Q) return;
  for (int r = 0; r < n_p; ++r) {
    float s = 0.f;
    for (int j = 0; j < M; ++j)
      s += __ldg(lut_t + (static_cast<size_t>(j) * 256 + cs[r * M + j]) * Q + qi);
    out[(static_cast<size_t>(w) * n_p + r) * Q + qi] = s;
  }
}

// Stage page `pid`'s (n_p, M) uint8 code tile into cs as ints.
__device__ inline void stage_codes(const uint8_t* __restrict__ codes, int pid,
                                   int n_p, int M, int* cs) {
  const uint8_t* src = codes + static_cast<size_t>(pid) * n_p * M;
  for (int i = threadIdx.x; i < n_p * M; i += blockDim.x) cs[i] = src[i];
}

}  // namespace repro_torch
