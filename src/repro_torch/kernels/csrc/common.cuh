// The tile that page_scan, fused_page_rank and page_adc share, and the
// pieces pq_adc uses too (element loads, the shared-memory opt-in).
//
// A block owns BR = 48 consecutive rows of the (W * n_p, Q) output, the
// records of the scheduled pages stacked in schedule order (8 pages at
// n_p = 6), and QT = 64 queries. At the smoke's shape (W = 256, n_p = 6,
// d = 96, Q = 256) the grid is 32 x 4 = 128 blocks, one wave on 132 SMs.
//
// The earlier design (one block per page and 128 queries) took 35 us
// there on an H100. Timing variants of it showed why: each of its 512
// blocks staged the query tile again, 25 MB of 4-byte loads through L2 for
// 0.1 MB of queries (about 16 us), and its inner loop made one
// shared-memory load per FMA (about 12 us). Here:
//
// - the query tile crosses L2 once per 48 rows, not once per 6, and rows
//   and queries come in by 16-byte cp.async; the queries' copies are
//   issued before the block knows its rows, so they overlap the schedule
//   lookup;
// - the columns are split among KS = 4 groups of 64 threads, and each
//   thread sums 6 rows x 8 queries in registers from float4 reads along d:
//   14 shared-memory loads feed 192 FMAs. The groups' sums meet in shared
//   memory at the end, in a fixed order;
// - |x|^2 and |q|^2 come from the staged tiles, so no pass before the
//   kernel computes the query norms.
//
// What bounds it at that shape (per-phase clocks of each block, on an
// H100): a launch and the schedule lookup (about 1.6 us, as for an empty
// kernel on the grid), the copies (about 1.4 us for the 43 KB a block
// takes in: what one SM takes in, not L2's bandwidth, since 4 blocks on
// the card take as long as 128), the FMAs (about 2 us, as much
// shared-memory traffic as FMA issue) and the reduction and stores (about
// 1 us). Neither bytes nor FLOPs at the spec peaks (0.7 and 1.1 us) come
// close.
//
// d is staged KC = 128 columns at a time, so any width fits in shared
// memory (d = 96 is one round). All arithmetic is f32 FFMA on the CUDA
// cores: TF32 would miss the exact distances' 1e-5 tolerance. The VEC
// instantiations take the 16-byte paths and need d * sizeof(T) % 16 == 0,
// Q % 4 == 0 and 16-byte aligned tensors; the launchers pick the scalar
// instantiations of the same code otherwise, which sum in the same order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int BR = 48;              // output rows (stacked records) per block
constexpr int QT = 64;              // queries per block
constexpr int KC = 128;             // columns of d staged per round
constexpr int SC = 32;              // columns a warp stages per row pass
constexpr int THREADS = 256;
// The exact half: KS groups of threads take every KS-th float4 of the
// columns each, and a thread of a group sums ER rows x EQ queries in
// registers: rows rg + ERG * i and queries qg + EQG * m of the tile.
constexpr int KS = 4;
constexpr int GT = THREADS / KS;    // threads of a group
constexpr int EQ = 2 * KS;          // queries per thread
constexpr int EQG = QT / EQ;        // query slots of a group
constexpr int ERG = GT / EQG;       // row slots of a group
constexpr int ER = BR / ERG;        // rows per thread
constexpr int PS = ER * EQ + 2;     // a thread's partial sums, padded
constexpr int NP = 4;               // threads summing each |x|^2 or |q|^2
// The ADC half: a thread sums RT rows x 4 queries, rows ty + TY * i.
constexpr int TX = QT / 4;          // threads along Q
constexpr int TY = THREADS / TX;    // threads along the rows
constexpr int RT = BR / TY;
static_assert(ER * ERG == BR && EQG * EQ == QT && KS * GT == THREADS &&
              EQG * ERG == GT && RT * TY == BR && TX * 4 == QT &&
              KC % SC == 0 && SC % 8 == 0 && NP * QT <= THREADS &&
              NP * BR <= THREADS, "tile does not divide");

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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Columns of the staged tiles: one round of d, rounded up to a float4.
__host__ __device__ inline int tile_cols(int d) {
  const int k = d < KC ? d : KC;
  return (k + 3) & ~3;
}

// The block's shared memory. xs and qs rows are padded by 4 floats, so
// that 8 neighbouring rows read at one column fall on 8 different groups
// of 4 banks. The groups' partial sums take their place once the columns
// are summed.
struct Tile {
  long long* row;   // BR: pid * n_p + record, or -1 past the schedule
  float* x2;        // NP x BR: partial sums of |x|^2
  float* qsq;       // NP x QT: partial sums of |q|^2
  float* xs;        // BR x stride
  float* qs;        // QT x stride
  float* part;      // THREADS x PS partial sums, over xs and qs
  uint8_t* cs;      // BR x M codes (ADC kernels)
  int stride;
};

// Floats of the region that holds xs and qs, then the partial sums; none
// for the kernels without an exact half (cols = 0).
__host__ __device__ inline int exact_floats(int cols) {
  const int staged = (BR + QT) * (cols + 4);
  return cols == 0 ? 0 : (staged > THREADS * PS ? staged : THREADS * PS);
}

__host__ __device__ inline size_t tile_bytes(int cols, int M) {
  return sizeof(long long) * BR + sizeof(float) * NP * (BR + QT) +
         sizeof(float) * static_cast<size_t>(exact_floats(cols)) +
         static_cast<size_t>(BR) * M;
}

__device__ inline Tile carve(unsigned char* smem, int cols) {
  Tile t;
  t.row = reinterpret_cast<long long*>(smem);
  t.x2 = reinterpret_cast<float*>(t.row + BR);
  t.qsq = t.x2 + NP * BR;
  t.xs = t.qsq + NP * QT;                          // 16-byte aligned
  t.stride = cols + 4;
  t.qs = t.xs + BR * t.stride;
  t.part = t.xs;
  t.cs = reinterpret_cast<uint8_t*>(t.xs + exact_floats(cols));
  return t;
}

// Look up the block's rows in the schedule and zero the norms. The caller
// publishes them with a barrier.
__device__ inline void find_rows(const int* __restrict__ page_ids, int n_p,
                                 int rows, Tile t) {
  const int r0 = blockIdx.x * BR;
  for (int i = threadIdx.x; i < BR; i += THREADS) {
    const int r = r0 + i;
    t.row[i] = r < rows
        ? static_cast<long long>(page_ids[r / n_p]) * n_p + r % n_p : -1;
  }
  for (int i = threadIdx.x; i < NP * (BR + QT); i += THREADS) t.x2[i] = 0.f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 16 bytes of global memory, 8 bf16, as f32.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Stage columns [k0, k1) (at most SC, global columns c0 + k) of n rows into
// dst (n x stride, f32): row r comes from src(r), or is zero where that is
// null; columns at or past kc are zero. A thread takes one 16-byte unit
// (VEC) or one element of a row and strides over the rows, so its
// addresses cost a few integer operations and no division. The 16-byte
// paths take k0, k1 and kc as multiples of 16 / sizeof(T); f32 goes by
// cp.async, which the caller waits for, and zero-fills from `base`, any
// valid address.
template <typename T, bool VEC, typename Src>
__device__ void stage(int n, Src src, const T* base, int c0, int k0, int k1,
                      int kc, float* dst, int stride) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  constexpr int UNITS = SC / V;             // a power of two
  const int k = k0 + (threadIdx.x % UNITS) * V;
  if (k >= k1) return;
  for (int r = threadIdx.x / UNITS; r < n; r += THREADS / UNITS) {
    const T* p = src(r);
    float* o = dst + r * stride + k;
    if constexpr (VEC && sizeof(T) == 4) {
      cp_async16(o, p ? p + c0 + k : base, p ? 16 : 0);
    } else if constexpr (VEC) {
      float v[8] = {};
      if (p) load16(p + c0 + k, v);
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      *o = (p && k < kc) ? to_f32(p[c0 + k]) : 0.f;
    }
  }
}

// Add a round's kc4 staged columns to the norms: NP threads per row of xs
// and per query of qs, each over every NP-th float4 of the row, with the
// four lanes of the float4 summed apart and then pairwise, so a thread's
// chains are short. The NP parts stay apart until the epilogue, and each
// has one writer, always the same, so every norm is summed in one fixed
// order.
__device__ inline void add_norms(int kc4, Tile t) {
  const int xr = threadIdx.x % BR, xp = threadIdx.x / BR;
  const int qr = threadIdx.x % QT, qp = threadIdx.x / QT;
  const bool has_x = threadIdx.x < NP * BR, has_q = threadIdx.x < NP * QT;
  float4 sx = {}, sq = {};
#pragma unroll
  for (int j = 0; j < KC / (4 * NP); ++j) {
    if (has_x && 4 * (xp + NP * j) < kc4) {
      const float4 v = *reinterpret_cast<const float4*>(
          t.xs + xr * t.stride + 4 * (xp + NP * j));
      sx.x = fmaf(v.x, v.x, sx.x);
      sx.y = fmaf(v.y, v.y, sx.y);
      sx.z = fmaf(v.z, v.z, sx.z);
      sx.w = fmaf(v.w, v.w, sx.w);
    }
    if (has_q && 4 * (qp + NP * j) < kc4) {
      const float4 v = *reinterpret_cast<const float4*>(
          t.qs + qr * t.stride + 4 * (qp + NP * j));
      sq.x = fmaf(v.x, v.x, sq.x);
      sq.y = fmaf(v.y, v.y, sq.y);
      sq.z = fmaf(v.z, v.z, sq.z);
      sq.w = fmaf(v.w, v.w, sq.w);
    }
  }
  if (has_x) t.x2[xp * BR + xr] += (sx.x + sx.y) + (sx.z + sx.w);
  if (has_q) t.qsq[qp * QT + qr] += (sq.x + sq.y) + (sq.z + sq.w);
}

// Store a thread's 4 query values of one output row: one float4 on the VEC
// path, else the ones inside Q.
template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ out, size_t row,
                                       int qb, int Q, const float* v) {
  float* p = out + row * Q + qb;
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (qb + c < Q) p[c] = v[c];
  }
}

// exact[r, q] = |x_r|^2 - 2 x_r . q + |q|^2 for the block's BR rows and QT
// queries, out viewed as (rows, Q), after find_rows.
//
// d is taken in rounds of KC columns. A round's queries are staged first
// (in round 0 before the barrier that publishes the rows, so their copies
// overlap the schedule lookup), then its rows. `staged()` runs once, with
// the rows visible and the first round's copies in flight; `step()` runs
// at the top of every step of the column loop. (Summing each SC columns
// as they land, while the rest are in flight, measured slower on an H100:
// the threads that would sum are the ones issuing the copies, and every
// group costs a barrier.)
//
// Each sum takes one fixed order (a group's columns in ascending order,
// then the groups in order), the same in every kernel that calls this, so
// their outputs agree bit for bit.
template <typename T, bool VEC, typename F, typename S>
__device__ void exact_tile(const T* __restrict__ pages,
                           const T* __restrict__ q, float* __restrict__ out,
                           int rows, int d, int Q, Tile t, F staged, S step) {
  const int g = threadIdx.x / GT, lt = threadIdx.x % GT;
  const int qg = lt % EQG, rg = lt / EQG;
  const int q0 = blockIdx.y * QT;
  auto query = [&](int r) -> const T* {
    return q0 + r < Q ? q + static_cast<size_t>(q0 + r) * d : nullptr;
  };
  auto record = [&](int r) -> const T* {
    return t.row[r] < 0 ? nullptr : pages + t.row[r] * d;
  };
  float acc[ER][EQ] = {};
  for (int c0 = 0; c0 < d; c0 += KC) {
    const int kc = min(KC, d - c0), kc4 = (kc + 3) & ~3;
    if (c0 > 0) __syncthreads();            // the last round's reads are done
    for (int k0 = 0; k0 < kc4; k0 += SC)
      stage<T, VEC>(QT, query, q, c0, k0, min(kc4, k0 + SC), kc, t.qs,
                    t.stride);
    if (c0 == 0) __syncthreads();           // the rows of find_rows
    for (int k0 = 0; k0 < kc4; k0 += SC)
      stage<T, VEC>(BR, record, pages, c0, k0, min(kc4, k0 + SC), kc, t.xs,
                    t.stride);
    if (c0 == 0) staged();
    cp_async_wait_all();
    __syncthreads();
    add_norms(kc4, t);
    for (int k = 4 * g; k < kc4; k += 4 * KS) {
      step();
      float4 xv[ER], qv[EQ];
#pragma unroll
      for (int i = 0; i < ER; ++i)
        xv[i] = *reinterpret_cast<const float4*>(
            t.xs + (rg + ERG * i) * t.stride + k);
#pragma unroll
      for (int m = 0; m < EQ; ++m)
        qv[m] = *reinterpret_cast<const float4*>(
            t.qs + (qg + EQG * m) * t.stride + k);
#pragma unroll
      for (int i = 0; i < ER; ++i) {
#pragma unroll
        for (int m = 0; m < EQ; ++m) {
          float a = fmaf(xv[i].x, qv[m].x, acc[i][m]);
          a = fmaf(xv[i].y, qv[m].y, a);
          a = fmaf(xv[i].z, qv[m].z, a);
          acc[i][m] = fmaf(xv[i].w, qv[m].w, a);
        }
      }
    }
  }
  __syncthreads();              // every read of the staged tiles is done
  float* mine = t.part + threadIdx.x * PS;
#pragma unroll
  for (int i = 0; i < ER; ++i)
#pragma unroll
    for (int m = 0; m < EQ; m += 2)
      *reinterpret_cast<float2*>(mine + i * EQ + m) =
          make_float2(acc[i][m], acc[i][m + 1]);
  // the norms' parts, summed in place into part 0
  for (int i = threadIdx.x; i < BR + QT; i += THREADS) {
    float* n = i < BR ? t.x2 + i : t.qsq + (i - BR);
    const int step = i < BR ? BR : QT;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) s += n[p * step];
    n[0] = s;
  }
  __syncthreads();
  // Thread (g, lt) finishes queries 2g and 2g + 1 of thread lt's slots: the
  // groups' sums in group order, then the norms.
#pragma unroll
  for (int i = 0; i < ER; ++i) {
    const int lr = rg + ERG * i, r = blockIdx.x * BR + lr;
    if (r >= rows) continue;
    float2 s = *reinterpret_cast<const float2*>(t.part + lt * PS + i * EQ + 2 * g);
#pragma unroll
    for (int p = 1; p < KS; ++p) {
      const float2 o = *reinterpret_cast<const float2*>(
          t.part + (p * GT + lt) * PS + i * EQ + 2 * g);
      s.x += o.x;
      s.y += o.y;
    }
    const float x2 = t.x2[lr];
    const float v[2] = {s.x, s.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ql = qg + EQG * (2 * g + h);
      if (q0 + ql < Q)
        out[static_cast<size_t>(r) * Q + q0 + ql] =
            fmaf(-2.f, v[h], x2) + t.qsq[ql];
    }
  }
}

// Stage the block's (BR, M) code tile (zeros past the schedule): by 4-byte
// cp.async, which the caller waits for, where M % 4 == 0 and the codes are
// 4-byte aligned; else byte by byte.
__device__ inline void stage_codes(const uint8_t* __restrict__ codes, int M,
                                   Tile t) {
  if (M % 4 == 0 && (reinterpret_cast<uintptr_t>(codes) & 3) == 0) {
    const int words = M / 4;
    for (int i = threadIdx.x; i < BR * words; i += THREADS) {
      const long long ri = t.row[i / words];
      cp_async4(t.cs + 4 * i, ri >= 0 ? codes + ri * M + 4 * (i % words)
                                      : codes, ri >= 0 ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BR * M; i += THREADS) {
      const long long ri = t.row[i / M];
      t.cs[i] = ri >= 0 ? codes[ri * M + i % M] : 0;
    }
  }
}

// adc[r, q] = sum_j lut_t[j, code[r, j], q] for the block's rows and
// queries, from the staged codes; a thread sums RT rows x 4 queries.
// lut_t is (M, 256, Q): for one (j, code) a thread reads its 4 queries as
// one float4, and the 16 threads along Q read 256 contiguous bytes. The
// gathers go to L2 (the LUT is 4 MB at the smoke's shape): BR * M * QT * 4
// bytes per block, the ADC half's floor.
//
// The gathers go in batches of AJ subspaces: issue() sends a batch, add()
// sums it, in j order, so every AJ gives the same bits. page_adc issues
// 16 subspaces at a time and adds them in finish(); fused_page_rank calls
// step() in the exact half's column loop, which adds the batch issued at
// the step before and issues the next 3, so they are in flight while the
// FMAs run.
template <bool VEC, int AJ>
struct AdcPipe {
  const float* __restrict__ lut_t;
  const uint8_t* cs;
  int M, Q, qb, ty, next = 0, pending = 0;
  float s[RT][4] = {};
  float4 pend[AJ][RT];

  __device__ AdcPipe(const float* lut, const Tile& t, int m, int nq)
      : lut_t(lut), cs(t.cs), M(m), Q(nq),
        qb(blockIdx.y * QT + 4 * (threadIdx.x % TX)), ty(threadIdx.x / TX) {}

  __device__ void issue() {
    pending = min(AJ, M - next);
#pragma unroll
    for (int jj = 0; jj < AJ; ++jj) {
      if (jj >= pending) break;
      const int j = next + jj;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float* p = lut_t + (static_cast<size_t>(j) * 256 +
                                  cs[(ty + TY * i) * M + j]) * Q + qb;
        if constexpr (VEC) {
          pend[jj][i] = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          pend[jj][i] = make_float4(__ldg(p), qb + 1 < Q ? __ldg(p + 1) : 0.f,
                                    qb + 2 < Q ? __ldg(p + 2) : 0.f,
                                    qb + 3 < Q ? __ldg(p + 3) : 0.f);
        }
      }
    }
    next += pending;
  }

  __device__ void add() {
#pragma unroll
    for (int jj = 0; jj < AJ; ++jj) {
      if (jj >= pending) break;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        s[i][0] += pend[jj][i].x;
        s[i][1] += pend[jj][i].y;
        s[i][2] += pend[jj][i].z;
        s[i][3] += pend[jj][i].w;
      }
    }
    pending = 0;
  }

  __device__ void step() {
    if (qb >= Q) return;
    add();
    if (next < M) issue();
  }

  // Add what is in flight and what is left, and store.
  __device__ void finish(float* __restrict__ out, int rows) {
    if (qb >= Q) return;
    add();
    while (next < M) {
      issue();
      add();
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = blockIdx.x * BR + ty + TY * i;
      if (r < rows) store4<VEC>(out, r, qb, Q, s[i]);
    }
  }
};

// Launch `kernel` over the tiles of a (rows, Q) output.
template <typename K, typename... Args>
int launch_tiles(K kernel, size_t smem, int rows, int Q, void* stream,
                 Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + BR - 1) / BR, (Q + QT - 1) / QT);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch
