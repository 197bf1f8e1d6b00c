// merge_topl: the merge of the search pool, `dedup_merge_topL` of
// core/searchutils.py, one block a row. Row b of ids (B, N) int64, keys
// (B, N, K) f32 and flags (B, N, F) bool gives L entries: the unique ids,
// each id's min key per column and OR'd flag per column, sorted by key
// column 0, SENTINEL where fewer than L ids are real.
//
// Replaces no TPU kernel: the reference's merge is jnp (two stable sorts, a
// doubling segmented min/OR and six gathers), which XLA fuses. Its plain
// version in PyTorch is 96-151 launches a call at the search's widths
// (N = 128 to 2,368), about half of every disk hop and MemGraph hop, and
// each doubling round reads and writes the whole (B, N) row set again.
//
// Bound: bytes. A row reads N (8 + 4K + F) bytes and writes L (8 + 4K + F);
// at deep's disk hop (B = 256, N = 2,368, L = 96, K = F = 2) that is
// 11.4 MB, 3.4 us at 3.35 TB/s. The sorts' work is O(N log^2 N) compares a
// row, all in registers and shared memory.
//
// Design: one block a row; nothing between the loads and the stores goes
// through device memory. A thread owns ITEMS consecutive entries of each
// sorted order, in registers. The row's padded length NP (a power of two)
// sets the launch: 8 entries a thread and NP / 8 <= 512 threads up to
// NP = 4,096, the widths of the search's hops; then 1,024 threads of 8
// (NP = 8,192) or of 16 (NP = 16,384) entries, which spill registers but
// serve the hops of graphs with R up to about 450.
//  1. Sort the words (id << 32 | position) with a bitonic sort over the
//     padded length NP, the pad words all ones. Strides inside a thread
//     run in registers, inside a warp by shuffles, across warps through
//     shared memory. The position makes every word unique, so the order
//     is the stable sort's.
//  2. Gather each sorted entry's keys and flags and take, within each run
//     of equal ids, the suffix min of each key column and suffix OR of each
//     flag column: in registers inside a thread, then across threads by a
//     log-step scan of the threads' first entries in shared memory. Every
//     slot ends with its run's suffix min and OR, which is what the plain
//     path's doubling leaves in it; min and OR of a set do not depend on
//     the order they are taken in (but for a set whose min is zero of both
//     signs, which squared distances never give).
//  3. Sort the words (rank key's order bits << 32 | sorted position), the
//     rank key INF except at the first entry of a run whose id is under
//     SENTINEL, again a stable order.
//  4. The first L words name the output's entries: a slot map in shared
//     memory tells each owner where to write its entries.
// So the result equals the plain path's bit for bit, padded slots included.
//
// Ids are int32 values held in int64, as the reference's int32 ids are;
// the wrapper's contract, not checked here. Shared memory is 8 NP bytes:
// 32 KB up to NP = 4,096, under the 48 KB default; the wider launches
// (64 and 128 KB) opt in at each launch (common.cuh allow_smem).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int MAX_N = 16384;                 // widest row
constexpr uint16_t NO_SLOT = 0xffff;

// The padded sort length of a row of n: a power of two, at least 8.
inline int sort_len(int n) {
  int np = 8;
  while (np < n) np *= 2;
  return np;
}

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a < b ? b : a; }

// The compare-exchange steps of strides J, J / 2, ..., 1 (each < ITEMS
// and < k), inside a thread's words.
template <int ITEMS, int J>
__device__ __forceinline__ void exchange_own(u64 (&v)[ITEMS], int base,
                                             int k) {
  if (J < k) {
#pragma unroll
    for (int c = 0; c < ITEMS; ++c) {
      if ((c & J) == 0) {
        const bool up = ((base + c) & k) == 0;
        const u64 a = v[c], b = v[c | J];
        const bool swap = (a > b) == up;
        v[c] = swap ? b : a;
        v[c | J] = swap ? a : b;
      }
    }
  }
  if constexpr (J > 1) exchange_own<ITEMS, J / 2>(v, base, k);
}

// Sort the block's NP = blockDim.x * ITEMS words ascending, word
// t * ITEMS + c in v[c] of thread t. buf: NP words of shared memory, laid
// out c * blockDim.x + t so that a warp's accesses are consecutive.
template <int ITEMS>
__device__ void bitonic(u64 (&v)[ITEMS], u64* buf) {
  const int t = threadIdx.x, T = blockDim.x, np = T * ITEMS;
  const unsigned lanes = T >= 32 ? 0xffffffffu : (1u << T) - 1;
  const int base = t * ITEMS;
  for (int k = 2; k <= np; k <<= 1) {
    for (int j = k >> 1; j >= ITEMS; j >>= 1) {
      const int tj = j / ITEMS;               // the partner thread: t ^ tj
      const bool keep_min = ((t & tj) == 0) == ((base & k) == 0);
      if (tj < 32) {
#pragma unroll
        for (int c = 0; c < ITEMS; ++c) {
          const u64 o = __shfl_xor_sync(lanes, v[c], tj);
          v[c] = keep_min ? umin(v[c], o) : umax(v[c], o);
        }
      } else {
#pragma unroll
        for (int c = 0; c < ITEMS; ++c) buf[c * T + t] = v[c];
        __syncthreads();
#pragma unroll
        for (int c = 0; c < ITEMS; ++c) {
          const u64 o = buf[c * T + (t ^ tj)];
          v[c] = keep_min ? umin(v[c], o) : umax(v[c], o);
        }
        __syncthreads();
      }
    }
    exchange_own<ITEMS, ITEMS / 2>(v, base, k);
  }
}

// Ids as unsigned words that sort as the int32 values do.
__device__ __forceinline__ uint32_t id_word(long long x) {
  return static_cast<uint32_t>(x) ^ 0x80000000u;
}
__device__ __forceinline__ long long id_value(uint32_t w) {
  return static_cast<int32_t>(w ^ 0x80000000u);
}

// A float's bits as a word that sorts as torch.sort orders floats: -0 ties
// with +0, NaN after +inf.
__device__ __forceinline__ uint32_t key_word(float x) {
  if (x != x) return 0xffffffffu;
  const uint32_t u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// torch.minimum's min: NaN if either is NaN.
__device__ __forceinline__ float key_min(float a, float b) {
  if (a != a || b != b) return __uint_as_float(0x7fc00000u);
  return b < a ? b : a;
}

template <int ITEMS, int MAX_THREADS, int K, int F>
__global__ void __launch_bounds__(MAX_THREADS)
merge_topl_kernel(const long long* __restrict__ ids,
                  const float* __restrict__ keys,
                  const uint8_t* __restrict__ flags, int n, int L,
                  long long sentinel, float inf,
                  long long* __restrict__ out_ids,
                  float* __restrict__ out_keys,
                  uint8_t* __restrict__ out_flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);
  const int t = threadIdx.x, T = blockDim.x, j0 = t * ITEMS;
  const size_t row = blockIdx.x;
  ids += row * n;
  keys += row * n * K;
  flags += row * n * F;

  // 1. the stable sort by id
  u64 v[ITEMS];
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const int j = j0 + c;
    v[c] = j < n ? (static_cast<u64>(id_word(ids[j])) << 32) | j : ~0ull;
  }
  bitonic<ITEMS>(v, buf);

  // 2. each run's suffix min and OR; the pad entries (j >= n) take +inf
  // keys and no flags, which change no real entry's
  uint32_t id[ITEMS];
  float kv[ITEMS][K];
  uint32_t fv[ITEMS];
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    id[c] = static_cast<uint32_t>(v[c] >> 32);
    const uint32_t p = static_cast<uint32_t>(v[c]);
    fv[c] = 0;
#pragma unroll
    for (int q = 0; q < K; ++q)
      kv[c][q] = j0 + c < n ? keys[p * K + q] : __uint_as_float(0x7f800000u);
#pragma unroll
    for (int q = 0; q < F; ++q)
      if (j0 + c < n && flags[p * F + q]) fv[c] |= 1u << q;
  }
#pragma unroll
  for (int c = ITEMS - 2; c >= 0; --c) {
    if (id[c] == id[c + 1]) {
#pragma unroll
      for (int q = 0; q < K; ++q) kv[c][q] = key_min(kv[c][q], kv[c + 1][q]);
      fv[c] |= fv[c + 1];
    }
  }
  // across threads: head[t] = the suffix of the run at entry j0, a
  // segmented doubling over the threads' first entries
  uint32_t* hid = reinterpret_cast<uint32_t*>(smem);
  uint32_t* last = hid + T;
  uint32_t* hf = last + T;
  float* hk = reinterpret_cast<float*>(hf + T);
  hid[t] = id[0];
  last[t] = id[ITEMS - 1];
  hf[t] = fv[0];
#pragma unroll
  for (int q = 0; q < K; ++q) hk[q * T + t] = kv[0][q];
  __syncthreads();
  for (int s = 1; s < T; s <<= 1) {
    const bool same = t + s < T && hid[t + s] == id[0];
    float ok[K];
    uint32_t of = 0;
    if (same) {
#pragma unroll
      for (int q = 0; q < K; ++q) ok[q] = hk[q * T + t + s];
      of = hf[t + s];
    }
    __syncthreads();
    if (same) {
#pragma unroll
      for (int q = 0; q < K; ++q) hk[q * T + t] = key_min(hk[q * T + t], ok[q]);
      hf[t] |= of;
    }
    __syncthreads();
  }
  // the thread's last run, where it goes on in the next thread's entries
  if (t + 1 < T && hid[t + 1] == id[ITEMS - 1]) {
    float xk[K];
#pragma unroll
    for (int q = 0; q < K; ++q) xk[q] = hk[q * T + t + 1];
    const uint32_t xf = hf[t + 1];
#pragma unroll
    for (int c = 0; c < ITEMS; ++c) {
      if (id[c] == id[ITEMS - 1]) {
#pragma unroll
        for (int q = 0; q < K; ++q) kv[c][q] = key_min(kv[c][q], xk[q]);
        fv[c] |= xf;
      }
    }
  }
  const bool after_run = t == 0 || last[t - 1] != id[0];
  __syncthreads();                            // buf is free again

  // 3. the stable sort by rank key
  float rank[ITEMS];
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const int j = j0 + c;
    const bool first = c == 0 ? after_run : id[c] != id[c - 1];
    rank[c] = first && id_value(id[c]) < sentinel ? kv[c][0] : inf;
    v[c] = j < n ? (static_cast<u64>(key_word(rank[c])) << 32) | j : ~0ull;
  }
  bitonic<ITEMS>(v, buf);

  // 4. the first L entries of the rank order, each written by its owner
  uint16_t* slot = reinterpret_cast<uint16_t*>(smem);
  for (int i = t; i < T * ITEMS; i += T) slot[i] = NO_SLOT;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < ITEMS; ++c)
    if (j0 + c < L) slot[static_cast<uint32_t>(v[c])] = j0 + c;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const int o = slot[j0 + c];
    if (o == NO_SLOT) continue;
    const size_t r = row * L + o;
    out_ids[r] = rank[c] < inf ? id_value(id[c]) : sentinel;
#pragma unroll
    for (int q = 0; q < K; ++q) out_keys[r * K + q] = kv[c][q];
#pragma unroll
    for (int q = 0; q < F; ++q) out_flags[r * F + q] = (fv[c] >> q) & 1u;
  }
}

template <int ITEMS, int MAX_THREADS, int K, int F>
int launch(const void* ids, const void* keys, const void* flags, int B,
           int n, int np, int L, long long sentinel, float inf,
           void* out_ids, void* out_keys, void* out_flags, void* stream) {
  const auto kernel = merge_topl_kernel<ITEMS, MAX_THREADS, K, F>;
  const size_t smem = sizeof(u64) * np;
  const cudaError_t err = repro_torch::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, np / ITEMS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ids), static_cast<const float*>(keys),
      static_cast<const uint8_t*>(flags), n, L, sentinel, inf,
      static_cast<long long*>(out_ids), static_cast<float*>(out_keys),
      static_cast<uint8_t*>(out_flags));
  return static_cast<int>(cudaGetLastError());
}

template <int K, int F>
int launch_width(const void* ids, const void* keys, const void* flags, int B,
                 int n, int L, long long sentinel, float inf, void* out_ids,
                 void* out_keys, void* out_flags, void* stream) {
  const int np = sort_len(n);
  auto fn = np <= 4096   ? &launch<8, 512, K, F>
            : np <= 8192 ? &launch<8, 1024, K, F>
                         : &launch<16, 1024, K, F>;
  return fn(ids, keys, flags, B, n, np, L, sentinel, inf, out_ids, out_keys,
            out_flags, stream);
}

}  // namespace

// ids (B, n) int64, keys (B, n, K) f32, flags (B, n, F) bool (one byte
// each), all contiguous -> out_ids (B, L), out_keys (B, L, K), out_flags
// (B, L, F). Takes 1 <= B, 1 <= L <= n <= 16384, K and F in {1, 2}.
extern "C" int merge_topl(const void* ids, const void* keys,
                          const void* flags, int B, int n, int K, int F,
                          int L, long long sentinel, float inf, void* out_ids,
                          void* out_keys, void* out_flags, void* stream) {
  if (B < 1 || L < 1 || L > n || n > MAX_N || K < 1 || K > 2 || F < 1 ||
      F > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto fn = K == 1 ? (F == 1 ? &launch_width<1, 1> : &launch_width<1, 2>)
                   : (F == 1 ? &launch_width<2, 1> : &launch_width<2, 2>);
  return fn(ids, keys, flags, B, n, L, sentinel, inf, out_ids, out_keys,
            out_flags, stream);
}
