// page_scan: exact squared L2 from every record of each scheduled page to
// every query, out (W, n_p, Q) f32 = |x|^2 - 2 x.q + |q|^2.
//
// Replaces the Pallas kernel `page_scan` in src/repro/kernels/page_scan.py.
//
// Bound on an H100 at the main path's shapes (W = 256 scheduled pages,
// n_p = 6, d = 96, Q = 256, f32): it moves about 2.3 MB (the scheduled page
// tiles 0.59 MB, the queries 0.1 MB, the output 1.57 MB), 0.7 us at
// 3.35 TB/s, and does 2 W n_p Q d = 75.5 MFLOP, 1.1 us at the 67 TFLOP/s of
// f32 outside the tensor cores. So it is bound by operations, and only
// just.
//
// Design: the tile of common.cuh. A block owns 48 stacked records (8 pages
// at n_p = 6) and 64 queries and stages both once by cp.async; 4 groups of
// 64 threads split the columns, each thread summing 6 records x 8 queries
// in registers; the kernel takes |x|^2 and |q|^2 from the staged tiles.
// At that shape it is bound by its launch and schedule lookup, L2's
// bandwidth for the 5.5 MB of staged tiles, and shared-memory traffic in
// the FMA loop, in about equal parts (common.cuh says how that was
// measured).
#include "common.cuh"

using namespace repro_torch;

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
page_scan_kernel(const T* __restrict__ pages, const int* __restrict__ page_ids,
                 const T* __restrict__ q, float* __restrict__ out, int rows,
                 int n_p, int d, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = carve(smem, tile_cols(d));
  find_rows(page_ids, n_p, rows, t);
  exact_tile<T, VEC>(pages, q, out, rows, d, Q, t, [] {}, [] {});
}

template <typename T>
static int launch(const void* pages, const void* page_ids, const void* q,
                  void* out, int W, int n_p, int d, int Q, void* stream) {
  const size_t smem = tile_bytes(tile_cols(d), 0);
  const int rows = W * n_p;
  const bool vec = (d * sizeof(T)) % 16 == 0 && Q % 4 == 0 &&
                   aligned16(pages) && aligned16(q) && aligned16(out);
  auto args = [&](auto kernel) {
    return launch_tiles(kernel, smem, rows, Q, stream,
                        static_cast<const T*>(pages),
                        static_cast<const int*>(page_ids),
                        static_cast<const T*>(q), static_cast<float*>(out),
                        rows, n_p, d, Q);
  };
  return vec ? args(page_scan_kernel<T, true>)
             : args(page_scan_kernel<T, false>);
}

extern "C" int page_scan_f32(const void* pages, const void* page_ids,
                             const void* q, void* out, int W, int n_p, int d,
                             int Q, void* stream) {
  return launch<float>(pages, page_ids, q, out, W, n_p, d, Q, stream);
}

extern "C" int page_scan_bf16(const void* pages, const void* page_ids,
                              const void* q, void* out, int W, int n_p, int d,
                              int Q, void* stream) {
  return launch<__nv_bfloat16>(pages, page_ids, q, out, W, n_p, d, Q, stream);
}

// Dynamic shared memory of one block for width d.
extern "C" int page_scan_smem(int d) {
  return static_cast<int>(tile_bytes(tile_cols(d), 0));
}
