// K4: ELLPACK-R y = A x -- paper Listing 1, rows in ORIGINAL order.
//
// Replaces the Pallas kernel repro/kernels/ellr_spmv.py
// ell_matvec_kernel_call (body _ellr_spmv_kernel).  The TPU version
// walks (chunk_l, tile_r) tiles of the jagged-diagonal-major arrays
// through a sequential grid and skips whole tiles past a row tile's
// longest row (the scalar-prefetched tile_chunks); a TPU grid step is
// all-or-nothing, so it computes every padded slot below that maximum.
// Here one thread owns a row, as in the paper's GPU kernel, and reads
// val[j * n_pad + i] / col[j * n_pad + i] for j < rowlen[i], so a
// diagonal is one coalesced load across a warp.  Slots at or past
// rowlen[i] are never read, so padding cannot carry a non-finite x[0]
// into a short row (the plain version masks by rowlen the same way).
//
// What bounds it on an H100: bytes -- the nnz slots (value + index
// width), rowlen and x read once, y written once; 2 flops per slot.
// The layout adds its own floor: rows keep their original, unsorted
// order, so a 32-byte sector of val or col spans 8 rows (f32 / int32)
// and is fetched whenever any of them is still running -- 1.56 x nnz
// slots on the 3.4 M-row sAMG.  The host arrays stay the reference's,
// so what the kernel can win is latency: each warp loops to the longest
// of its rows (one __reduce_max_sync, so lanes never diverge in loop
// control) kUnroll diagonals per step, all value and index loads of the
// step issued before its gathers, each predicated by j < rowlen[i] so
// that a finished lane fetches nothing.  The streams are read once
// (__ldcs, evict-first), x through the read-only path.  Each row's sum
// is taken in diagonal order, as the one-row-at-a-time loop took it.
#include "common.cuh"

namespace {

// Measured on an H100 (sAMG, kernel_ab.py): four diagonals per step take
// 34-40 registers, so not every thread slot of an SM fills, and ran
// 1.11 x slower than two (four held to 32 registers tied with two); a
// lane loop bounded by its own rowlen ran 1.65 x slower, and __ldg
// streams 1.12 x.  CTA size and two rows per thread moved it by < 3 %.
constexpr int kThreads = 256;   // threads per CTA
constexpr int kRows = 1;        // rows per thread: i, i + 32, ... of a warp
constexpr int kUnroll = 2;      // diagonals per step

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    ellr_kernel(const V* __restrict__ val, const I* __restrict__ col,
                const int* __restrict__ rowlen, const float* __restrict__ x,
                float* __restrict__ y, int n_pad) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int row0 = warp * 32 * kRows + lane;
  int len[kRows];
  float acc[kRows];
  int most = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = row0 + 32 * k;
    len[k] = i < n_pad ? __ldcs(rowlen + i) : 0;
    acc[k] = 0.f;
    most = max(most, len[k]);
  }
  most = __reduce_max_sync(0xffffffffu, most);
  const size_t st = (size_t)n_pad;
  for (int j = 0; j < most; j += kUnroll) {
    V v[kRows][kUnroll];
    I c[kRows][kUnroll];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + u < len[k]) {
          const size_t off = (size_t)(j + u) * st + row0 + 32 * k;
          v[k][u] = __ldcs(val + off);
          c[k][u] = __ldcs(col + off);
        }
    float xv[kRows][kUnroll];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + u < len[k]) xv[k][u] = __ldg(x + (int)c[k][u]);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + u < len[k]) acc[k] += repro::to_f32(v[k][u]) * xv[k][u];
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    if (row0 + 32 * k < n_pad) y[row0 + 32 * k] = acc[k];
}

}  // namespace

REPRO_ERROR_STRING_FN(ellr_spmv_error_string)

extern "C" int ellr_spmv(const void* val, int val_kind, const void* col,
                         int idx_kind, const int* rowlen, const float* x,
                         float* y, int n_pad, void* stream) {
  if (n_pad <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows_per_cta = kThreads * kRows;
  const int grid = (n_pad + rows_per_cta - 1) / rows_per_cta;
  REPRO_DISPATCH(val_kind, idx_kind,
                 ellr_kernel<V, I><<<grid, kThreads, 0, s>>>(
                     (const V*)val, (const I*)col, rowlen, x, y, n_pad));
  return (int)cudaGetLastError();
}
