// K4: ELLPACK-R y = A x -- paper Listing 1, rows in ORIGINAL order.
//
// Replaces the Pallas kernel repro/kernels/ellr_spmv.py
// ell_matvec_kernel_call (body _ellr_spmv_kernel).  The TPU version
// walks (chunk_l, tile_r) tiles of the jagged-diagonal-major arrays
// through a sequential grid and skips whole tiles past a row tile's
// longest row (the scalar-prefetched tile_chunks); a TPU grid step is
// all-or-nothing, so it computes every padded slot below that maximum.
// Here one thread owns one row, as in the paper's GPU kernel: thread i
// loops j < rowlen[i] over val[j * n_pad + i] / col[j * n_pad + i], so a
// diagonal is one coalesced load across a warp and a warp stops at the
// longest row among its 32.  Slots at or past rowlen[i] are never read,
// so padding cannot carry a non-finite x[0] into a short row (the plain
// version masks by rowlen the same way).
//
// Bound on an H100: bytes -- the nnz stored slots (value + index width),
// rowlen and x read once, y written once; 2 flops per slot.
#include "common.cuh"

namespace {

template <typename V, typename I>
__global__ void ellr_kernel(const V* __restrict__ val,
                            const I* __restrict__ col,
                            const int* __restrict__ rowlen,
                            const float* __restrict__ x,
                            float* __restrict__ y, int n_pad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const int len = rowlen[i];
  float acc = 0.f;
  size_t k = (size_t)i;
  for (int j = 0; j < len; ++j, k += (size_t)n_pad)
    acc += repro::to_f32(val[k]) * __ldg(x + (int)col[k]);
  y[i] = acc;
}

}  // namespace

REPRO_ERROR_STRING_FN(ellr_spmv_error_string)

extern "C" int ellr_spmv(const void* val, int val_kind, const void* col,
                         int idx_kind, const int* rowlen, const float* x,
                         float* y, int n_pad, void* stream) {
  if (n_pad <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const int grid = (n_pad + threads - 1) / threads;
  REPRO_DISPATCH(val_kind, idx_kind,
                 ellr_kernel<V, I><<<grid, threads, 0, s>>>(
                     (const V*)val, (const I*)col, rowlen, x, y, n_pad));
  return (int)cudaGetLastError();
}
