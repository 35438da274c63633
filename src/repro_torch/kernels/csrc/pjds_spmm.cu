// K5: pJDS Y = A X for a block of k right-hand sides, in the permuted
// basis or, under a row map, in the original row order.
//
// Replaces the Pallas kernel repro/kernels/pjds_spmm.py
// pjds_matmat_kernel_call (body _pjds_spmm_kernel).  The TPU version
// keeps a (b_r, rhs_t) output block pinned in VMEM across a row block's
// chunks and gathers (chunk_l, b_r) rows of a resident X tile per step.
// Here, as in K1, one CTA owns one row block and one thread one row
// lane; the thread keeps a register tile of KT accumulators (KT = 1, 2,
// 4 or 8 columns of Y) and walks its block's jagged diagonals once per
// column tile.  X is row-major (n_cols_pad, k), so the gathered row
// X[col, c0 : c0 + KT] is KT contiguous floats: one or two 16-byte loads
// when k is a multiple of 4, scalar loads otherwise; the thread's row of
// Y is stored the same way (Y is allocated by the wrapper, so a row
// of k % 4 == 0 floats is 16-byte aligned).  k above 8 runs
// ceil(k / 8) column tiles on the grid's y axis; each re-reads the
// matrix stream, which stays in L2 only for small matrices.
//
// With a row map (out_row != nullptr, one int32 per stored row lane)
// the thread of row lane p stores its KT sums at Y row out_row[p]
// instead of row p, and a lane mapped to -1 (a padding row) stores
// nothing: the operator's unpermute back to the original row order is
// folded into the store, as K2 folds its own.  The map is a bijection
// onto the rows of Y, so every row is written exactly once.
//
// Bound on an H100: bytes -- the stored elements (value + index width)
// once per column tile, X read and Y written once; 2 * k flops per
// stored element, so the flop bound only matters for k in the hundreds.
#include "common.cuh"

namespace {

template <typename V, typename I, int KT>
__global__ void spmm_kernel(const V* __restrict__ val,
                            const I* __restrict__ col,
                            const int* __restrict__ block_start,
                            const float* __restrict__ X,
                            const int* __restrict__ out_row,
                            float* __restrict__ Y, int b_r, int k,
                            int vec4) {
  const int b = blockIdx.x, r = threadIdx.x;
  const int row = out_row ? out_row[(size_t)b * b_r + r] : b * b_r + r;
  if (row < 0) return;  // padding lane under a row map: no output row
  const int c0 = blockIdx.y * KT;
  const int kt = min(KT, k - c0);
  float acc[KT];
#pragma unroll
  for (int q = 0; q < KT; ++q) acc[q] = 0.f;
  const int j0 = block_start[b], j1 = block_start[b + 1];
  size_t off = (size_t)j0 * b_r + r;
  for (int j = j0; j < j1; ++j, off += (size_t)b_r) {
    const float v = repro::to_f32(val[off]);
    const float* xr = X + (size_t)(int)col[off] * k + c0;
    if (KT >= 4 && vec4) {
#pragma unroll
      for (int q = 0; q < KT / 4; ++q) {
        if (4 * q < kt) {
          const float4 u = __ldg((const float4*)xr + q);
          acc[4 * q + 0] += v * u.x;
          acc[4 * q + 1] += v * u.y;
          acc[4 * q + 2] += v * u.z;
          acc[4 * q + 3] += v * u.w;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < KT; ++q)
        if (q < kt) acc[q] += v * __ldg(xr + q);
    }
  }
  float* yr = Y + (size_t)row * k + c0;
  if (KT >= 4 && vec4) {
#pragma unroll
    for (int q = 0; q < KT / 4; ++q)
      if (4 * q < kt)
        ((float4*)yr)[q] = make_float4(acc[4 * q + 0], acc[4 * q + 1],
                                       acc[4 * q + 2], acc[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < KT; ++q)
      if (q < kt) yr[q] = acc[q];
  }
}

template <typename V, typename I>
cudaError_t launch(const V* val, const I* col, const int* block_start,
                   const float* X, const int* out_row, float* Y,
                   int n_blocks, int b_r, int k, int vec4, cudaStream_t s) {
  if (k == 1) {
    spmm_kernel<V, I, 1><<<dim3(n_blocks, 1), b_r, 0, s>>>(
        val, col, block_start, X, out_row, Y, b_r, k, vec4);
  } else if (k == 2) {
    spmm_kernel<V, I, 2><<<dim3(n_blocks, 1), b_r, 0, s>>>(
        val, col, block_start, X, out_row, Y, b_r, k, vec4);
  } else if (k <= 4) {
    spmm_kernel<V, I, 4><<<dim3(n_blocks, 1), b_r, 0, s>>>(
        val, col, block_start, X, out_row, Y, b_r, k, vec4);
  } else {
    spmm_kernel<V, I, 8><<<dim3(n_blocks, (k + 7) / 8), b_r, 0, s>>>(
        val, col, block_start, X, out_row, Y, b_r, k, vec4);
  }
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING_FN(pjds_spmm_error_string)

// X: (n_cols_pad, k) row-major f32; Y row-major f32, (n_blocks * b_r, k)
// without a row map, (number of mapped rows, k) with one.
// vec4 != 0 promises k % 4 == 0 and X and Y 16-byte aligned (float4
// loads and stores).
extern "C" int pjds_spmm(const void* val, int val_kind, const void* col,
                         int idx_kind, const int* block_start,
                         const float* X, const int* out_row, float* Y,
                         int n_blocks, int b_r, int k, int vec4,
                         void* stream) {
  if (n_blocks <= 0 || k <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH(val_kind, idx_kind,
                 return (int)launch<V, I>((const V*)val, (const I*)col,
                                          block_start, X, out_row, Y,
                                          n_blocks, b_r, k, vec4, s));
  return 0;
}
