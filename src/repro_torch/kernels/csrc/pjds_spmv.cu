// K1: pJDS y = A x in the permuted (sorted) basis -- paper Listing 2.
//
// Replaces the Pallas kernel repro/kernels/pjds_spmv.py
// pjds_matvec_kernel_call (body _pjds_spmv_kernel).  The TPU version
// streams (chunk_l, b_r) tiles of one row block through a sequential
// grid into a VMEM-pinned output block; here one thread owns one row
// lane -- the paper's own GPU layout -- reading val[j, r] / col[j, r]
// (coalesced across the warp), gathering x[col] through the read-only
// cache and writing y once.  Threads map to (block, lane) in order, so
// each warp lies inside one row block and no CTA barrier is needed.
//
// What bounds it on an H100: bytes.  A block stores every lane to the
// block's longest row, rounded up to diag_align (16 at the reference's
// default): 2.41 x nnz slots on the 3.4 M-row sAMG.  pJDS sorts all rows
// by descending length, so the last real slot of 32 consecutive lanes is
// their first lane's length: each warp walks only its first warp_len[w]
// diagonals (ops.sell_warp_len, derived once at conversion), 1.00002 x
// nnz there, four diagonals per step with the loads in flight, and adds
// the skipped padding's 0 * x[0] once -- repro::lane_sum in common.cuh,
// shared with K2, which says why y keeps the bits of the full walk.
// The bytes it must move are then the walked slots times (value + index
// width), plus x, warp_len and block_start read once and y written once;
// the 2 flops per slot are far below the card's compute rate.
#include "common.cuh"

namespace {

// Threads per CTA, whatever b_r: with no shared memory and no barrier a
// CTA is only a unit of scheduling (128: one CTA per row block at the
// default b_r; kernel_ab.py times 128-1024).
constexpr int kThreads = 128;

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    pjds_kernel(const V* __restrict__ val, const I* __restrict__ col,
                const int* __restrict__ block_start,
                const int* __restrict__ warp_len,
                const float* __restrict__ x, float* __restrict__ y,
                int n_rows_pad, int b_r) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_rows_pad) return;
  y[t] = repro::lane_sum(val, col, block_start, warp_len, x, t / b_r, b_r,
                         t % b_r);
}

}  // namespace

REPRO_ERROR_STRING_FN(pjds_spmv_error_string)

// warp_len: (n_blocks * b_r / 32,) int32 diagonals to walk per warp.
extern "C" int pjds_spmv(const void* val, int val_kind, const void* col,
                         int idx_kind, const int* block_start,
                         const int* warp_len, const float* x, float* y,
                         int n_blocks, int b_r, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = n_blocks * b_r;
  const int grid = (n + kThreads - 1) / kThreads;
  REPRO_DISPATCH(val_kind, idx_kind,
                 pjds_kernel<V, I><<<grid, kThreads, 0, s>>>(
                     (const V*)val, (const I*)col, block_start, warp_len, x,
                     y, n, b_r));
  return (int)cudaGetLastError();
}
