// K1: pJDS y = A x in the permuted (sorted) basis -- paper Listing 2.
//
// Replaces the Pallas kernel repro/kernels/pjds_spmv.py
// pjds_matvec_kernel_call (body _pjds_spmv_kernel).  The TPU version
// streams (chunk_l, b_r) tiles of one row block through a sequential
// grid into a VMEM-pinned output block; here the row block is one CTA
// of b_r threads, one thread per row lane -- the paper's own GPU layout.
// Thread r walks the block's diagonals, reading val[j, r] / col[j, r]
// (coalesced across the warp), gathers x[col] through the read-only
// cache and writes y once.
//
// Bound on an H100: bytes.  Each call must read the stored elements
// (value + index width each), x once and block_start, and write y:
// 2 flops per stored element are ~1/4 flop per byte, far below the
// card's ~20 f32 flops per byte of HBM.
#include "common.cuh"

REPRO_ERROR_STRING_FN(pjds_spmv_error_string)

extern "C" int pjds_spmv(const void* val, int val_kind, const void* col,
                         int idx_kind, const int* block_start,
                         const float* x, float* y, int n_blocks, int b_r,
                         void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH(val_kind, idx_kind,
                 repro::block_rows_kernel<V, I><<<n_blocks, b_r, 0, s>>>(
                     (const V*)val, (const I*)col, block_start, x, y, b_r));
  return (int)cudaGetLastError();
}
