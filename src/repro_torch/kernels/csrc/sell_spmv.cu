// K2: SELL-C-sigma y = A x, returned in the ORIGINAL row order.
//
// Replaces the Pallas kernel repro/kernels/sell_spmv.py
// sell_matvec_kernel_call (body _sell_spmv_kernel).  The TPU version
// keeps a whole sigma-window slab of w_b = sigma / b_r row blocks pinned
// in VMEM and gathers it back to the original order after the window's
// last chunk, so the unpermute never touches HBM.  Here one CTA owns one
// window: its 128 threads (one per row lane of 128 / b_r row blocks at a
// time; more when too few windows would leave the card idle,
// repro::window_cta_threads) walk the window's blocks in turns and drop
// the sorted sums into a shared-memory slab (sigma = 1024 -> 4 KB f32);
// after __syncthreads the CTA writes y[i] = slab[inv_perm[i] - row0]
// coalesced, in original order.  Rows never leave their window, so
// inv_perm stays inside the slab.
//
// What bounds it on an H100: bytes.  A block stores every lane to the
// block's longest row, rounded up to diag_align (16 at the reference's
// default): on the 3.4 M-row sAMG that is 2.70 x nnz slots, and a walk
// over all of them reads 2.6 x the bytes the function needs.  So each
// warp walks only its first warp_len[w] diagonals -- the slots up to the
// last one in which any of its 32 lanes holds a non-padding entry,
// derived once at conversion (ops.sell_warp_len) -- which is 1.05 x nnz
// on sAMG, four diagonals per step with the loads in flight.  The
// window walk is repro::window_spmv in common.cuh, which K3 calls too
// (with its dots as the epilogue), over repro::lane_sum, which K1 calls.
//
// Padding is kept exactly.  A padded slot holds val 0 and col PAD_COL
// (0), and the reference adds its 0 * x[0] to the row, so a NaN or Inf
// in x[0] poisons every row that carries padding.  A lane whose warp
// stops before the block's stored length therefore adds 0.f * x[0] once
// after its walk, which keeps y bit for bit that of the full walk
// (common.cuh says why).  A stored explicit 0 at column 0 at the end of
// a row looks like padding; its product is the same 0 * x[0].  warp_len
// is clamped to the block's stored length, so a corrupt length cannot
// read out of bounds.
//
// When the slab would not fit the 48 KB of static shared memory (sigma
// >= n, or sigma incommensurate with b_r: window_blocks returns
// n_blocks), the wrapper passes a scratch vector and the unpermute goes
// through device memory instead: a per-block kernel with the same walk
// into the scratch, then a gather pass.
#include "common.cuh"

namespace {

template <typename V, typename I>
__global__ void __launch_bounds__(1024)
    sell_window_kernel(const V* __restrict__ val, const I* __restrict__ col,
                       const int* __restrict__ block_start,
                       const int* __restrict__ warp_len,
                       const int* __restrict__ inv_perm,
                       const float* __restrict__ x, float* __restrict__ y,
                       int n_blocks, int b_r, int w_b) {
  extern __shared__ float slab[];
  repro::window_spmv(val, col, block_start, warp_len, inv_perm, x, y, slab,
                     n_blocks, b_r, w_b, [](int, float) {});
}

__global__ void unpermute_kernel(const float* __restrict__ ys,
                                 const int* __restrict__ inv_perm,
                                 float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = ys[inv_perm[i]];
}

}  // namespace

REPRO_ERROR_STRING_FN(sell_spmv_error_string)

// warp_len: (n_blocks * b_r / 32,) int32 diagonals to walk per warp.
// scratch == nullptr: shared-memory slab path (w_b * b_r floats must fit
// 48 KB); otherwise scratch holds n_blocks * b_r floats and the
// unpermute runs through device memory.
extern "C" int sell_spmv(const void* val, int val_kind, const void* col,
                         int idx_kind, const int* block_start,
                         const int* warp_len, const int* inv_perm,
                         const float* x, float* y, float* scratch,
                         int n_blocks, int b_r, int w_b, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (scratch == nullptr) {
    const int n_win = (n_blocks + w_b - 1) / w_b;
    const int threads = repro::window_cta_threads(b_r, w_b, n_win);
    const size_t slab = (size_t)w_b * b_r * sizeof(float);
    REPRO_DISPATCH(val_kind, idx_kind,
                   sell_window_kernel<V, I><<<n_win, threads, slab, s>>>(
                       (const V*)val, (const I*)col, block_start, warp_len,
                       inv_perm, x, y, n_blocks, b_r, w_b));
  } else {
    const int n = n_blocks * b_r;
    REPRO_DISPATCH(val_kind, idx_kind,
                   repro::sell_block_kernel<V, I><<<n_blocks, b_r, 0, s>>>(
                       (const V*)val, (const I*)col, block_start, warp_len,
                       x, scratch, b_r, nullptr));
    unpermute_kernel<<<(n + 255) / 256, 256, 0, s>>>(scratch, inv_perm, y,
                                                      n);
  }
  return (int)cudaGetLastError();
}
