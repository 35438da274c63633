// K2: SELL-C-sigma y = A x, returned in the ORIGINAL row order.
//
// Replaces the Pallas kernel repro/kernels/sell_spmv.py
// sell_matvec_kernel_call (body _sell_spmv_kernel).  The TPU version
// keeps a whole sigma-window slab of w_b = sigma / b_r row blocks pinned
// in VMEM and gathers it back to the original order after the window's
// last chunk, so the unpermute never touches HBM.  Here one CTA owns one
// window: its threads (one per row lane, as many row blocks at a time as
// fit 1024 threads) walk the window's blocks exactly as K1 does and drop
// the sorted sums into a shared-memory slab (sigma = 1024 -> 4 KB f32);
// after __syncthreads the CTA writes y[i] = slab[inv_perm[i] - row0]
// coalesced, in original order.  Rows never leave their window, so
// inv_perm stays inside the slab.
//
// When the slab would not fit the 48 KB of static shared memory (sigma
// >= n, or sigma incommensurate with b_r: window_blocks returns
// n_blocks), the wrapper passes a scratch vector and the unpermute goes
// through device memory instead: K1's per-block walk into the scratch,
// then a gather pass.
//
// Bound on an H100: bytes -- the stored elements (value + index width),
// x, inv_perm and block_start read once, y written once.
#include "common.cuh"

namespace {

template <typename V, typename I>
__global__ void sell_window_kernel(const V* __restrict__ val,
                                   const I* __restrict__ col,
                                   const int* __restrict__ block_start,
                                   const int* __restrict__ inv_perm,
                                   const float* __restrict__ x,
                                   float* __restrict__ y, int n_blocks,
                                   int b_r, int w_b) {
  extern __shared__ float slab[];
  const int blk0 = blockIdx.x * w_b;
  const int nb = min(w_b, n_blocks - blk0);
  const int per = blockDim.x / b_r;
  const int r = threadIdx.x % b_r, q = threadIdx.x / b_r;
  for (int bb = q; bb < nb; bb += per) {
    const int b = blk0 + bb;
    slab[bb * b_r + r] = repro::row_dot(val, col, x, block_start[b],
                                        block_start[b + 1], b_r, r);
  }
  __syncthreads();
  const int row0 = blk0 * b_r;
  const int rows = nb * b_r;
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    y[row0 + i] = slab[inv_perm[row0 + i] - row0];
}

__global__ void unpermute_kernel(const float* __restrict__ ys,
                                 const int* __restrict__ inv_perm,
                                 float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = ys[inv_perm[i]];
}

}  // namespace

REPRO_ERROR_STRING_FN(sell_spmv_error_string)

// scratch == nullptr: shared-memory slab path (w_b * b_r floats must fit
// 48 KB); otherwise scratch holds n_blocks * b_r floats and the
// unpermute runs through device memory.
extern "C" int sell_spmv(const void* val, int val_kind, const void* col,
                         int idx_kind, const int* block_start,
                         const int* inv_perm, const float* x, float* y,
                         float* scratch, int n_blocks, int b_r, int w_b,
                         void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (scratch == nullptr) {
    const int n_win = (n_blocks + w_b - 1) / w_b;
    const int threads = repro::window_threads(b_r, w_b);
    const size_t slab = (size_t)w_b * b_r * sizeof(float);
    REPRO_DISPATCH(val_kind, idx_kind,
                   sell_window_kernel<V, I><<<n_win, threads, slab, s>>>(
                       (const V*)val, (const I*)col, block_start, inv_perm,
                       x, y, n_blocks, b_r, w_b));
  } else {
    const int n = n_blocks * b_r;
    REPRO_DISPATCH(val_kind, idx_kind,
                   repro::block_rows_kernel<V, I><<<n_blocks, b_r, 0, s>>>(
                       (const V*)val, (const I*)col, block_start, x,
                       scratch, b_r));
    unpermute_kernel<<<(n + 255) / 256, 256, 0, s>>>(scratch, inv_perm, y,
                                                      n);
  }
  return (int)cudaGetLastError();
}
