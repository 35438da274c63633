// K3: the fused Krylov iteration -- K2's SELL y = A x (original row
// order) plus <y,w1>, <y,w2>, <y,y>, <w2,w2>, <w1,w2> in the same pass.
//
// Replaces the Pallas kernel repro/kernels/fused_iter.py
// fused_spmv_dots_kernel_call (body _fused_iter_kernel), which extends
// the SELL window epilogue: while the unpermuted slab is still in VMEM
// it reduces lane partials against two weight slabs.  Here K3 is K2's
// window kernel plus an epilogue: the same sigma-window CTA (128 threads,
// more when too few windows would leave the card idle) runs the same walk (repro::window_spmv in common.cuh: each warp walks
// its derived warp_len diagonals, four per step with the loads in
// flight, and adds the skipped padding's 0 * x[0] once) and writes the
// same y, so K3's y is K2's y bit for bit by construction.  While the
// slab is in shared memory each thread multiplies the rows it writes by
// w1[i] / w2[i], and the CTA reduces its five partials with warp
// shuffles into one row of a (n_win, 5) buffer.  A second stage (one
// CTA per dot, f64 sums in a fixed order) folds the rows into the five
// scalars.  No float atomics anywhere, so a solve repeats bit for bit.
//
// Every window stores at least one chunk (formats.py: block_len >= 1
// diagonal), so the reference kernel's <w2,w2> / <w1,w2> caveat for
// empty windows never arises and all five dots run over every row.
//
// When the slab does not fit shared memory the unpermute goes through
// device memory as in K2 (K2's repro::sell_block_kernel into a scratch
// vector), and the dots ride the gather pass instead.
//
// The fused solvers' device loop (core/solvers.py) passes a `done` flag:
// once the loop's exit has latched it, every CTA of every stage returns
// before touching the matrix, the vectors or the dots, so an iteration
// after the exit costs near-empty launches.  With `done` clear (or
// null) nothing else changes: y and the dots keep their bits.
//
// Bound on an H100: bytes -- K2's traffic (the walked slots, 1.05 x nnz
// on sAMG, plus x, inv_perm, warp_len and y) plus w1 and w2 read once
// and the (n_part, 5) partials written and read once.
#include "common.cuh"

namespace {

constexpr int kGatherRows = 2048;   // rows per CTA of the gather-dots pass

template <typename V, typename I>
__global__ void __launch_bounds__(1024)
    fused_window_kernel(const V* __restrict__ val, const I* __restrict__ col,
                        const int* __restrict__ block_start,
                        const int* __restrict__ warp_len,
                        const int* __restrict__ inv_perm,
                        const float* __restrict__ x,
                        const float* __restrict__ w1,
                        const float* __restrict__ w2, float* __restrict__ y,
                        float* __restrict__ part, int n_blocks, int b_r,
                        int w_b, const int* __restrict__ done) {
  if (done != nullptr && *done) return;
  extern __shared__ float slab[];
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  repro::window_spmv(val, col, block_start, warp_len, inv_perm, x, y, slab,
                     n_blocks, b_r, w_b, [&](int g, float yo) {
                       const float a = w1[g], c = w2[g];
                       acc[0] += yo * a;
                       acc[1] += yo * c;
                       acc[2] += yo * yo;
                       acc[3] += c * c;
                       acc[4] += a * c;
                     });
  repro::block_sum5(acc, part + (size_t)blockIdx.x * 5);
}

__global__ void unpermute_dots_kernel(const float* __restrict__ ys,
                                      const int* __restrict__ inv_perm,
                                      const float* __restrict__ w1,
                                      const float* __restrict__ w2,
                                      float* __restrict__ y,
                                      float* __restrict__ part, int n,
                                      const int* __restrict__ done) {
  if (done != nullptr && *done) return;
  const int row0 = blockIdx.x * kGatherRows;
  const int rows = min(kGatherRows, n - row0);
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int g = row0 + i;
    const float yo = ys[inv_perm[g]];
    const float a = w1[g], c = w2[g];
    y[g] = yo;
    acc[0] += yo * a;
    acc[1] += yo * c;
    acc[2] += yo * yo;
    acc[3] += c * c;
    acc[4] += a * c;
  }
  repro::block_sum5(acc, part + (size_t)blockIdx.x * 5);
}

// Stage two: dot d = sum over rows p of part[p, d], one CTA of 256
// threads per dot, f64 partial sums, fixed-order tree.
__global__ void dots_finish_kernel(const float* __restrict__ part,
                                   int n_part, float* __restrict__ out,
                                   const int* __restrict__ done) {
  if (done != nullptr && *done) return;
  __shared__ double red[256];
  const int d = blockIdx.x;
  double s = 0.0;
  for (int p = threadIdx.x; p < n_part; p += blockDim.x)
    s += (double)part[(size_t)p * 5 + d];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[d] = (float)red[0];
}

}  // namespace

REPRO_ERROR_STRING_FN(fused_iter_error_string)

extern "C" int fused_iter_gather_rows() { return kGatherRows; }

// warp_len: (n_blocks * b_r / 32,) int32 diagonals to walk per warp.
// scratch == nullptr: shared-memory slab path, part holds n_win rows of
// five; otherwise scratch holds n_blocks * b_r floats and part
// ceil(n / kGatherRows) rows.  dots receives the five scalars.  done:
// nullptr, or a device int that, when set, makes every stage return at
// once.
extern "C" int fused_spmv_dots(const void* val, int val_kind,
                               const void* col, int idx_kind,
                               const int* block_start, const int* inv_perm,
                               const int* warp_len, const float* x,
                               const float* w1, const float* w2, float* y,
                               float* part, float* dots, float* scratch,
                               const int* done, int n_blocks, int b_r,
                               int w_b, void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int n_part;
  if (scratch == nullptr) {
    n_part = (n_blocks + w_b - 1) / w_b;
    const int threads = repro::window_cta_threads(b_r, w_b, n_part);
    const size_t slab = (size_t)w_b * b_r * sizeof(float);
    REPRO_DISPATCH(val_kind, idx_kind,
                   fused_window_kernel<V, I><<<n_part, threads, slab, s>>>(
                       (const V*)val, (const I*)col, block_start, warp_len,
                       inv_perm, x, w1, w2, y, part, n_blocks, b_r, w_b,
                       done));
  } else {
    const int n = n_blocks * b_r;
    n_part = (n + kGatherRows - 1) / kGatherRows;
    REPRO_DISPATCH(val_kind, idx_kind,
                   repro::sell_block_kernel<V, I><<<n_blocks, b_r, 0, s>>>(
                       (const V*)val, (const I*)col, block_start, warp_len,
                       x, scratch, b_r, done));
    unpermute_dots_kernel<<<n_part, 256, 0, s>>>(scratch, inv_perm, w1, w2,
                                                 y, part, n, done);
  }
  dots_finish_kernel<<<5, 256, 0, s>>>(part, n_part, dots, done);
  return (int)cudaGetLastError();
}
