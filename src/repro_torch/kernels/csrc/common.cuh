// Shared pieces of the blocked spMVM kernels (pJDS / SELL-C-sigma).
//
// Storage: val/col are (total_jds, b_r) row-major -- jagged diagonals
// major, the b_r row lanes of a block minor -- so diagonal j of a block
// is b_r consecutive values: one coalesced 512-byte load for f32 when a
// CTA's threads own consecutive lanes.  Block b's diagonals are
// [block_start[b], block_start[b+1]), computed once at conversion.
//
// Padded slots hold val == 0 and col == 0 (PAD_COL): the gather of x[0]
// is not masked, exactly as in the reference, so a NaN in x[0] poisons
// the rows that carry padding there too.
//
// Every exported function returns cudaGetLastError() right after its
// launches; the Python wrapper raises on anything but 0.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The length-aware walk of K1, K2 and K3 (K5 walks the same lengths for
// a block of columns).  Lane r of row block b walks its first warp_len
// diagonals -- warp_len holds one length per 32 lanes of a block
// (ops.sell_warp_len: up to the last diagonal in which any of the 32
// holds a slot that is not exactly padding), clamped to the
// block's stored length -- four diagonals per step, so each thread has
// four value and index loads and then four gathers of x in flight.  The
// value and index streams are read once (__ldcs, evict-first), x
// through the read-only path.  One f32 accumulator, in diagonal order.
//
// Every slot past warp_len is padding (val 0, col PAD_COL), whose
// product the full walk would add as 0 * x[0]; a lane whose walk stops
// short adds 0.f * x[0] once instead.  For a finite x[0] each skipped
// term is +-0, and adding +-0 to an f32 sum that starts at +0 never
// changes it (the sum can never become -0), so y is bit for bit that of
// the full walk; a NaN or Inf in x[0] poisons the same rows.  The rule
// holds per column of a block of right-hand sides alike (K5).
template <typename V, typename I>
__device__ __forceinline__ float lane_sum(const V* __restrict__ val,
                                          const I* __restrict__ col,
                                          const int* __restrict__ block_start,
                                          const int* __restrict__ warp_len,
                                          const float* __restrict__ x,
                                          int b, int b_r, int r) {
  const int j0 = block_start[b];
  const int stored = block_start[b + 1] - j0;
  const int n = min(max(warp_len[b * (b_r >> 5) + (r >> 5)], 0), stored);
  const size_t st = (size_t)b_r;
  const V* vp = val + (size_t)j0 * st + r;
  const I* cp = col + (size_t)j0 * st + r;
  float acc = 0.f;
  int j = 0;
  for (; j + 4 <= n; j += 4, vp += 4 * st, cp += 4 * st) {
    const V v0 = __ldcs(vp), v1 = __ldcs(vp + st);
    const V v2 = __ldcs(vp + 2 * st), v3 = __ldcs(vp + 3 * st);
    const I c0 = __ldcs(cp), c1 = __ldcs(cp + st);
    const I c2 = __ldcs(cp + 2 * st), c3 = __ldcs(cp + 3 * st);
    const float x0 = __ldg(x + (int)c0), x1 = __ldg(x + (int)c1);
    const float x2 = __ldg(x + (int)c2), x3 = __ldg(x + (int)c3);
    acc += to_f32(v0) * x0;
    acc += to_f32(v1) * x1;
    acc += to_f32(v2) * x2;
    acc += to_f32(v3) * x3;
  }
  for (; j < n; ++j, vp += st, cp += st)
    acc += to_f32(__ldcs(vp)) * __ldg(x + (int)__ldcs(cp));
  if (n < stored) acc += 0.f * __ldg(x);
  return acc;
}

// Threads of a window CTA (K2, K3): one per row lane of kWindowThreads
// / b_r row blocks at a time (at least one block, at most the window's
// w_b), walking the window's blocks in turns.  One thread per row of the
// whole window (up to 1024) was about 1.2 x slower for K2 and K3 on sAMG
// (kernel_ab.py): sigma-sorted blocks differ in length, and the CTA's
// warps idled at the slab barrier until the window's longest block was
// done.  But a matrix with few windows (Poisson 512^2: 256) then leaves
// most of the card's thread slots (2048 per SM on an H100) empty, and K3
// ran 2.3 x slower there than with one thread per row; so when n_win
// CTAs of that shape cannot fill the card, each window gets as many more
// row blocks walked at once as filling it takes.  A row's sum is one
// thread's walk whatever the shape, so y's bits do not depend on it (K3's
// dots do, in their rounding, through the per-thread partials: the same
// card and matrix always give the same shape).  A CTA never exceeds
// kMaxWindowThreads (the window kernels' __launch_bounds__): a wide
// window (sigma up to 32 b_r, as the tuner builds them) of a small
// matrix would otherwise ask for up to w_b * b_r threads.
constexpr int kWindowThreads = 128;
constexpr int kMaxWindowThreads = 1024;

inline int window_cta_threads(int b_r, int w_b, int n_win) {
  int per = kWindowThreads / b_r;          // row blocks walked at once
  if (per < 1) per = 1;
  int dev = 0, sms = 0, slots = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&slots, cudaDevAttrMaxThreadsPerMultiProcessor,
                         dev);
  const long rows = (long)n_win * b_r;
  const long fill = ((long)slots * sms + rows - 1) / rows;
  if (fill > per) per = (int)fill;         // too few windows to fill it
  if (per > w_b) per = w_b;
  if (per * b_r > kMaxWindowThreads) per = kMaxWindowThreads / b_r;
  return per * b_r;
}

// The sigma-window walk of K2, shared by K3.  CTA blockIdx.x owns the
// window's row blocks [blockIdx.x * w_b, + w_b): its threads walk them
// in turns (lane_sum) and drop the sorted row sums into the
// shared-memory slab (w_b * b_r floats); after the barrier they write
// y[g] = slab[inv_perm[g] - row0] coalesced, in ORIGINAL row order, and
// hand each row they write to epi(g, y[g]).  Rows never leave their
// window, so inv_perm stays inside the slab.
template <typename V, typename I, typename Epi>
__device__ __forceinline__ void window_spmv(const V* __restrict__ val,
                                            const I* __restrict__ col,
                                            const int* __restrict__ block_start,
                                            const int* __restrict__ warp_len,
                                            const int* __restrict__ inv_perm,
                                            const float* __restrict__ x,
                                            float* __restrict__ y,
                                            float* slab, int n_blocks,
                                            int b_r, int w_b, Epi&& epi) {
  const int blk0 = blockIdx.x * w_b;
  const int nb = min(w_b, n_blocks - blk0);
  const int per = blockDim.x / b_r;
  const int r = threadIdx.x % b_r, q = threadIdx.x / b_r;
  for (int bb = q; bb < nb; bb += per)
    slab[bb * b_r + r] = lane_sum(val, col, block_start, warp_len, x,
                                  blk0 + bb, b_r, r);
  __syncthreads();
  const int row0 = blk0 * b_r;
  const int rows = nb * b_r;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int g = row0 + i;
    const float yo = slab[inv_perm[g] - row0];
    y[g] = yo;
    epi(g, yo);
  }
}

// The device-memory path of K2 and K3 (the slab would not fit): one CTA
// per row block, one thread per lane, the same walk into the sorted
// scratch vector ys, which a gather pass then unpermutes.  done: K3's
// loop latch (nullptr for K2); when set the CTA returns at once.
template <typename V, typename I>
__global__ void sell_block_kernel(const V* __restrict__ val,
                                  const I* __restrict__ col,
                                  const int* __restrict__ block_start,
                                  const int* __restrict__ warp_len,
                                  const float* __restrict__ x,
                                  float* __restrict__ ys, int b_r,
                                  const int* __restrict__ done) {
  if (done != nullptr && *done) return;
  const int b = blockIdx.x, r = threadIdx.x;
  ys[(size_t)b * b_r + r] =
      lane_sum(val, col, block_start, warp_len, x, b, b_r, r);
}

// Deterministic sum of five per-thread values over the CTA (blockDim a
// multiple of 32): warp shuffles, then warp 0 over the warp sums.  No
// atomics, so a solve repeats bit for bit.
__device__ __forceinline__ void block_sum5(float v[5], float* out) {
  __shared__ float red[5][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    float s = v[d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[d][wid] = s;
  }
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      float s = lane < n_warps ? red[d][lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) out[d] = s;
    }
  }
}

}  // namespace repro

// value kind: 0 = float32, 1 = bfloat16; index kind: 0 = int32, 1 = int16
#define REPRO_DISPATCH(VK, IK, ...)                                   \
  do {                                                                \
    if ((VK) == 0 && (IK) == 0) {                                     \
      using V = float; using I = int32_t; __VA_ARGS__;                \
    } else if ((VK) == 0 && (IK) == 1) {                              \
      using V = float; using I = int16_t; __VA_ARGS__;                \
    } else if ((VK) == 1 && (IK) == 0) {                              \
      using V = __nv_bfloat16; using I = int32_t; __VA_ARGS__;        \
    } else if ((VK) == 1 && (IK) == 1) {                              \
      using V = __nv_bfloat16; using I = int16_t; __VA_ARGS__;        \
    } else {                                                          \
      return (int)cudaErrorInvalidValue;                              \
    }                                                                 \
  } while (0)

#define REPRO_ERROR_STRING_FN(NAME)                                   \
  extern "C" const char* NAME(int code) {                             \
    return cudaGetErrorString((cudaError_t)code);                     \
  }
