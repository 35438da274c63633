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

// Sum of one sorted row: lane r of a block walks its diagonals,
// accumulating val * x[col] in f32 (bf16 values widen before the
// product; int16 indices widen before the gather).
template <typename V, typename I>
__device__ __forceinline__ float row_dot(const V* __restrict__ val,
                                         const I* __restrict__ col,
                                         const float* __restrict__ x,
                                         int j0, int j1, int b_r, int r) {
  float acc = 0.f;
  size_t k = (size_t)j0 * b_r + r;
  for (int j = j0; j < j1; ++j, k += b_r) {
    acc += to_f32(val[k]) * __ldg(x + (int)col[k]);
  }
  return acc;
}

// One CTA per row block, one thread per row lane: y_sorted[b*b_r + r].
template <typename V, typename I>
__global__ void block_rows_kernel(const V* __restrict__ val,
                                  const I* __restrict__ col,
                                  const int* __restrict__ block_start,
                                  const float* __restrict__ x,
                                  float* __restrict__ y, int b_r) {
  const int b = blockIdx.x, r = threadIdx.x;
  y[(size_t)b * b_r + r] =
      row_dot(val, col, x, block_start[b], block_start[b + 1], b_r, r);
}

// The length-aware walk of K1 and K2.  Lane r of row block b walks its
// first warp_len diagonals -- warp_len holds one length per 32 lanes of
// a block (ops.sell_warp_len: up to the last diagonal in which any of
// the 32 holds a slot that is not exactly padding), clamped to the
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
// the full walk; a NaN or Inf in x[0] poisons the same rows.
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

// Threads of a window CTA: one per row lane of as many row blocks as fit
// in 1024 threads (at most the window's w_b blocks).
inline int window_threads(int b_r, int w_b) {
  int per = 1024 / b_r;
  if (per < 1) per = 1;
  if (per > w_b) per = w_b;
  return per * b_r;
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
