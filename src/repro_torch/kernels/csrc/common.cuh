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
