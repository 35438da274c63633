// K7: z = A^T y (and Z = A^T Y for k columns) over a blocked or
// ELLPACK-R operand's STORED arrays -- pJDS, SELL-C-sigma, ELLPACK-R and
// CMRS -- without a copy of the values and without float atomics.
//
// Replaces no Pallas kernel: the reference computes transposes as
// jax.ops.segment_sum scatters (repro/kernels/ref.py:108-180, called by
// repro/kernels/ops.py:606-650), which XLA's CPU backend adds in
// ascending slot order.  A scatter with float atomics would add in an
// order that changes from run to run.  So the work is turned around:
// the wrapper builds, once per operand, a slot index -- the flat
// positions of the stored slots that hold more than padding, sorted
// stably by column, and a column pointer (n_cols + 1) -- and one thread
// per (column, right-hand side) walks its column's slots in ascending
// slot order, reads val[slot] and y at the slot's row, and writes z once.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn: no
// contraction into an FMA), in the plain version's order, so z is the
// plain version's bit for bit whenever y is finite (the skipped padding
// adds +-0 there).
//
// The row of a slot follows from its flat position p in the (rows, width)
// value array and the format's metadata, so the index stores 4 bytes per
// non-zero and nothing per row:
//   pJDS / SELL   row = row_block[p / b_r] * b_r + p % b_r  (sorted basis)
//   ELLPACK-R     row = p % n_pad                           (original)
//   CMRS          row = strip_map[p / b_r] * b_r + row_in_strip[p]
// i.e. row = (base ? base[p / width] * width : 0) + (ris ? ris[p] : p % width).
//
// What bounds it on an H100: bytes -- per non-zero the slot (4 B), the
// value and y at the slot's row, per column its pointer and z.  The
// value and y reads are gathers (a column's slots lie far apart in the
// stored layout), so each costs a 32-byte sector; this first design
// takes that as it is.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    transpose_kernel(const V* __restrict__ val, const int* __restrict__ slot,
                     const int* __restrict__ colptr,
                     const int* __restrict__ base,
                     const int8_t* __restrict__ ris, int width,
                     const float* __restrict__ y, float* __restrict__ z,
                     long long n_out, int k) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_out) return;
  const int c = (int)(t / k), j = (int)(t % k);
  const int s1 = colptr[c + 1];
  float acc = 0.f;
  for (int s = colptr[c]; s < s1; ++s) {
    const int p = __ldg(slot + s);
    const int d = p / width;
    int r = base ? __ldg(base + d) * width : 0;
    r += ris ? (int)__ldg(ris + p) : p - d * width;
    acc = __fadd_rn(acc, __fmul_rn(to_f32(val[p]),
                                   __ldg(y + (size_t)r * k + j)));
  }
  z[t] = acc;
}

}  // namespace

extern "C" const char* transpose_spmv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// val: the stored values (f32: val_kind 0, bf16: 1), flat; slot: the
// slot index, colptr (n_cols + 1) int32; base: per-row-of-val int32
// (row_block / strip_map) or null; ris: int8 per slot or null; width:
// the value array's row width (b_r, or n_pad for ELLPACK-R); y: (rows,
// k) f32 row-major; z: (n_cols, k) f32.
extern "C" int transpose_spmv(const void* val, int val_kind, const int* slot,
                              const int* colptr, const int* base,
                              const int8_t* ris, int width, const float* y,
                              float* z, int n_cols, int k, void* stream) {
  const long long n_out = (long long)n_cols * k;
  if (n_out <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long grid = (n_out + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (val_kind == 0) {
    transpose_kernel<float><<<(unsigned)grid, kThreads, 0, s>>>(
        (const float*)val, slot, colptr, base, ris, width, y, z, n_out, k);
  } else if (val_kind == 1) {
    transpose_kernel<__nv_bfloat16><<<(unsigned)grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)val, slot, colptr, base, ris, width, y, z,
        n_out, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
