// K6: CMRS y = A x, rows in ORIGINAL order.
//
// Replaces the Pallas kernel repro/kernels/cmrs_spmv.py
// cmrs_matvec_kernel_call (body _cmrs_spmv_kernel).  The TPU version
// reduces each (chunk_l, b_r) chunk of a strip with a one-hot
// (chunk_l * b_r, b_r) routing matrix built from row_in_strip -- a
// segment sum phrased as an MXU matmul, 2 * b_r flops per slot.  Hopper
// needs no such detour: the slots of a strip are packed row-major, so a
// row's slots are contiguous and the reduction is a segmented sum.
//
// One CTA per strip of b_r original-order rows, one thread per lane.
// The CTA walks its strip one tile row (b_r slots) at a time; each
// thread forms val * x[col] for its slot and takes its row from the
// int8 row_in_strip stream.  Segments are runs of equal row ids:
//   1. a segmented inclusive scan inside each warp (shuffles);
//   2. a segment's tail thread adds the trailing sums of the warps
//      before it (in order, back to the warp that holds the segment's
//      head) -- one sum per segment, in a fixed order;
//   3. the tail adds that sum into the strip's accumulator acc[row] in
//      shared memory.  A row longer than b_r spans several tile rows and
//      collects one sum from each.
// No atomics: every acc[row] has one writer per phase, so results repeat
// bit for bit.  Real slots carry nondecreasing row ids, so within a tile
// each row id is one segment, except row 0, which may appear twice: the
// strip's row 0 (always the tile's first segment) and the trailing
// padding run (val 0, col PAD_COL, row 0; it always ends at the tile's
// last lane).  Phase one writes every tail but a row-0 tail before the
// last lane; phase two writes that one.  Padding therefore routes
// 0 * x[0] into row 0 exactly as the reference's kernel and plain
// version do, so a NaN in x[0] poisons the same rows.
//
// Bound on an H100: bytes -- the stored slots (value + index width + the
// int8 row stream), x, the strip offsets read once, y written once.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename V, typename I>
__global__ void cmrs_kernel(const V* __restrict__ val,
                            const I* __restrict__ col,
                            const int8_t* __restrict__ ris,
                            const int* __restrict__ strip_start,
                            const float* __restrict__ x,
                            float* __restrict__ y, int b_r) {
  extern __shared__ float smem[];
  float* acc = smem;                            // [b_r] row sums
  int* key = (int*)(acc + b_r);                 // [b_r] row id per slot
  float* wsum = (float*)(key + b_r);            // [32] warp trailing sums
  int* whead = (int*)(wsum + 32);               // [32] trailing head seen
  const int s = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, w = t >> 5;
  acc[t] = 0.f;
  const int j0 = strip_start[s], j1 = strip_start[s + 1];
  for (int j = j0; j < j1; ++j) {
    const size_t k = (size_t)j * b_r + t;
    const float p = repro::to_f32(val[k]) * __ldg(x + (int)col[k]);
    const int r = ris[k];
    key[t] = r;
    __syncthreads();
    const bool head = t == 0 || key[t - 1] != r;
    const bool tail = t == b_r - 1 || key[t + 1] != r;
    // 1. segmented inclusive scan in the warp: v sums from the
    //    segment's head (or the warp's first lane) up to this lane.
    float v = p;
    int f = head;
    for (int off = 1; off < 32; off <<= 1) {
      const float vu = __shfl_up_sync(kFull, v, off);
      const int fu = __shfl_up_sync(kFull, f, off);
      if (lane >= off) {
        if (!f) v = vu + v;
        f |= fu;
      }
    }
    if (lane == 31) {
      wsum[w] = v;
      whead[w] = f;
    }
    __syncthreads();
    // 2. carry from earlier warps; warp 0 always holds a head (t == 0)
    float tot = v;
    if (tail && !f) {
      for (int q = w - 1; q >= 0; --q) {
        tot = wsum[q] + tot;
        if (whead[q]) break;
      }
    }
    // 3. into the accumulator, row 0's leading segment last
    const bool late = r == 0 && t != b_r - 1;
    if (tail && !late) acc[r] += tot;
    __syncthreads();
    if (tail && late) acc[r] += tot;
  }
  __syncthreads();
  y[(size_t)s * b_r + t] = acc[t];
}

}  // namespace

REPRO_ERROR_STRING_FN(cmrs_spmv_error_string)

extern "C" int cmrs_spmv(const void* val, int val_kind, const void* col,
                         int idx_kind, const int8_t* ris,
                         const int* strip_start, const float* x, float* y,
                         int n_strips, int b_r, void* stream) {
  if (n_strips <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t shmem = (size_t)(2 * b_r + 64) * 4;
  REPRO_DISPATCH(val_kind, idx_kind,
                 cmrs_kernel<V, I><<<n_strips, b_r, shmem, s>>>(
                     (const V*)val, (const I*)col, ris, strip_start, x, y,
                     b_r));
  return (int)cudaGetLastError();
}
