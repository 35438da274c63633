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
// What bounds it on an H100: bytes -- the strip's value, index and int8
// row streams, x, y.  Two things stand between a straightforward walk
// and that bound: strips are padded to diag_align (16) tile rows, so
// the stored slots are 2.40 x nnz on the 3.4 M-row sAMG; and a CTA that
// reduces one tile row at a time needs CTA barriers per tile row, which
// leave each thread one slot in flight between them (three per tile row
// made K6 2.5-3 x slower than this design, kernel_ab.py).  This design:
//
//   * walks only a strip's real slots: strip_nnz[s], the slots up to the
//     last non-padding one, derived once at conversion
//     (ops.cmrs_strip_nnz; 1.002 x nnz on sAMG in the groups of 4 a lane
//     loads, against 2.40 x stored);
//   * gives each strip one warp (kWarps strips per CTA), which walks the
//     strip's slots as one flat run -- its tile rows are contiguous, so
//     any b_r works -- 128 slots per step, 4 per lane: one 16-byte (f32)
//     or 8-byte (bf16) load of values, one 16- or 8-byte load of indices
//     and one 4-byte load of row ids per lane, issued for step t + 1
//     before step t is reduced, so two steps' loads are in flight;
//   * reduces each step without a barrier: a segmented sum over the
//     lane's 4 slots, a segmented warp scan (shuffles) over the lanes'
//     trailing partials, and one write per finished row into the warp's
//     b_r-float accumulator in shared memory.  The row still open at the
//     end of a step carries into the next (held by every lane, folded in
//     by lane 0), so every row is written once, in a fixed order: no
//     atomics, results repeat bit for bit.  Only __syncwarp is used.
//   * stores the warp's b_r rows to y coalesced (0 for rows with no
//     slots).
//
// Padding is kept exactly.  Padding slots (val 0, col PAD_COL = 0, row
// id 0) route 0 * x[0] into row 0 of their strip in the reference, so a
// NaN or Inf in x[0] poisons row 0 of every strip that has padding.  A
// strip whose real count is below strip_len * b_r -- including strips
// whose count is a whole number of tile rows, and empty strips -- adds
// 0.f * x[0] to row 0 once after its walk.  For a finite x[0] the skipped
// terms are all +-0, and adding +-0 to an f32 sum that starts at +0
// never changes it, so y is that of the full walk; for a NaN or Inf
// x[0] row 0 turns NaN as before.  A stored explicit 0 at column 0 at
// the end of row 0 looks like padding, and contributes the same
// 0 * x[0].  strip_nnz is clamped to the stored length.
//
// The kernel also takes the full stored length (every slot walked, as a
// timing baseline).  Then a strip's padding run follows its last real
// row with row id 0, so row 0 can end two segments in one step; a
// row-0 segment that does not start at the step's first slot is written
// after a __syncwarp, so each accumulator entry has one writer at a
// time.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;       // strips per CTA
constexpr int kStep = 128;      // slots per warp step, 4 per lane

// Four consecutive slots of the value / index stream as one load.
template <typename T> struct Quad;
template <> struct Quad<float> {
  using raw = uint4;
  static __device__ __forceinline__ void unpack(raw q, float v[4]) {
    v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
  }
};
template <> struct Quad<__nv_bfloat16> {
  using raw = uint2;
  static __device__ __forceinline__ void unpack(raw q, float v[4]) {
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  }
};
template <> struct Quad<int32_t> {
  using raw = uint4;
  static __device__ __forceinline__ void unpack(raw q, int c[4]) {
    c[0] = (int)q.x; c[1] = (int)q.y; c[2] = (int)q.z; c[3] = (int)q.w;
  }
};
template <> struct Quad<int16_t> {
  using raw = uint2;
  static __device__ __forceinline__ void unpack(raw q, int c[4]) {
    c[0] = (int)(int16_t)(q.x & 0xffffu);
    c[1] = (int)(int16_t)(q.x >> 16);
    c[2] = (int)(int16_t)(q.y & 0xffffu);
    c[3] = (int)(int16_t)(q.y >> 16);
  }
};

// One lane's raw loads of one step: 4 values, 4 indices, 4 row ids.
template <typename V, typename I>
struct Slots {
  typename Quad<V>::raw v;
  typename Quad<I>::raw c;
  unsigned r;
};

// Loads the lane's 4 slots starting at strip slot t (a multiple of 4).
// Lanes whose first slot lies at or past cnt load nothing; a group that
// starts before cnt ends inside the strip's stored slots (a multiple of
// b_r), so its vector loads stay in bounds.
template <typename V, typename I>
__device__ __forceinline__ Slots<V, I> load_slots(
    const V* __restrict__ val, const I* __restrict__ col,
    const int8_t* __restrict__ ris, size_t base, int t, int cnt) {
  using RV = typename Quad<V>::raw;
  using RI = typename Quad<I>::raw;
  Slots<V, I> s;
  if (t < cnt) {
    s.v = __ldcs(reinterpret_cast<const RV*>(val + base + t));
    s.c = __ldcs(reinterpret_cast<const RI*>(col + base + t));
    s.r = __ldcs(reinterpret_cast<const unsigned*>(ris + base + t));
  } else {
    s.v = {}; s.c = {}; s.r = 0u;
  }
  return s;
}

template <typename V, typename I>
__global__ void __launch_bounds__(kWarps * 32)
    cmrs_kernel(const V* __restrict__ val, const I* __restrict__ col,
                const int8_t* __restrict__ ris,
                const int* __restrict__ strip_start,
                const int* __restrict__ strip_nnz,
                const float* __restrict__ x, float* __restrict__ y,
                int n_strips, int b_r) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + w;
  if (s >= n_strips) return;          // whole warps only; no CTA barrier
  float* acc = smem + w * b_r;
  for (int i = lane; i < b_r; i += 32) acc[i] = 0.f;
  const int sent = b_r;               // row id of slots past the walk
  const size_t base = (size_t)strip_start[s] * b_r;
  const int stored = (strip_start[s + 1] - strip_start[s]) * b_r;
  const int cnt = min(max(strip_nnz[s], 0), stored);
  __syncwarp();

  int c_id = sent;                    // row still open from the last step
  float c_val = 0.f;
  Slots<V, I> cur = load_slots(val, col, ris, base, 4 * lane, cnt);
  for (int t0 = 0; t0 < cnt; t0 += kStep) {
    const int t = t0 + 4 * lane;
    Slots<V, I> nxt = load_slots(val, col, ris, base, t + kStep, cnt);

    // products and row ids of the lane's 4 slots (slots past cnt: 0, sent)
    float v[4], p[4];
    int c[4], r[4];
    Quad<V>::unpack(cur.v, v);
    Quad<I>::unpack(cur.c, c);
    float xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = t + i < cnt ? __ldg(x + c[i]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = t + i < cnt;
      r[i] = in ? (int)(int8_t)(cur.r >> (8 * i)) : sent;
      p[i] = in ? v[i] * xv[i] : 0.f;
    }
    // the open row of the last step continues here, or is finished
    if (lane == 0) {
      if (c_id == r[0]) p[0] = c_val + p[0];
      else if (c_id != sent) acc[c_id] += c_val;
    }
    // segmented inclusive sums inside the lane
    float sv[4];
    sv[0] = p[0];
#pragma unroll
    for (int i = 1; i < 4; ++i)
      sv[i] = r[i] == r[i - 1] ? sv[i - 1] + p[i] : p[i];
    // segmented scan of the lanes' trailing partials: a lane continues
    // its predecessor's segment when all its 4 slots hold the row that
    // the predecessor ends with
    const int prev_last = __shfl_up_sync(kFull, r[3], 1);
    const bool joins = lane > 0 && prev_last == r[0];
    float tv = sv[3];
    int f = !(joins && r[0] == r[3]);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float tu = __shfl_up_sync(kFull, tv, off);
      const int fu = __shfl_up_sync(kFull, f, off);
      if (lane >= off) {
        if (!f) tv = tu + tv;
        f |= fu;
      }
    }
    const float t_prev = __shfl_up_sync(kFull, tv, 1);
    const float carry_in = joins ? t_prev : 0.f;
    const int next_first = __shfl_down_sync(kFull, r[0], 1);
    // a row-0 segment that does not start at the step's first slot
    // (only a padding run in a full walk) is written after the others
    bool nz_before =
        (__ballot_sync(kFull, r[0] != 0 || r[1] != 0 || r[2] != 0 ||
                                  r[3] != 0) &
         ((1u << lane) - 1u)) != 0u;
    float out[4];
    bool end[4], late[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nx = i < 3 ? r[i + 1] : next_first;
      end[i] = r[i] != sent && (i < 3 || lane < 31) && r[i] != nx;
      out[i] = r[i] == r[0] ? carry_in + sv[i] : sv[i];
      late[i] = r[i] == 0 && nz_before;
      nz_before = nz_before || r[i] != 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (end[i] && !late[i]) acc[r[i]] += out[i];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (end[i] && late[i]) acc[r[i]] += out[i];
    // the row open at the step's last slot carries on
    c_id = __shfl_sync(kFull, r[3], 31);
    c_val = __shfl_sync(kFull, tv, 31);
    __syncwarp();
    cur = nxt;
  }
  if (lane == 0) {
    if (c_id != sent) acc[c_id] += c_val;
    if (cnt < stored) acc[0] += 0.f * __ldg(x);
  }
  __syncwarp();
  float* ys = y + (size_t)s * b_r;
  for (int i = lane; i < b_r; i += 32) ys[i] = acc[i];
}

}  // namespace

REPRO_ERROR_STRING_FN(cmrs_spmv_error_string)

// strip_nnz: (n_strips,) int32 slots to walk per strip (at most
// strip_len * b_r; that full length walks every stored slot).
extern "C" int cmrs_spmv(const void* val, int val_kind, const void* col,
                         int idx_kind, const int8_t* ris,
                         const int* strip_start, const int* strip_nnz,
                         const float* x, float* y, int n_strips, int b_r,
                         void* stream) {
  if (n_strips <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (n_strips + kWarps - 1) / kWarps;
  const size_t shmem = (size_t)kWarps * b_r * sizeof(float);
  REPRO_DISPATCH(val_kind, idx_kind,
                 cmrs_kernel<V, I><<<grid, kWarps * 32, shmem, s>>>(
                     (const V*)val, (const I*)col, ris, strip_start,
                     strip_nnz, x, y, n_strips, b_r));
  return (int)cudaGetLastError();
}
