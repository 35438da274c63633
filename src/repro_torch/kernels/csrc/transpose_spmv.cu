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
// stably by column, and a column pointer (n_cols + 1) -- and every
// column's products are added in ascending slot order, each product and
// each sum rounded on its own (__fmul_rn, __fadd_rn: no contraction into
// an FMA).  So z is the plain version's bit for bit whenever y is finite
// (the skipped padding adds +-0 there), and repeats from run to run.
//
// y's row of a slot: ELLPACK-R computes it from the slot's flat position
// p (row = p % n_pad, original order).  pJDS, SELL and CMRS read it from
// a second int32 array beside the slot index (rows, 4 bytes per
// non-zero, built once by slot_rows in transpose_spmv.py), in the
// ORIGINAL basis, -1 for a padded row.  Computing it in the kernel from
// the layout (CMRS: strip_map[p / b_r] * b_r + row_in_strip[p]; pJDS /
// SELL: row_map[row_block[p / b_r] * b_r + p % b_r]) saves the 4 bytes
// but adds two dependent gathers per slot, and was 1.14-1.25 x slower on
// sAMG at k = 1 and 4 (kernel_ab.py --k7 before that path was removed).
// For ELLPACK-R, whose computed row costs no gather, reading a stored
// row instead was 1.14 x slower at k = 1.  y is read as 0 at a row
// outside [0, n_y), so y is passed as the operator holds it, unpadded
// and unpermuted: a slot in a padded row holds +-0 and multiplies a 0,
// as it did against a zero-padded y.
//
// What bounds it on an H100: bytes -- per non-zero the slot (4 B), the
// row (4 B, where stored), the value and y at the slot's row; per column
// its pointer and z.  The value and y reads are gathers.  The first
// design (one thread per column, one slot at a time) chained three
// dependent loads per slot and re-walked the column for each right-hand
// side.  This design cuts the columns into CTA tiles of whole columns
// (tile_plan) and runs a tile one of two ways, picked per call by the
// wrapper (transpose_spmv.staged) from k:
//
//   * staged (k = 1): a tile's slots fit the 16 KB buffer (4096
//     products; a longer column has a tile of its own and streams
//     through it in chunks).  The CTA's threads stride over the tile's
//     contiguous slot range, so the index and its rows are read
//     coalesced, kUnroll slots a thread at once -- all their index
//     entries, then all their values and y entries, every gather of a
//     round in flight together -- and store each product
//     __fmul_rn(val, y) at its slot's place.  After a barrier one thread
//     per column adds its column's products from shared memory in slot
//     order and writes z once.  On sAMG it was 2.5-5 % faster than the
//     walk below on pJDS, SELL and CMRS, and tied on ELLPACK-R, in two
//     calls of kernel_ab.py --k7;
//   * walked (k > 1): runs of up to kThreads consecutive columns, a thread per
//     column; every column longer than LONG_SLOTS (128) has a tile of its own,
//     which the CTA stages as above, in chunks of the same buffer (a 1 KB
//     buffer was 3.4-4.1 x slower on a matrix with a column of 1.8 * 10^5
//     non-zeros; walking such a column on one thread, 25-51 x).  A launch with
//     no such column reserves no shared memory, which leaves more of the SM to
//     the L1 cache (16 KB cost 3-7 % at k = 4 on sAMG).  Adjacent lanes take
//     adjacent columns, whose slots sit in adjacent rows of a banded matrix,
//     so a warp's value and y gathers share sectors.  A thread loads kUnroll
//     slots at once -- all their index entries, then all their rows (stored or
//     computed), then all their values and y entries -- so a column of up to 8
//     non-zeros costs three memory latencies, not three per slot, and keeps
//     the kg sums of a block right-hand side in registers: it reads each slot,
//     row and value once, y's kg entries of a row as float4 loads where
//     aligned, and the index in aligned int4 rounds (the index is padded past
//     its end; the loads of a round's entries that belong to neighbouring
//     columns are predicated off).  Staging at k = 4 costs a serial
//     shared-memory pass per (column, j) and was 1.2-1.5 x slower on sAMG.
//
// A round of loads has no branch between them (layouts are template
// parameters, lanes past their column re-read its last slot), since a
// load behind a branch waits for the loads before it.
//
// The price of the bits: each column's sum is one serial chain of
// __fadd_rn (no tree, no split across threads), so a column of L
// non-zeros takes L dependent adds on one thread, from registers (walked)
// or from shared memory (staged); on sAMG (6.7 per column, at most 40)
// that hides behind the loads, but a column far longer than the others
// is paced by its chain of adds, and a CTA's other threads wait for it.
// Right-hand sides beyond kMaxK run as further groups (gridDim.y), each
// reading the index and values again.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinCtas = 6;     // CTAs per SM: at most 40 registers
constexpr int kUnroll = 8;      // slots a thread loads at once, k = 1
constexpr int kMaxK = 8;        // right-hand sides per CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Where y's row of a slot comes from: STORED, rows[slot's index
// position]; otherwise the ELLPACK-R rule p % width.  A template
// parameter, so a round of loads has no branch between them.
struct Layout {
  const int* rows;        // y's row of each slot of the index, or null
  int width;              // row width of val
  int n_y;                // rows of y
};

// Slots a thread loads at once for a group of KG right-hand sides: a
// multiple of 4, so the walk reads its index as aligned int4s.
template <int KG>
struct Unroll {
  static_assert(kUnroll % 4 == 0, "kUnroll must be a multiple of 4");
  static constexpr int value =
      KG == 1 ? kUnroll : (KG <= 4 && kUnroll >= 8 ? kUnroll / 2 : 4);
};

// Values and y's kg entries of the U slots at flat positions p[u], y's
// rows r[u] (read as 0 outside y's rows), every load issued before any
// is used.  The products of slots that do not count (ok false) are not
// added; with GATE their loads are predicated off (the walk's aligned
// rounds, whose extra entries belong to other columns), without it they
// are issued at the valid addresses they hold (a branch-free round).
// vec: y's group is 16-byte aligned in every row (k % 4 == 0, kg == KG
// >= 4), read as float4.
template <typename V, int KG, int U, bool GATE>
__device__ __forceinline__ void values(
    const V* __restrict__ val, const float* __restrict__ y, const Layout& L,
    int k, int j0, int kg, bool vec, const int p[U], const int r[U],
    const bool ok[U], float v[U], float yv[U][KG]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    v[u] = (!GATE || ok[u]) ? to_f32(val[p[u]]) : 0.f;
    const bool in = (!GATE || ok[u]) && r[u] >= 0 && r[u] < L.n_y;
    const float* yr = y + (size_t)(in ? r[u] : 0) * k + j0;
    if (KG >= 4 && vec) {
#pragma unroll
      for (int h = 0; h < KG / 4; ++h) {
        const float4 t = in ? __ldg((const float4*)yr + h)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        yv[u][4 * h] = t.x; yv[u][4 * h + 1] = t.y;
        yv[u][4 * h + 2] = t.z; yv[u][4 * h + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < KG; ++j)
        yv[u][j] = (in && j < kg) ? __ldg(yr + j) : 0.f;
    }
  }
}

// Four index entries from a 16-byte aligned position.
__device__ __forceinline__ void load4(const int* __restrict__ a, int at,
                                      int out[4]) {
  const int4 t = __ldg((const int4*)(a + at));
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}

// A thread per column of [c0, c1), z written once.  Adjacent lanes take
// adjacent columns, whose slots sit in adjacent rows of a banded matrix,
// so a warp's value and y gathers share sectors.  A thread reads its
// column's index in rounds of U entries -- for a block right-hand side
// aligned ones, as int4 loads (the index is padded past its end, so a
// round may start before the column and end after it) -- and adds the
// products of the entries that are its own in slot order into kg sums
// held in registers.
template <typename V, int KG, bool STORED>
__device__ __forceinline__ void walk(
    const V* __restrict__ val, const int* __restrict__ slot,
    const int* __restrict__ colptr, const Layout& L,
    const float* __restrict__ y, float* __restrict__ z, int k, int j0,
    int kg, bool vec, int c0, int c1) {
  constexpr int U = Unroll<KG>::value;
  for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
    const int a = colptr[c], b = colptr[c + 1];
    float acc[KG];
#pragma unroll
    for (int j = 0; j < KG; ++j) acc[j] = 0.f;
    for (int s = KG == 1 ? a : a & ~3; s < b; s += U) {
      int p[U], r[U];
      bool ok[U];
      float v[U], yv[U][KG];
      if (KG == 1) {
        // from the column's start, scalar loads (a column of 8 or fewer,
        // sAMG's 95th percentile is 11, takes one round)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = min(s + u, b - 1);
          p[u] = __ldg(slot + q);
          if (STORED) r[u] = __ldg(L.rows + q);
        }
      } else {
#pragma unroll
        for (int h = 0; h < U / 4; ++h) {
          load4(slot, s + 4 * h, p + 4 * h);
          if (STORED) load4(L.rows, s + 4 * h, r + 4 * h);
        }
      }
      if (!STORED)
#pragma unroll
        for (int u = 0; u < U; ++u) r[u] = p[u] % L.width;
#pragma unroll
      for (int u = 0; u < U; ++u) ok[u] = s + u >= a && s + u < b;
      values<V, KG, U, KG != 1>(val, y, L, k, j0, kg, vec, p, r, ok, v, yv);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < KG; ++j)
          if (ok[u]) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[u], yv[u][j]));
    }
    float* out = z + (size_t)c * k + j0;
    if (KG >= 4 && vec) {
#pragma unroll
      for (int h = 0; h < KG / 4; ++h)
        ((float4*)out)[h] = make_float4(acc[4 * h], acc[4 * h + 1],
                                        acc[4 * h + 2], acc[4 * h + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < KG; ++j)
        if (j < kg) out[j] = acc[j];
    }
  }
}

// Products of slots [cs, ce) into prod[(s - cs) * kg + j], the CTA's
// threads striding over the slots (the index read coalesced), U slots a
// thread at once.
template <typename V, int KG, bool STORED>
__device__ __forceinline__ void stage(
    const V* __restrict__ val, const int* __restrict__ slot, const Layout& L,
    const float* __restrict__ y, int k, int j0, int kg, bool vec, int cs,
    int ce, float* prod) {
  constexpr int U = Unroll<KG>::value;
  for (int s = cs + threadIdx.x; s < ce; s += kThreads * U) {
    int p[U], r[U];
    bool ok[U];
    float v[U], yv[U][KG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = min(s + u * kThreads, ce - 1);
      ok[u] = s + u * kThreads < ce;
      p[u] = __ldg(slot + q);
      r[u] = STORED ? __ldg(L.rows + q) : p[u] % L.width;
    }
    values<V, KG, U, false>(val, y, L, k, j0, kg, vec, p, r, ok, v, yv);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      float* out = prod + (size_t)(s + u * kThreads - cs) * kg;
      if (KG >= 4 && vec) {
#pragma unroll
        for (int h = 0; h < KG / 4; ++h)
          ((float4*)out)[h] = make_float4(
              __fmul_rn(v[u], yv[u][4 * h]), __fmul_rn(v[u], yv[u][4 * h + 1]),
              __fmul_rn(v[u], yv[u][4 * h + 2]),
              __fmul_rn(v[u], yv[u][4 * h + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < KG; ++j)
          if (j < kg) out[j] = __fmul_rn(v[u], yv[u][j]);
      }
    }
  }
}

template <typename V, int KG, bool STORED>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    transpose_tile_kernel(const V* __restrict__ val,
                          const int* __restrict__ slot,
                          const int* __restrict__ colptr,
                          const int* __restrict__ tiles, Layout L,
                          const float* __restrict__ y, float* __restrict__ z,
                          int k, int tile_slots, bool stage_all, bool vec) {
  extern __shared__ float4 smem[];
  float* prod = (float*)smem;
  const int j0 = blockIdx.y * kMaxK;
  const int kg = min(k - j0, KG);
  vec = vec && kg == KG;         // a last, narrower group reads scalars
  const int c0 = tiles[blockIdx.x], c1 = tiles[blockIdx.x + 1];
  const int s0 = colptr[c0], s1 = colptr[c1];
  // several columns are walked, unless they are staged and fit the
  // buffer; one column is staged, unless there is no buffer (any plan
  // gives the same bits)
  if (tile_slots == 0 ||
      (c1 - c0 > 1 && (!stage_all || s1 - s0 > tile_slots))) {
    walk<V, KG, STORED>(val, slot, colptr, L, y, z, k, j0, kg, vec, c0, c1);
    return;
  }
  if (s1 - s0 <= tile_slots) {
    // a tile that fits the buffer: stage, then one sum per (column, j)
    stage<V, KG, STORED>(val, slot, L, y, k, j0, kg, vec, s0, s1, prod);
    __syncthreads();
    for (int q = threadIdx.x; q < (c1 - c0) * kg; q += kThreads) {
      const int c = c0 + q / kg, j = q - (q / kg) * kg;
      const int a = colptr[c] - s0, b = colptr[c + 1] - s0;
      float acc = 0.f;
      for (int i = a; i < b; ++i) acc = __fadd_rn(acc, prod[i * kg + j]);
      z[(size_t)c * k + j0 + j] = acc;
    }
    return;
  }
  // one column longer than the buffer: chunks of tile_slots, the sums
  // carried in the first kg threads' registers
  float acc = 0.f;
  for (int cs = s0; cs < s1; cs += tile_slots) {
    const int ce = min(cs + tile_slots, s1);
    stage<V, KG, STORED>(val, slot, L, y, k, j0, kg, vec, cs, ce, prod);
    __syncthreads();
    if (threadIdx.x < kg)
      for (int i = 0; i < ce - cs; ++i)
        acc = __fadd_rn(acc, prod[i * kg + threadIdx.x]);
    __syncthreads();
  }
  if (threadIdx.x < kg) z[(size_t)c0 * k + j0 + threadIdx.x] = acc;
}

template <typename V, int KG, bool STORED>
int launch(const V* val, const int* slot, const int* colptr,
           const int* tiles, int n_tiles, const Layout& L, const float* y,
           float* z, int k, int tile_slots, bool stage, cudaStream_t s) {
  const int kg = k < KG ? k : KG;
  const size_t bytes = (size_t)tile_slots * kg * sizeof(float);
  const auto kern = transpose_tile_kernel<V, KG, STORED>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = KG >= 4 && k % 4 == 0 && ((uintptr_t)y & 15) == 0 &&
                   ((uintptr_t)z & 15) == 0;
  const dim3 grid((unsigned)n_tiles, (unsigned)((k + kMaxK - 1) / kMaxK));
  kern<<<grid, kThreads, bytes, s>>>(val, slot, colptr, tiles, L, y, z, k,
                                     tile_slots, stage, vec);
  return (int)cudaGetLastError();
}

template <typename V, bool STORED>
int by_width(const V* val, const int* slot, const int* colptr,
             const int* tiles, int n_tiles, const Layout& L, const float* y,
             float* z, int k, int tile_slots, bool stage, cudaStream_t s) {
  if (k == 1)
    return launch<V, 1, STORED>(val, slot, colptr, tiles, n_tiles, L, y,
                                z, k, tile_slots, stage, s);
  if (k <= 4)
    return launch<V, 4, STORED>(val, slot, colptr, tiles, n_tiles, L, y,
                                z, k, tile_slots, stage, s);
  return launch<V, kMaxK, STORED>(val, slot, colptr, tiles, n_tiles, L, y,
                                  z, k, tile_slots, stage, s);
}

template <typename V>
int dispatch(const V* val, const int* slot, const int* colptr,
             const int* tiles, int n_tiles, const Layout& L, const float* y,
             float* z, int k, int tile_slots, bool stage, cudaStream_t s) {
  return L.rows ? by_width<V, true>(val, slot, colptr, tiles, n_tiles, L, y,
                                    z, k, tile_slots, stage, s)
                : by_width<V, false>(val, slot, colptr, tiles, n_tiles, L, y,
                                     z, k, tile_slots, stage, s);
}

}  // namespace

extern "C" const char* transpose_spmv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// val: the stored values (f32: val_kind 0, bf16: 1), flat; slot: the
// slot index, colptr (n_cols + 1) int32; rows: y's row of each slot of
// the index (-1 for a padded row), or null for ELLPACK-R (p % width);
// tiles (n_tiles + 1) int32: the first column of each tile (tile_plan);
// width: the value array's row width (b_r, or n_pad for ELLPACK-R); y:
// (n_y, k) f32 row-major, read as 0 outside its rows; z: (n_cols, k) f32;
// tile_slots: the shared-memory buffer, in slots (0: none, every tile
// walked); stage: stage every tile whose slots fit it (otherwise only
// one-column tiles are staged).
extern "C" int transpose_spmv(const void* val, int val_kind, const int* slot,
                              const int* rows, const int* colptr,
                              const int* tiles, int n_tiles, int width,
                              int n_y, const float* y, float* z, int k,
                              int tile_slots, int stage, void* stream) {
  if (n_tiles <= 0 || k <= 0) return 0;
  if (tile_slots < 0 || (stage && tile_slots < 1) || width < 1 ||
      (k + kMaxK - 1) / kMaxK > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout L{rows, width, n_y};
  cudaStream_t s = (cudaStream_t)stream;
  if (val_kind == 0)
    return dispatch((const float*)val, slot, colptr, tiles, n_tiles, L, y, z,
                    k, tile_slots, stage != 0, s);
  if (val_kind == 1)
    return dispatch((const __nv_bfloat16*)val, slot, colptr, tiles, n_tiles,
                    L, y, z, k, tile_slots, stage != 0, s);
  return (int)cudaErrorInvalidValue;
}
