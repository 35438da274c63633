// K5: pJDS Y = A X for a block of k right-hand sides, in the permuted
// basis or, under a row map, in the original row order.
//
// Replaces the Pallas kernel repro/kernels/pjds_spmm.py
// pjds_matmat_kernel_call (body _pjds_spmm_kernel).  The TPU version
// keeps a (b_r, rhs_t) output block pinned in VMEM across a row block's
// chunks and gathers (chunk_l, b_r) rows of a resident X tile per step.
// Here, as in K1, one CTA owns one row block and one thread one row
// lane; the thread keeps a register tile of KT accumulators (KT = 1, 2,
// 4 or 8 columns of Y).  X is row-major (n_cols_pad, k), so the gathered
// row X[col, c0 : c0 + KT] is KT contiguous floats: one or two 16-byte
// loads when k is a multiple of 4, scalar loads otherwise; the thread's
// row of Y is stored the same way (Y is allocated by the wrapper, so a
// row of k % 4 == 0 floats is 16-byte aligned).  k above 8 runs
// ceil(k / 8) column tiles on the grid's y axis; each re-reads the
// matrix stream, which stays in L2 only for small matrices.
//
// Two walks.  The LANE walk (spmm_kernel) is the design above and below:
// one thread a row lane walks the lane's diagonals serially.  It fits
// operands of many short rows (sAMG: 3.4 M rows of ~20 diagonals).  An
// FFN weight is the opposite: qwen2.5-14b's w1^T has 13,824 rows of 519
// stored diagonals, w2^T 5,120 rows of 1,398, so one thread a row fills
// 2-5 % of an H100's 270,336 resident threads and each walks hundreds of
// dependent gathers.  The SPLIT walk (spmm_split_kernel, below) gives
// the 32 row lanes of one warp_len entry a CTA of S warps, each walking
// one contiguous slice of their [0, warp_len) diagonals with the loads
// coalesced as here (a diagonal of 32 lanes is 32 consecutive slots),
// and adds the S partials of each (row, column) in slice order through
// shared memory, then the skipped padding's 0 * X[0, c]: no atomics, so
// two calls give the same bits, and a NaN or Inf in X[0, c] poisons the
// same rows of column c as the lane walk and the plain version.  Its
// column tiles are up to 16 wide: past 4 columns 2 or 4 lanes share a
// row, 4 columns each, so that a warp-wide gather reads runs of 32 or
// 64 bytes of X's rows.  Which walk, S and the tile are the host's
// plan (pjds_spmm.py, split_plan), from the operand's shape and the SM
// count.
//
// What bounds it on an H100: bytes.  Under the operator K5 runs on
// SELL's (or pJDS's) layout, whose blocks store every lane to the
// block's longest row rounded up to diag_align: 2.70 x nnz slots on the
// 3.4 M-row sAMG's SELL layout.  So each lane walks only its warp's
// derived warp_len diagonals (ops.sell_warp_len, the lengths K1 and K2
// walk: 1.05 x nnz there), clamped to the block's stored length, and
// issues the value/index loads (__ldcs, read once) and then the X-row
// gathers (__ldg) of kStep* diagonals before their FMAs, so that many
// loads are in flight per thread.  The bytes it must move are the
// walked slots times (value + index width) per column tile, X read and
// Y written once; 2 k flops per slot, so the flop bound only matters
// for k in the hundreds.
//
// Padding is kept exactly, per column.  Every slot past warp_len is
// padding (val 0, col PAD_COL = 0), whose products the full walk would
// add as 0 * X[0, c]; a lane whose warp stops short adds 0.f * X[0, c]
// once for each of its columns instead.  For a finite X[0, c] that
// leaves column c's sum bit for bit that of the full walk (common.cuh,
// lane_sum, says why), and a NaN or Inf in X[0, c] poisons column c of
// the same rows as the full walk and the plain version.
//
// With a row map (out_row != nullptr, one int32 per stored row lane)
// the thread of row lane p stores its KT sums at Y row out_row[p]
// instead of row p, and a lane mapped to -1 (a padding row) stores
// nothing: the operator's unpermute back to the original row order is
// folded into the store, as K2 folds its own.  The map is a bijection
// onto the rows of Y, so every row is written exactly once.
#include "common.cuh"

namespace {

// Diagonals per step for a tile of KT columns: their value and index
// loads, then their X-row gathers, are all issued before the first FMA.
// More registers per thread past about 32-40 cost occupancy (ptxas -v,
// in the build log); kernel_ab.py times the alternatives.  X is
// gathered through the read-only path (__ldg), whose L1 catches the
// columns that neighbouring rows share: through L2 only (__ldcg) K5 ran
// 1.25-1.31 x slower on sAMG.
constexpr int kStepNarrow = 4;   // KT = 1, 2
constexpr int kStepK4 = 4;       // KT = 4
constexpr int kStepK8 = 2;       // KT = 8

template <int KT>
__host__ __device__ constexpr int step_of() {
  return KT == 8 ? kStepK8 : KT == 4 ? kStepK4 : kStepNarrow;
}

// xv[q] = X[c, c0 + q] for q < kt (xr points at X[c, c0]), 0 past kt;
// 16-byte loads when vec4.
template <int KT>
__device__ __forceinline__ void load_row(const float* __restrict__ xr,
                                         int kt, int vec4, float (&xv)[KT]) {
  if (KT >= 4 && vec4) {
#pragma unroll
    for (int q = 0; q < KT / 4; ++q) {
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * q < kt) u = __ldg((const float4*)xr + q);
      xv[4 * q + 0] = u.x;
      xv[4 * q + 1] = u.y;
      xv[4 * q + 2] = u.z;
      xv[4 * q + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < KT; ++q) xv[q] = q < kt ? __ldg(xr + q) : 0.f;
  }
}

template <typename V, typename I, int KT>
__global__ void spmm_kernel(const V* __restrict__ val,
                            const I* __restrict__ col,
                            const int* __restrict__ block_start,
                            const int* __restrict__ warp_len,
                            const float* __restrict__ X,
                            const int* __restrict__ out_row,
                            float* __restrict__ Y, int b_r, int k,
                            int vec4) {
  constexpr int U = step_of<KT>();
  const int b = blockIdx.x, r = threadIdx.x;
  const int row = out_row ? out_row[(size_t)b * b_r + r] : b * b_r + r;
  if (row < 0) return;  // padding lane under a row map: no output row
  const int c0 = blockIdx.y * KT;
  const int kt = min(KT, k - c0);
  const int j0 = block_start[b];
  const int stored = block_start[b + 1] - j0;
  const int n = min(max(warp_len[b * (b_r >> 5) + (r >> 5)], 0), stored);
  const size_t st = (size_t)b_r;
  const V* vp = val + (size_t)j0 * st + r;
  const I* cp = col + (size_t)j0 * st + r;
  const float* xc = X + c0;
  float acc[KT];
#pragma unroll
  for (int q = 0; q < KT; ++q) acc[q] = 0.f;
  int j = 0;
  for (; j + U <= n; j += U, vp += U * st, cp += U * st) {
    float v[U];
    int c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = repro::to_f32(__ldcs(vp + u * st));
      c[u] = (int)__ldcs(cp + u * st);
    }
    float xv[U][KT];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_row<KT>(xc + (size_t)c[u] * k, kt, vec4, xv[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int q = 0; q < KT; ++q) acc[q] += v[u] * xv[u][q];
    }
  }
  for (; j < n; ++j, vp += st, cp += st) {
    const float v = repro::to_f32(__ldcs(vp));
    float xv[KT];
    load_row<KT>(xc + (size_t)(int)__ldcs(cp) * k, kt, vec4, xv);
#pragma unroll
    for (int q = 0; q < KT; ++q) acc[q] += v * xv[q];
  }
  if (n < stored) {       // the skipped padding's 0 * X[0, c], once
    float xv[KT];
    load_row<KT>(xc, kt, vec4, xv);
#pragma unroll
    for (int q = 0; q < KT; ++q) acc[q] += 0.f * xv[q];
  }
  float* yr = Y + (size_t)row * k + c0;
  if (KT >= 4 && vec4) {
#pragma unroll
    for (int q = 0; q < KT / 4; ++q)
      if (4 * q < kt)
        ((float4*)yr)[q] = make_float4(acc[4 * q + 0], acc[4 * q + 1],
                                       acc[4 * q + 2], acc[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < KT; ++q)
      if (q < kt) yr[q] = acc[q];
  }
}

template <typename V, typename I>
cudaError_t launch(const V* val, const I* col, const int* block_start,
                   const int* warp_len, const float* X, const int* out_row,
                   float* Y, int n_blocks, int b_r, int k, int vec4,
                   cudaStream_t s) {
  if (k == 1) {
    spmm_kernel<V, I, 1><<<dim3(n_blocks, 1), b_r, 0, s>>>(
        val, col, block_start, warp_len, X, out_row, Y, b_r, k, vec4);
  } else if (k == 2) {
    spmm_kernel<V, I, 2><<<dim3(n_blocks, 1), b_r, 0, s>>>(
        val, col, block_start, warp_len, X, out_row, Y, b_r, k, vec4);
  } else if (k <= 4) {
    spmm_kernel<V, I, 4><<<dim3(n_blocks, 1), b_r, 0, s>>>(
        val, col, block_start, warp_len, X, out_row, Y, b_r, k, vec4);
  } else {
    spmm_kernel<V, I, 8><<<dim3(n_blocks, (k + 7) / 8), b_r, 0, s>>>(
        val, col, block_start, warp_len, X, out_row, Y, b_r, k, vec4);
  }
  return cudaGetLastError();
}

// ---- the split walk ----------------------------------------------------

// Diagonals a slice issues per step (their value and index loads, then
// the X gathers, before the FMAs) when a lane sums one row; a lane that
// sums LPR rows issues max(1, kSplitStep / LPR) diagonals' gathers, LPR
// each.  At most kMaxSlices warps a CTA (512 threads, so up to 128
// registers a thread).  Slice s of S takes the contiguous run of
// diagonals [s c, s c + c), c = ceil(n / S).
constexpr int kSplitStep = 4;
constexpr int kMaxSlices = 16;

// The CTA of warp_len entry g = blockIdx.x and column tile blockIdx.y:
// row lanes r0 .. r0 + 31 of block b = g / (b_r / 32), whose walked
// diagonals its S = blockDim.x / 32 warps split into slices.  A column
// tile holds TC = KT * LPR columns: lane l owns the KT columns from KT
// (l % LPR) and the LPR rows l / LPR + (32 / LPR) i, i < LPR, so one
// warp-wide gather reads 32 / LPR rows of X, TC contiguous floats each
// (with LPR = 1 a lane sums its own row, KT columns).  Each diagonal's
// values and indices are read coalesced, one per row lane, and passed
// to the lanes that use them by warp shuffles.  Every (row, column) is
// summed in diagonal order within its slice; then the warps add their
// partials into one shared buffer, [32][TC + 1] (padded against bank
// conflicts), in turn s = 0 .. S-1, and the skipped padding's
// 0 * X[0, c] goes on last: one small buffer leaves the SM's L1 to the
// gathers of X.
template <typename V, typename I, int KT, int LPR>
__global__ void __launch_bounds__(kMaxSlices * 32) spmm_split_kernel(
    const V* __restrict__ val, const I* __restrict__ col,
    const int* __restrict__ block_start, const int* __restrict__ warp_len,
    const float* __restrict__ X, const int* __restrict__ out_row,
    float* __restrict__ Y, int b_r, int k, int vec4) {
  constexpr int TC = KT * LPR, RPI = 32 / LPR, P = TC + 1;
  constexpr int U = kSplitStep / LPR > 0 ? kSplitStep / LPR : 1;
  __shared__ float sum[32 * P];
  const int S = blockDim.x >> 5, s = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, p = lane / LPR, qg = lane % LPR;
  const int g = blockIdx.x, wpb = b_r >> 5;
  const int b = g / wpb;
  const int r0 = (g - b * wpb) * 32;          // the warp's first row lane
  const size_t lane0 = (size_t)b * b_r + r0;  // ... as a stored row
  const int jb = block_start[b];
  const int stored = block_start[b + 1] - jb;
  const int n = min(max(warp_len[g], 0), stored);
  const int chunk = (n + S - 1) / S;
  const int j0 = min(n, s * chunk), j1 = min(n, j0 + chunk);
  const size_t st = (size_t)b_r;
  const int c0 = blockIdx.y * TC, kt = min(TC, k - c0);
  const int cl = c0 + KT * qg;                // the lane's first column
  const int ktl = k - cl;                     // its columns in X (may be <= 0)
  float acc[LPR][KT];
#pragma unroll
  for (int i = 0; i < LPR; ++i)
#pragma unroll
    for (int q = 0; q < KT; ++q) acc[i][q] = 0.f;
  const V* sv = val + ((size_t)jb + j0) * st + r0 + lane;
  const I* sc = col + ((size_t)jb + j0) * st + r0 + lane;
  for (int j = j0; j < j1; j += U, sv += U * st, sc += U * st) {
    const int nu = min(U, j1 - j);            // warp-uniform
    float v[U];
    int c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = u < nu ? repro::to_f32(__ldcs(sv + u * st)) : 0.f;
      c[u] = u < nu ? (int)__ldcs(sc + u * st) : 0;
    }
    float xv[U][LPR][KT], vr[U][LPR];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < LPR; ++i) {
        const int src = i * RPI + p;          // the row lane summed here
        const int cr = LPR == 1 ? c[u] : __shfl_sync(~0u, c[u], src);
        vr[u][i] = LPR == 1 ? v[u] : __shfl_sync(~0u, v[u], src);
        load_row<KT>(X + (size_t)cr * k + cl, ktl, vec4, xv[u][i]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < nu) {
#pragma unroll
        for (int i = 0; i < LPR; ++i)
#pragma unroll
          for (int q = 0; q < KT; ++q) acc[i][q] += vr[u][i] * xv[u][i][q];
      }
    }
  }
  // the partials, in slice order: warp 0 stores, warp u adds in turn
  for (int u = 0; u < S; ++u) {
    if (s == u) {
#pragma unroll
      for (int i = 0; i < LPR; ++i)
#pragma unroll
        for (int q = 0; q < KT; ++q) {
          float* a = sum + (i * RPI + p) * P + KT * qg + q;
          *a = u == 0 ? acc[i][q] : *a + acc[i][q];
        }
    }
    __syncthreads();
  }
  // thread i stores (row lane i / TC, column i % TC)
  for (int i = threadIdx.x; i < 32 * TC; i += blockDim.x) {
    const int l = i / TC, q = i - l * TC;
    if (q >= kt) continue;
    float y = sum[l * P + q];
    if (n < stored) y += 0.f * __ldg(X + c0 + q);  // skipped padding
    const int row = out_row ? out_row[lane0 + l] : (int)(lane0 + l);
    if (row >= 0) Y[(size_t)row * k + c0 + q] = y;
  }
}

template <typename V, typename I, int KT, int LPR>
cudaError_t launch_split_tile(const V* val, const I* col,
                              const int* block_start, const int* warp_len,
                              const float* X, const int* out_row, float* Y,
                              int n_blocks, int b_r, int k, int vec4,
                              int slices, cudaStream_t s) {
  constexpr int TC = KT * LPR;
  const dim3 grid(n_blocks * (b_r / 32), (k + TC - 1) / TC);
  spmm_split_kernel<V, I, KT, LPR><<<grid, slices * 32, 0, s>>>(
      val, col, block_start, warp_len, X, out_row, Y, b_r, k, vec4);
  return cudaGetLastError();
}

// (kt, lanes_per_row): the column tile the host picks (pjds_spmm.py,
// column_tile); kernel_ab.py --k5-ffn also builds (4, 8).
template <typename V, typename I>
cudaError_t launch_split(const V* val, const I* col, const int* block_start,
                         const int* warp_len, const float* X,
                         const int* out_row, float* Y, int n_blocks, int b_r,
                         int k, int vec4, int kt, int lanes_per_row,
                         int slices, cudaStream_t s) {
  if (slices < 1 || slices > kMaxSlices) return cudaErrorInvalidValue;
#define REPRO_SPLIT(KT, LPR)                                              \
  return launch_split_tile<V, I, KT, LPR>(val, col, block_start,         \
                                          warp_len, X, out_row, Y,       \
                                          n_blocks, b_r, k, vec4, slices, s)
  switch (kt * 100 + lanes_per_row) {
    case 101: REPRO_SPLIT(1, 1);
    case 201: REPRO_SPLIT(2, 1);
    case 401: REPRO_SPLIT(4, 1);
    case 402: REPRO_SPLIT(4, 2);
    case 404: REPRO_SPLIT(4, 4);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SPLIT
}

}  // namespace

REPRO_ERROR_STRING_FN(pjds_spmm_error_string)

// warp_len: (n_blocks * b_r / 32,) int32 diagonals to walk per warp.
// X: (n_cols_pad, k) row-major f32; Y row-major f32, (n_blocks * b_r, k)
// without a row map, (number of mapped rows, k) with one.
// vec4 != 0 promises k % 4 == 0 and X and Y 16-byte aligned (float4
// loads and stores).
extern "C" int pjds_spmm(const void* val, int val_kind, const void* col,
                         int idx_kind, const int* block_start,
                         const int* warp_len, const float* X,
                         const int* out_row, float* Y, int n_blocks, int b_r,
                         int k, int vec4, void* stream) {
  if (n_blocks <= 0 || k <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH(val_kind, idx_kind,
                 return (int)launch<V, I>((const V*)val, (const I*)col,
                                          block_start, warp_len, X, out_row,
                                          Y, n_blocks, b_r, k, vec4, s));
  return 0;
}

// The split walk (spmm_split_kernel): operands and vec4 as pjds_spmm;
// kt columns a lane and lanes_per_row lanes a row ((kt, lanes_per_row)
// in (1, 1), (2, 1), (4, 1), (4, 2), (4, 4): column tiles of
// kt * lanes_per_row), slices = S warps per 32 row lanes (1 .. 16).
extern "C" int pjds_spmm_split(const void* val, int val_kind,
                               const void* col, int idx_kind,
                               const int* block_start, const int* warp_len,
                               const float* X, const int* out_row, float* Y,
                               int n_blocks, int b_r, int k, int vec4,
                               int kt, int lanes_per_row, int slices,
                               void* stream) {
  if (n_blocks <= 0 || k <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH(val_kind, idx_kind,
                 return (int)launch_split<V, I>(
                     (const V*)val, (const I*)col, block_start, warp_len, X,
                     out_row, Y, n_blocks, b_r, k, vec4, kt, lanes_per_row,
                     slices, s));
  return 0;
}
