// The fused Krylov loop's scalar work and vector updates, on the card.
//
// Replaces no Pallas kernel: the reference runs each fused solve inside
// jax.lax.while_loop (repro/core/solvers.py, _fused_cg body :587 and
// _fused_bicgstab body :632), where XLA fuses the scalar recurrences and
// the axpys around each K3 pass.  Here they are two kinds of kernel, so
// a whole chunk of iterations -- K3, step, update -- can be captured as
// one CUDA graph and replayed with one host read per chunk:
//
// * krylov_step: ONE thread.  It reads K3's (5,) dots, flushes float32
//   subnormals to 0 (as the host reads of the composed loops do), works
//   out alpha / beta / omega and the clamped look-ahead residual, runs
//   the failure latch (_health: checkpoints every 500 iterations, the
//   1e12 divergence bound, the breakdown predicates) and the exit test,
//   increments k and latches `done`; k never passes maxiter.  Every f32
//   operation is an explicit round-to-nearest intrinsic in the order of
//   the plain version (kernels/ref.py, krylov_step_ref), so nvcc cannot
//   contract a multiply and an add into an FMA and the step gives the
//   plain version's bits.
// * krylov_update_*: the element-wise vector updates of one iteration
//   (CG: x += alpha p, r -= alpha Ap, p = r + beta p in one pass;
//   BiCGStab: p before pass one, s between the passes, x and r after
//   pass two), four elements per thread in 16-byte loads, the scalars
//   read from device memory.  Bound on an H100: bytes, every vector read
//   once and written once.
//
// State: fs (float32) and is (int32) hold the scalars at the slots
// named below (kernels/krylov_step.py keeps the same numbering).  Once
// `done` is set every kernel of the loop -- K3 included -- returns
// before touching memory, so an iteration after the exit costs a few
// near-empty launches and leaves every carrier as it was.  `skip` is
// `done` as it stood when the iteration began (the update after the
// last step must still run).
#include <cuda_runtime.h>
#include <math.h>

namespace {

// fs slots
constexpr int kTol = 0, kB2 = 1, kRs = 2, kBest = 3, kAlpha = 4, kBeta = 5,
              kOmega = 6, kRho = 7, kRhatV = 8;
// is slots
constexpr int kK = 0, kMaxiter = 1, kFlag = 2, kSince = 3, kDone = 4,
              kSkip = 5;
// step kinds
constexpr int kInit = 0, kCg = 1, kBicg1 = 2, kBicg2 = 3;
// status codes (core/solvers.py)
constexpr int kNonFinite = 4, kBreakdown = 2, kDiverged = 3;

// float32 constants, bit for bit numpy's float32 of the reference's
// float64 literals
constexpr float kTiny = 0x1.4484cp-100f;          // 1e-30
constexpr float kDiverge = 0x1.d1a94ap+39f;       // 1e12
constexpr float kKeep = 0x1.fae148p-1f;           // 1 - 0.01
constexpr float kTinyNormal = 0x1p-126f;          // smallest normal
constexpr int kWindow = 500;

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kTinyNormal ? 0.f : v;
}
// numpy's maximum: NaN propagates, and a tie returns b
__device__ __forceinline__ float maxnan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ float nz(float d) { return d == 0.f ? kTiny : d; }
__device__ __forceinline__ float safe(float d) {
  return fabsf(d) > kTiny ? d : kTiny;
}
__device__ __forceinline__ bool not_done(float rel2, float tol) {
  return tol <= 0.f || (isfinite(rel2) && rel2 > __fmul_rn(tol, tol));
}

// One failure-detection step (core/solvers.py _health): updates flag,
// best and since in place; flag latches the first failure.
__device__ void health(float* fs, int* is, float rel2, bool breakdown,
                       bool check) {
  const bool finite = isfinite(rel2);
  const int since = is[kSince] + 1;
  const bool at_ckpt = since % kWindow == 0;
  const bool progressed = finite && rel2 <= __fmul_rn(fs[kBest], kKeep);
  const bool stalled = at_ckpt && !progressed && since >= 2 * kWindow;
  int nw = !finite ? kNonFinite
         : breakdown ? kBreakdown
         : rel2 > kDiverge ? kDiverged
         : stalled ? kBreakdown : 0;
  if (!check) nw = 0;
  if (at_ckpt) fs[kBest] = rel2;
  is[kSince] = (at_ckpt && progressed) ? 0 : since;
  if (is[kFlag] == 0) is[kFlag] = nw;
}

// After an iteration: k + 1, and done unless the loop goes on.
__device__ void advance(float* fs, int* is) {
  const int k = is[kK] + 1;
  is[kK] = k;
  const float rel2 = __fdiv_rn(fs[kRs], fs[kB2]);
  is[kDone] = !(is[kFlag] == 0 && not_done(rel2, fs[kTol]) &&
                k < is[kMaxiter]);
}

__global__ void step_kernel(int kind, float* __restrict__ fs,
                            int* __restrict__ is,
                            const float* __restrict__ dots, float tol,
                            int maxiter) {
  if (kind == kInit) {
    // dots = [<r,r>, <b,b>] of a (re)start
    fs[kTol] = tol;
    is[kMaxiter] = maxiter;
    const float rs = flush(dots[0]);
    const float b2 = maxnan(flush(dots[1]), kTiny);
    const float rel2 = __fdiv_rn(rs, b2);
    const bool finite = isfinite(rel2);
    is[kFlag] = (tol > 0.f && !finite) ? kNonFinite : 0;
    fs[kBest] = finite ? rel2 : INFINITY;
    is[kSince] = 0;
    is[kK] = 0;
    fs[kRs] = rs;
    fs[kB2] = b2;
    // BiCGStab: rho_1 = rho_0 = <r,r>, alpha = omega = 1, so the first
    // beta is (rho/rho)(alpha/omega) and p_1 = r
    fs[kRho] = rs;
    fs[kAlpha] = 1.f;
    fs[kOmega] = 1.f;
    fs[kBeta] = __fmul_rn(__fdiv_rn(rs, safe(rs)), __fdiv_rn(1.f, safe(1.f)));
    is[kDone] = !(is[kFlag] == 0 && not_done(rel2, tol) && 0 < maxiter);
    is[kSkip] = is[kDone];
    return;
  }
  if (kind == kBicg1) {
    // dots = [<v,rhat>, ...] of pass one: alpha = rho / <rhat, v>
    if (is[kDone]) return;
    const float rhat_v = flush(dots[0]);
    fs[kRhatV] = rhat_v;
    fs[kAlpha] = __fdiv_rn(fs[kRho], safe(rhat_v));
    return;
  }
  is[kSkip] = is[kDone];
  if (is[kDone]) return;
  const bool check = fs[kTol] > 0.f;
  const float b2 = fs[kB2];
  if (kind == kCg) {
    // dots = [<Ap,p>, <Ap,r>, <Ap,Ap>, <r,r>, <p,r>]
    const float pap = flush(dots[0]), r_ap = flush(dots[1]);
    const float apap = flush(dots[2]), rr = flush(dots[3]);
    const bool bad = check && (pap <= 0.f || !isfinite(pap));
    const float alpha = bad ? 0.f : __fdiv_rn(rr, nz(pap));
    const float t = __fsub_rn(rr, __fmul_rn(__fmul_rn(2.f, alpha), r_ap));
    const float rs = maxnan(
        __fadd_rn(t, __fmul_rn(__fmul_rn(alpha, alpha), apap)), 0.f);
    health(fs, is, __fdiv_rn(rs, b2), bad, check);
    fs[kAlpha] = alpha;
    fs[kBeta] = __fdiv_rn(rs, maxnan(rr, kTiny));
    fs[kRs] = rs;
    advance(fs, is);
    return;
  }
  if (kind == kBicg2) {
    // dots = [<t,rhat>, <t,s>, <t,t>, <s,s>, <rhat,s>] of pass two
    const float t_rhat = flush(dots[0]), t_s = flush(dots[1]);
    const float tt = flush(dots[2]), ss = flush(dots[3]);
    const float rhat_s = flush(dots[4]);
    const float omega = __fdiv_rn(t_s, safe(tt));
    const float u = __fsub_rn(ss, __fmul_rn(__fmul_rn(2.f, omega), t_s));
    const float rs = maxnan(
        __fadd_rn(u, __fmul_rn(__fmul_rn(omega, omega), tt)), 0.f);
    const float rho = fs[kRho];
    const float rho_next = __fsub_rn(rhat_s, __fmul_rn(omega, t_rhat));
    const bool bad = fabsf(rho) <= kTiny || fabsf(fs[kRhatV]) <= kTiny ||
                     fabsf(tt) <= kTiny;
    health(fs, is, __fdiv_rn(rs, b2), bad, check);
    fs[kBeta] = __fmul_rn(__fdiv_rn(rho_next, safe(rho)),
                          __fdiv_rn(fs[kAlpha], safe(omega)));
    fs[kOmega] = omega;
    fs[kRho] = rho_next;
    fs[kRs] = rs;
    advance(fs, is);
  }
}

__device__ __forceinline__ float4 ld4(const float* p, int i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ void st4(float* p, int i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}
__device__ __forceinline__ float axpy(float y, float a, float x) {
  return __fadd_rn(y, __fmul_rn(a, x));
}
__device__ __forceinline__ float aymx(float y, float a, float x) {
  return __fsub_rn(y, __fmul_rn(a, x));
}

#define REPRO_EACH4(EXPR)     \
  do {                        \
    { const int c = 0; EXPR; } \
    { const int c = 1; EXPR; } \
    { const int c = 2; EXPR; } \
    { const int c = 3; EXPR; } \
  } while (0)
__device__ __forceinline__ float& at(float4& v, int c) {
  return (&v.x)[c];
}

// CG: x += alpha p; r -= alpha ap; p = r + beta p
__global__ void update_cg_kernel(const int* __restrict__ skip,
                                 const float* __restrict__ fs,
                                 float* __restrict__ x, float* __restrict__ r,
                                 float* __restrict__ p,
                                 const float* __restrict__ ap, int n4) {
  if (*skip) return;
  const float alpha = fs[kAlpha], beta = fs[kBeta];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    float4 xv = ld4(x, i), rv = ld4(r, i), pv = ld4(p, i);
    const float4 av = ld4(ap, i);
    REPRO_EACH4(at(xv, c) = axpy(at(xv, c), alpha, at(pv, c));
                at(rv, c) = aymx(at(rv, c), alpha, (&av.x)[c]);
                at(pv, c) = axpy(at(rv, c), beta, at(pv, c)));
    st4(x, i, xv);
    st4(r, i, rv);
    st4(p, i, pv);
  }
}

// BiCGStab before pass one: p = r + beta (p - omega v)
__global__ void update_bicg_p_kernel(const int* __restrict__ skip,
                                     const float* __restrict__ fs,
                                     float* __restrict__ p,
                                     const float* __restrict__ r,
                                     const float* __restrict__ v, int n4) {
  if (*skip) return;
  const float beta = fs[kBeta], omega = fs[kOmega];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    float4 pv = ld4(p, i);
    const float4 rv = ld4(r, i), vv = ld4(v, i);
    REPRO_EACH4(at(pv, c) = axpy((&rv.x)[c], beta,
                                 aymx(at(pv, c), omega, (&vv.x)[c])));
    st4(p, i, pv);
  }
}

// BiCGStab between the passes: s = r - alpha v
__global__ void update_bicg_s_kernel(const int* __restrict__ skip,
                                     const float* __restrict__ fs,
                                     float* __restrict__ s,
                                     const float* __restrict__ r,
                                     const float* __restrict__ v, int n4) {
  if (*skip) return;
  const float alpha = fs[kAlpha];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    float4 sv;
    const float4 rv = ld4(r, i), vv = ld4(v, i);
    REPRO_EACH4(at(sv, c) = aymx((&rv.x)[c], alpha, (&vv.x)[c]));
    st4(s, i, sv);
  }
}

// BiCGStab after pass two: x = (x + alpha p) + omega s; r = s - omega t
__global__ void update_bicg_xr_kernel(const int* __restrict__ skip,
                                      const float* __restrict__ fs,
                                      float* __restrict__ x,
                                      float* __restrict__ r,
                                      const float* __restrict__ p,
                                      const float* __restrict__ s,
                                      const float* __restrict__ t, int n4) {
  if (*skip) return;
  const float alpha = fs[kAlpha], omega = fs[kOmega];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    float4 xv = ld4(x, i), rv;
    const float4 pv = ld4(p, i), sv = ld4(s, i), tv = ld4(t, i);
    REPRO_EACH4(at(xv, c) = axpy(axpy(at(xv, c), alpha, (&pv.x)[c]), omega,
                                 (&sv.x)[c]);
                at(rv, c) = aymx((&sv.x)[c], omega, (&tv.x)[c]));
    st4(x, i, xv);
    st4(r, i, rv);
  }
}

constexpr int kThreads = 256;

inline int grid_for(int n4) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (n4 + kThreads - 1) / kThreads;
  const int cap = sms * 8;                 // 8 CTAs of 256 per SM
  return want < cap ? (want > 0 ? want : 1) : cap;
}

}  // namespace

extern "C" const char* krylov_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// kind: 0 init (dots = [<r,r>, <b,b>]), 1 CG, 2 BiCGStab after pass
// one, 3 BiCGStab after pass two.  tol and maxiter are read by init
// only; the other kinds take them from fs / is.
extern "C" int krylov_step(int kind, float* fs, int* is, const float* dots,
                           float tol, int maxiter, void* stream) {
  if (kind < kInit || kind > kBicg2) return (int)cudaErrorInvalidValue;
  step_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(kind, fs, is, dots, tol,
                                                 maxiter);
  return (int)cudaGetLastError();
}

// kind: 0 CG (u0 x, u1 r, u2 p, v0 ap), 1 BiCGStab p (u0 p, v0 r, v1 v),
// 2 BiCGStab s (u0 s, v0 r, v1 v), 3 BiCGStab x, r (u0 x, u1 r, v0 p,
// v1 s, v2 t).  n: elements, a multiple of 4; every vector 16-byte
// aligned (checked by the wrapper).
extern "C" int krylov_update(int kind, const int* skip, const float* fs,
                             float* u0, float* u1, float* u2,
                             const float* v0, const float* v1,
                             const float* v2, int n, void* stream) {
  if (n % 4) return (int)cudaErrorInvalidValue;
  const int n4 = n / 4;
  const int grid = grid_for(n4);
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0:
      update_cg_kernel<<<grid, kThreads, 0, s>>>(skip, fs, u0, u1, u2, v0,
                                                 n4);
      break;
    case 1:
      update_bicg_p_kernel<<<grid, kThreads, 0, s>>>(skip, fs, u0, v0, v1,
                                                     n4);
      break;
    case 2:
      update_bicg_s_kernel<<<grid, kThreads, 0, s>>>(skip, fs, u0, v0, v1,
                                                     n4);
      break;
    case 3:
      update_bicg_xr_kernel<<<grid, kThreads, 0, s>>>(skip, fs, u0, u1, v0,
                                                      v1, v2, n4);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
