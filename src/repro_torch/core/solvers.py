"""Krylov solvers: composed CG (optionally preconditioned) and BiCGStab
over any operator, the fused CG and BiCGStab whose iterations are K3
passes, and block CG over ``matmat`` (K5).

Port of ``repro/core/solvers.py`` (all but the eigensolvers), with
mixed-precision iterative refinement as a host loop over either kind of
solve.  Two loop structures:

* The COMPOSED loops (``cg``, ``bicgstab``, ``block_cg``) run on the
  host over device-resident carriers: the vector work (spMV, axpys,
  the preconditioner) stays on the device, and the few scalars the
  recurrences and the exit test need are read back through
  :class:`_HostReads` -- CG two transfers per iteration, preconditioned
  CG two, BiCGStab three, block CG one -- and evaluated in float32 on
  the host exactly as the reference evaluates them in float32 on the
  device.
* The FUSED loops (``fused_cg``, ``fused_bicgstab``) run on the device
  as the reference's ``lax.while_loop`` does: carriers and every scalar
  live in fixed device buffers, each iteration is K3 passes, a one-thread
  scalar step and vector updates (``kernels.krylov_step``), and a
  ``done`` latch masks every launch after the exit.  On CUDA a chunk of
  ``chunk`` iterations is captured once as a CUDA graph and replayed;
  on the CPU the same chunk runs eagerly through the plain versions.
  The host reads ``(k, flag, done)`` once per chunk.

Either way the exit contract matches the reference's:

* the same iteration count ``k`` at exit (masked iterations after the
  exit change nothing);
* ``tol <= 0`` runs to ``maxiter`` (fixed-length probes);
* breakdown / diverged / non-finite statuses, gated on ``tol > 0``.

Each result's ``info["host_syncs"]`` counts the device->host reads of
the solve.

Over a distributed operator (``core.operator.DistOperator``) the
vectors are each rank's slice, so every dot, norm and Gram product is a
partial sum: the composed loops, block CG and refinement reduce it
through the operator's ``all_reduce_sum`` -- one reduction per host
read, the partial dots stacked -- so every rank sees the same scalars
and the ranks' loops stay in step.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import fused_iter as FI
from repro_torch.kernels import krylov_step as KS
from repro_torch.kernels import ref as R

__all__ = ["SolveResult", "STATUS_NAMES", "FUSED_CHUNK", "cg", "bicgstab",
           "jacobi", "fused_cg", "fused_bicgstab", "block_cg",
           "iterative_refinement"]

F32 = np.float32

# Terminal status codes; inside the loops the same integers are the
# failure FLAG, 0 meaning "no failure observed yet".
STATUS_CONVERGED = 0
STATUS_MAXITER = 1
STATUS_BREAKDOWN = 2
STATUS_DIVERGED = 3
STATUS_NON_FINITE = 4
STATUS_NAMES = ("converged", "maxiter", "breakdown", "diverged",
                "non_finite")

# Failure-detection thresholds (active only when tol > 0), as in the
# reference: DIVERGED above a squared relative residual of 1e12;
# stagnation -- two consecutive _STAG_WINDOW checkpoints without a
# _STAG_RTOL relative improvement -- reports as BREAKDOWN.
_DIVERGE_REL2 = F32(1e12)
_STAG_WINDOW = 500
_STAG_RTOL = 0.01
_TINY = F32(1e-30)
# Smallest normal float32: the host reads flush anything smaller to 0.
_F32_TINY_NORMAL = np.finfo(np.float32).tiny

# Iterations per host read of the fused loops (one CUDA graph replay on
# the card); PERF.md says how it was chosen.
FUSED_CHUNK = 32


@dataclasses.dataclass
class SolveResult:
    """The result of a linear solve.

    ``x`` stays a device tensor; ``iters``, ``residual`` (the relative
    residual ||r||/||b|| the solver ended on -- for block CG a float32
    array, one entry per column), ``converged`` and ``status_code`` are
    host values already (the host loop read them).
    ``diagnostics`` carries the certified true residual and restart
    counts; ``info`` the strategy, the host-sync count and, from
    ``repro_torch.solve``, per-phase wall clock."""

    x: torch.Tensor
    iters: int
    residual: float | np.ndarray
    converged: bool
    method: str = ""
    info: dict = dataclasses.field(default_factory=dict)
    status_code: int = 0
    diagnostics: dict = dataclasses.field(default_factory=dict)

    @property
    def status(self) -> str:
        """Termination status string -- one of ``STATUS_NAMES``."""
        return STATUS_NAMES[int(self.status_code)]


def _result(method: str, x, iters, residual, tol: float, *,
            flag=0, diagnostics=None, **info) -> SolveResult:
    res = np.asarray(residual, dtype=F32)
    ok = bool(np.all(res <= F32(tol)))
    code = STATUS_CONVERGED if ok else (flag if flag != 0 else STATUS_MAXITER)
    return SolveResult(x=x, iters=int(iters),
                       residual=float(res) if res.ndim == 0 else res,
                       converged=ok, method=method, info=dict(info),
                       status_code=int(code),
                       diagnostics=dict(diagnostics or {}))


def _matvec_of(a) -> Callable:
    """Normalize ``SparseOperator | matvec closure`` to one callable."""
    mv = getattr(a, "matvec", None)
    return a if mv is None else mv


class _HostReads:
    """Device -> host scalar reads of one solve, counted.  Every scalar
    the host recurrences see enters here, and float32 subnormals are
    flushed to 0 on the way in: XLA does so on the CPU (and the TPU
    does), so a probe run past convergence reaches the reference's exact
    0 instead of stopping at a denormal.

    Over a distributed operator every vector is the rank's slice, so a
    dot, norm or Gram product is a partial sum: :meth:`sum` applies the
    operator's ``all_reduce_sum`` (the identity for a single-device
    operator), once per host read, and every rank sees the same
    scalars."""

    def __init__(self, reduce: Callable | None = None):
        self.n = 0
        self.reduce = reduce

    @classmethod
    def of(cls, a) -> "_HostReads":
        """The reads of a solve over ``a``, summing over its ranks when
        it is distributed."""
        return cls(getattr(a, "all_reduce_sum", None))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (unchanged on a single device)."""
        return t if self.reduce is None else self.reduce(t)

    def norms(self, *vs) -> list:
        """The 2-norm of each v (per column of a block), on the device;
        over the ranks the squared partial sums of all are summed in one
        reduction."""
        if self.reduce is None:
            return [torch.linalg.vector_norm(v, dim=0) for v in vs]
        return list(torch.sqrt(self.sum(torch.stack(
            [(v * v).sum(dim=0) for v in vs]))))

    def dots(self, *pairs) -> list:
        """float32 <a, b> for each (a, b) pair, in one transfer (and one
        sum over the ranks)."""
        return self.read(self.sum(torch.stack(
            [torch.dot(a, b) for a, b in pairs])))

    def read(self, t: torch.Tensor) -> list:
        self.n += 1
        a = t.float().cpu().numpy()
        a = np.where(np.abs(a) < _F32_TINY_NORMAL, F32(0), a)
        return [F32(v) for v in a]

    def ints(self, t: torch.Tensor) -> list:
        """An integer tensor, in one transfer."""
        self.n += 1
        return [int(v) for v in t.cpu().tolist()]


def _not_done(res2, tol) -> bool:
    """Loop-exit test on the squared relative residual (or, for block
    CG, any of the per-column ones): ``tol <= 0`` means run to maxiter;
    a non-finite ``res2`` exits (as a detected failure, flagged by
    :func:`_health`)."""
    t = F32(tol)
    return bool(t <= 0 or np.any(np.isfinite(res2) & (res2 > t * t)))


def _health(flag, rel2, best, since, *, breakdown, check):
    """One failure-detection step: returns the updated
    ``(flag, best, since)``; ``flag`` latches the FIRST failure.
    Stagnation is judged at checkpoints every ``_STAG_WINDOW``
    iterations, as in the reference."""
    finite = bool(np.isfinite(rel2))
    since = since + 1
    at_ckpt = since % _STAG_WINDOW == 0
    progressed = finite and bool(rel2 <= best * F32(1.0 - _STAG_RTOL))
    stalled = at_ckpt and not progressed and since >= 2 * _STAG_WINDOW
    if not finite:
        new = STATUS_NON_FINITE
    elif breakdown:
        new = STATUS_BREAKDOWN
    elif rel2 > _DIVERGE_REL2:
        new = STATUS_DIVERGED
    elif stalled:
        new = STATUS_BREAKDOWN
    else:
        new = 0
    if not check:
        new = 0
    if at_ckpt:
        best = rel2
    if at_ckpt and progressed:
        since = 0
    return (flag if flag != 0 else new), best, since


def _health_init(rel2, tol):
    """Initial (flag, best, since): a non-finite INITIAL residual is
    flagged before the loop runs a body."""
    finite = bool(np.isfinite(rel2))
    flag = STATUS_NON_FINITE if (F32(tol) > 0 and not finite) else 0
    return flag, (F32(rel2) if finite else F32(np.inf)), 0


def _nz(d):
    """Replace an exactly-zero denominator with a tiny value (keeps
    probe-mode carriers finite after a residual hits 0.0)."""
    return _TINY if d == 0 else d


def _safe(d):
    """BiCGStab's guard: a denominator at or below 1e-30 in magnitude
    (or NaN) becomes 1e-30."""
    return d if abs(d) > _TINY else _TINY


# --------------------------------------------------------------------------
# Preconditioners
# --------------------------------------------------------------------------
def jacobi(a) -> Callable:
    """Jacobi (diagonal) preconditioner ``z = D^{-1} r`` from an
    operator's ``diagonal()``, cached on the operator.  Zero diagonal
    entries pass through unscaled."""
    d = getattr(a, "diagonal", None)
    if d is None:
        raise TypeError(
            "jacobi needs a SparseOperator with .diagonal(); got "
            f"{type(a).__name__} -- pass M as an explicit callable instead")
    cached = getattr(a, "_jacobi_precond", None)
    if cached is not None:
        return cached
    diag = d()
    nonzero = diag != 0
    inv = torch.where(nonzero, 1.0 / torch.where(nonzero, diag,
                                                 torch.ones_like(diag)),
                      torch.ones_like(diag)).to(diag.dtype)

    def precond(r: torch.Tensor) -> torch.Tensor:
        return r * (inv if r.dim() == 1 else inv[:, None])

    a._jacobi_precond = precond
    return precond


def _identity(r: torch.Tensor) -> torch.Tensor:
    """The no-op preconditioner."""
    return r


def _precond_of(M, a) -> Callable | None:
    if M is None:
        return None
    if isinstance(M, str) and M == "jacobi":
        return jacobi(a)
    if callable(M):
        return M
    raise TypeError(f"M must be None, 'jacobi' or a callable; got {M!r}")


# --------------------------------------------------------------------------
# Composed CG and BiCGStab
# --------------------------------------------------------------------------
def cg(a, b: torch.Tensor, *, x0: torch.Tensor | None = None,
       maxiter: int = 500, tol: float = 1e-6, M=None) -> SolveResult:
    """(Preconditioned) conjugate gradients for SPD A.

    ``a``: a SparseOperator or a matvec closure.  ``M``: ``None``,
    ``"jacobi"`` (from ``a.diagonal()``) or a callable ``z = M(r)`` on
    tensors.  Convergence is checked on ||r|| / ||b||."""
    matvec = _matvec_of(a)
    pre = _precond_of(M, a)
    reads = _HostReads.of(a)
    x0 = torch.zeros_like(b) if x0 is None else x0.clone()
    with np.errstate(all="ignore"):
        if pre is None:
            x, k, res, flag, syncs = _cg(matvec, b, x0, maxiter, tol, reads)
        else:
            x, k, res, flag, syncs = _pcg(matvec, pre, b, x0, maxiter, tol,
                                          reads)
    return _result("cg", x, k, res, tol, flag=flag, strategy="composed",
                   host_syncs=syncs)


def _cg(matvec, b, x, maxiter, tol, reads):
    r = b - matvec(x)
    p = r.clone()
    rs, bb = reads.dots((r, r), (b, b))
    b2 = np.maximum(bb, _TINY)
    check = F32(tol) > 0
    flag, best, since = _health_init(rs / b2, tol)
    k = 0
    while flag == 0 and _not_done(rs / b2, tol) and k < maxiter:
        ap = matvec(p)
        (pap,) = reads.dots((p, ap))
        # p.Ap <= 0 => A is not SPD along p: breakdown; zero the step so
        # x/r stay at the last healthy iterate.
        bad = check and bool(pap <= 0 or not np.isfinite(pap))
        alpha = F32(0) if bad else rs / _nz(pap)
        x.add_(p, alpha=float(alpha))
        r.add_(ap, alpha=-float(alpha))
        (rs_new,) = reads.dots((r, r))
        flag, best, since = _health(flag, rs_new / b2, best, since,
                                    breakdown=bad, check=check)
        p.mul_(float(rs_new / _nz(rs))).add_(r)
        rs = rs_new
        k += 1
    return x, k, np.sqrt(rs / b2), flag, reads.n


def _pcg(matvec, precond, b, x, maxiter, tol, reads):
    """Preconditioned CG: the same recurrence with z = M r directions.
    Two reads per iteration: p.Ap, then <r,z> and <r,r>."""
    r = b - matvec(x)
    z = precond(r)
    p = z.clone()
    rz, rs, bb = reads.dots((r, z), (r, r), (b, b))
    b2 = np.maximum(bb, _TINY)
    check = F32(tol) > 0
    flag, best, since = _health_init(rs / b2, tol)
    k = 0
    while flag == 0 and _not_done(rs / b2, tol) and k < maxiter:
        ap = matvec(p)
        (pap,) = reads.dots((p, ap))
        bad = check and bool(pap <= 0 or not np.isfinite(pap))
        alpha = F32(0) if bad else rz / _nz(pap)
        x.add_(p, alpha=float(alpha))
        r.add_(ap, alpha=-float(alpha))
        z = precond(r)
        rz_new, rs_new = reads.dots((r, z), (r, r))
        flag, best, since = _health(flag, rs_new / b2, best, since,
                                    breakdown=bad, check=check)
        p = z + float(rz_new / _nz(rz)) * p
        rz, rs = rz_new, rs_new
        k += 1
    return x, k, np.sqrt(rs / b2), flag, reads.n


def bicgstab(a, b: torch.Tensor, *, x0: torch.Tensor | None = None,
             maxiter: int = 1000, tol: float = 1e-6, M=None) -> SolveResult:
    """BiCGStab (van der Vorst 1992) for general (non-symmetric) A.

    ``M`` as in :func:`cg` (right preconditioning: A M z-directions).
    Three reads per iteration: <rhat,v>; <t,s> and <t,t>; <r,r> and the
    next <rhat,r>."""
    matvec = _matvec_of(a)
    pre = _precond_of(M, a) or _identity
    x0 = torch.zeros_like(b) if x0 is None else x0.clone()
    with np.errstate(all="ignore"):
        x, k, res, flag, syncs = _bicgstab(matvec, pre, b, x0, maxiter, tol,
                                           _HostReads.of(a))
    return _result("bicgstab", x, k, res, tol, flag=flag,
                   strategy="composed", host_syncs=syncs)


def _bicgstab(matvec, precond, b, x, maxiter, tol, reads):
    r = b - matvec(x)
    rhat = r.clone()                       # shadow residual, fixed
    rs, bb, rho_new = reads.dots((r, r), (b, b), (rhat, r))
    b2 = np.maximum(bb, _TINY)
    check = F32(tol) > 0
    flag, best, since = _health_init(rs / b2, tol)
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = F32(1)
    k = 0
    while flag == 0 and _not_done(rs / b2, tol) and k < maxiter:
        beta = (rho_new / _safe(rho)) * (alpha / _safe(omega))
        p = r + float(beta) * (p - float(omega) * v)
        p_hat = precond(p)
        v = matvec(p_hat)
        (rhat_v,) = reads.dots((rhat, v))
        alpha = rho_new / _safe(rhat_v)
        s = r - float(alpha) * v
        s_hat = precond(s)
        t = matvec(s_hat)
        t_s, tt = reads.dots((t, s), (t, t))
        omega = t_s / _safe(tt)
        x = x + float(alpha) * p_hat + float(omega) * s_hat
        r = s - float(omega) * t
        rs, rho_next = reads.dots((r, r), (rhat, r))
        # rho -> 0 (r orthogonal to the shadow residual) or a vanishing
        # <rhat, v> / <t, t>: the _safe guards keep the carriers finite,
        # the flag makes it a typed failure
        bad = bool(abs(rho_new) <= _TINY or abs(rhat_v) <= _TINY
                   or abs(tt) <= _TINY)
        flag, best, since = _health(flag, rs / b2, best, since,
                                    breakdown=bad, check=check)
        rho, rho_new = rho_new, rho_next
        k += 1
    return x, k, np.sqrt(rs / b2), flag, reads.n


# --------------------------------------------------------------------------
# Fused CG and BiCGStab: K3 passes, the loop on the device
# --------------------------------------------------------------------------
def fused_cg(matvec_dots, b: torch.Tensor, *,
             x0: torch.Tensor | None = None, maxiter: int = 500,
             tol: float = 1e-6, chunk: int | None = None) -> SolveResult:
    """CG whose iteration is ONE K3 pass, a scalar step and one vector
    update.

    ``matvec_dots``: the operand's ``kernels.fused_iter.MatVecDots``
    (``make_matvec_dots``).  Each pass ``(p, p, r)`` gives Ap with
    <Ap,p>, <Ap,r>, <Ap,Ap> and the EXACT <r,r>; only the exit test's
    look-ahead ``<r',r'> = <r,r> - 2 alpha <Ap,r> + alpha^2 <Ap,Ap>`` is
    a recurrence (clamped at 0).  ``_fused_drive`` then certifies the
    TRUE residual with one more pass and warm-restarts if the look-ahead
    exited optimistically.  Carriers live at the operand's padded
    length; ``x0`` is copied, not modified.  ``chunk``: iterations per
    host read (default :data:`FUSED_CHUNK`)."""
    return _fused_drive("cg", matvec_dots, b, x0, maxiter, tol, chunk)


def fused_bicgstab(matvec_dots, b: torch.Tensor, *,
                   x0: torch.Tensor | None = None, maxiter: int = 1000,
                   tol: float = 1e-6,
                   chunk: int | None = None) -> SolveResult:
    """BiCGStab over the fused pass, two per iteration.

    Pass one ``(p, rhat, r)`` yields v = Ap and <v,rhat>; pass two
    ``(s, rhat, s)`` yields t = As with <t,rhat>, <t,s>, <t,t>, the
    exact ||s||^2 and the exact <rhat,s>.  The scalars with no direct
    dot follow as in the reference: rho' = <rhat,s> - omega <t,rhat>
    (the measured <rhat,s>, not the textbook zero) and the look-ahead
    ||r'||^2 = ||s||^2 - 2 omega <t,s> + omega^2 <t,t>.  Same drive as
    :func:`fused_cg`."""
    return _fused_drive("bicgstab", matvec_dots, b, x0, maxiter, tol, chunk)


def _loop_kernels() -> tuple:
    """Every wrapper a fused loop launches through (the launch counts of
    a graph replay are added to theirs)."""
    return (FI.fused_spmv_dots_kernel_call, KS.step_kernel_call,
            KS.update_kernel_call)


class _FusedLoop:
    """The device loop of one fused method over one operand at one chunk
    size: carriers at the padded length, the scalar state (``fs`` /
    ``is_``, slots in ``kernels.ref``) and, on CUDA, ``chunk``
    iterations captured once as a CUDA graph.  Built at the first solve
    and kept on the operand's ``MatVecDots`` (``loops``), so restarts
    and later solves replay the same graph.  Nothing here catches an
    error: a failed build, capture or launch raises."""

    def __init__(self, mvd, method: str, chunk: int, device):
        self.mvd, self.method, self.chunk = mvd, method, chunk
        names = (("x", "r", "p", "ap") if method == "cg"
                 else ("x", "r", "p", "v", "s", "t", "rhat"))
        self.vec = {nm: torch.zeros(mvd.n_pad, dtype=torch.float32,
                                    device=device) for nm in names}
        self.fs, self.is_ = KS.new_state(device)
        self.d0 = torch.zeros(2, dtype=torch.float32, device=device)
        self.d1 = torch.zeros(5, dtype=torch.float32, device=device)
        self.d2 = torch.zeros(5, dtype=torch.float32, device=device)
        self.done = self.is_[R.IS_DONE:R.IS_DONE + 1]
        self.skip = self.is_[R.IS_SKIP:R.IS_SKIP + 1]
        self.graph = None
        self.per_replay = ()

    def start(self, b: torch.Tensor, maxiter: int, tol: float) -> None:
        """(Re)start from the current x: r = b - A x, the start dots and
        the init step (eager launches)."""
        v = self.vec
        y, _ = self.mvd(v["x"], v["x"], b)
        torch.sub(b, y, out=v["r"])
        torch.stack([torch.dot(v["r"], v["r"]), torch.dot(b, b)],
                    out=self.d0)
        KS.krylov_step(R.STEP_INIT, self.fs, self.is_, self.d0, tol=tol,
                       maxiter=maxiter)
        if self.method == "cg":
            v["p"].copy_(v["r"])
        else:
            v["rhat"].copy_(v["r"])
            v["p"].zero_()
            v["v"].zero_()

    def iteration(self) -> None:
        """One iteration's launches; every one is a no-op once ``done``
        is set."""
        v, mvd, fs, is_ = self.vec, self.mvd, self.fs, self.is_
        if self.method == "cg":
            mvd.into(v["p"], v["p"], v["r"], v["ap"], self.d1, self.done)
            KS.krylov_step(R.STEP_CG, fs, is_, self.d1)
            KS.krylov_update(R.UPDATE_CG, self.skip, fs,
                             (v["x"], v["r"], v["p"]), (v["ap"],))
            return
        KS.krylov_update(R.UPDATE_BICG_P, self.done, fs, (v["p"],),
                         (v["r"], v["v"]))
        mvd.into(v["p"], v["rhat"], v["r"], v["v"], self.d1, self.done)
        KS.krylov_step(R.STEP_BICG1, fs, is_, self.d1)
        KS.krylov_update(R.UPDATE_BICG_S, self.done, fs, (v["s"],),
                         (v["r"], v["v"]))
        mvd.into(v["s"], v["rhat"], v["s"], v["t"], self.d2, self.done)
        KS.krylov_step(R.STEP_BICG2, fs, is_, self.d2)
        KS.krylov_update(R.UPDATE_BICG_XR, self.skip, fs,
                         (v["x"], v["r"]), (v["p"], v["s"], v["t"]))

    def capture(self) -> float:
        """Capture ``chunk`` iterations as one CUDA graph; returns the
        seconds it took.  One masked iteration first (``done`` set: every
        kernel launches and returns at once) loads the kernels and K3's
        work buffers outside the capture.  The launch counts of the
        captured calls are taken back and added at each replay."""
        t0 = time.perf_counter()
        saved = self.is_.clone()
        self.is_[R.IS_DONE] = 1
        self.is_[R.IS_SKIP] = 1
        self.iteration()
        torch.cuda.synchronize(self.is_.device)
        self.is_.copy_(saved)
        kernels = _loop_kernels()
        before = [k.launches for k in kernels]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(self.chunk):
                self.iteration()
        self.per_replay = tuple(k.launches - n
                                for k, n in zip(kernels, before))
        for k, n in zip(kernels, before):
            k.launches = n
        self.graph = graph
        return time.perf_counter() - t0

    def run_chunk(self) -> None:
        if self.graph is None:
            for _ in range(self.chunk):
                self.iteration()
            return
        self.graph.replay()
        for k, n in zip(_loop_kernels(), self.per_replay):
            k.launches += n

    def run(self, b, maxiter: int, tol: float, reads: "_HostReads"):
        """One loop run from the current x: start, then chunks until the
        host reads ``done``.  Returns ``(k, flag)``."""
        self.start(b, maxiter, tol)
        while True:
            self.run_chunk()
            st = reads.ints(self.is_[:R.IS_DONE + 1])
            if st[R.IS_DONE]:
                return st[R.IS_K], st[R.IS_FLAG]


def _loop_of(mvd, method: str, chunk: int, device):
    """The operand's fused loop for (method, chunk), built (and on CUDA
    captured) at first use.  Returns ``(loop, capture seconds of this
    call)``."""
    loop = mvd.loops.get((method, chunk))
    if loop is not None:
        return loop, 0.0
    loop = _FusedLoop(mvd, method, chunk, device)
    t_cap = loop.capture() if device.type == "cuda" else 0.0
    mvd.loops[(method, chunk)] = loop
    return loop, t_cap


def _fused_drive(method, mvd, b, x0, maxiter, tol, chunk):
    """Run the device loop, certify the true residual, warm-restart
    while it still improves.  Certification is the arbiter: a loop that
    claims convergence whose true residual stays above tol is demoted
    to ``status="diverged"``.  Host reads: per run, one per chunk and
    one to certify."""
    chunk = FUSED_CHUNK if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")
    loop, t_cap = _loop_of(mvd, method, chunk, b.device)
    x = loop.vec["x"]
    if x0 is None:
        x.zero_()
    else:
        x.copy_(x0)
    reads = _HostReads()
    total, restarts = 0, 0
    rn_prev = float("inf")
    flag, demoted = 0, False
    while True:
        k, flag = loop.run(b, maxiter - total, tol, reads)
        total += k
        rn = _true_residual(mvd, b, x, reads)
        if not math.isfinite(rn):
            flag = flag or STATUS_NON_FINITE
            break
        if (tol > 0 and rn <= tol) or flag != 0 or total >= maxiter:
            break
        if k == 0 or rn >= rn_prev:
            demoted = tol > 0
            break
        rn_prev = rn
        restarts += 1
    if demoted and flag == 0:
        flag = STATUS_DIVERGED
    diagnostics = {"true_residual": rn, "restarts": restarts,
                   "certified": bool(math.isfinite(rn) and tol > 0
                                     and rn <= tol)}
    if demoted:
        diagnostics["demoted"] = True
    with np.errstate(all="ignore"):
        return _result(method, x.clone(), total, rn, tol, flag=flag,
                       diagnostics=diagnostics, strategy="fused",
                       restarts=restarts, host_syncs=reads.n, chunk=chunk,
                       graph_capture_s=t_cap)


def _true_residual(mvd, b, x, reads: _HostReads) -> float:
    """||b - A x|| / ||b|| through one fused pass, one host read."""
    r = b - mvd(x, x, x)[0]
    rr, bb = reads.dots((r, r), (b, b))
    with np.errstate(all="ignore"):
        return float(np.sqrt(rr / np.maximum(bb, _TINY)))


# --------------------------------------------------------------------------
# Mixed-precision iterative refinement
# --------------------------------------------------------------------------
def iterative_refinement(residual_of: Callable, inner_solve,
                         b: torch.Tensor, *, x0: torch.Tensor | None = None,
                         tol: float = 1e-6, max_rounds: int = 10,
                         reads: _HostReads | None = None):
    """Outer f32 correction loop over a low-precision inner solve, as
    the reference runs it (a host loop of a handful of rounds).

    ``residual_of(x) -> b - A x`` MUST apply the FULL-precision
    operator; ``inner_solve(r) -> (dx, iters, inner_residual)`` solves
    ``A dx = r`` against the low-precision (bf16 + int16) operand to its
    own looser tolerance.  Each round re-measures the true f32 residual
    and adds the correction, so bf16 storage limits the rate of
    convergence, never the final accuracy.  Rounds stop at ``tol`` on
    the true relative residual (``"converged"``), at ``max_rounds``
    (``"max_rounds"``), when a round fails to reduce the residual
    (``"stalled"``: the caller should escalate to a full-precision
    solve) or on a non-finite residual (``"non_finite"``).

    Returns ``(x, rel_residual, rounds, reason)``, ``rounds`` one dict
    per correction (inner iterations, residual entering the round,
    inner residual).  Host reads: one for ||b||, one per residual.
    ``reads`` (:meth:`_HostReads.of` the operator) sums the norms over
    the ranks of a distributed operator."""
    reads = reads or _HostReads()

    def norm(v):
        return float(reads.norms(v)[0])

    bn = max(norm(b), 1e-30)
    x = torch.zeros_like(b) if x0 is None else x0
    rounds = []
    rn_prev = float("inf")
    while True:
        r = residual_of(x)
        rn = norm(r) / bn
        if not math.isfinite(rn):
            reason = "non_finite"
            break
        if rn <= tol:
            reason = "converged"
            break
        if len(rounds) >= max_rounds:
            reason = "max_rounds"
            break
        if rn >= rn_prev:
            reason = "stalled"
            break
        dx, iters, inner_res = inner_solve(r)
        x = x + dx.to(x.dtype)
        rounds.append({"residual_in": rn, "inner_iters": int(iters),
                       "inner_residual": float(inner_res)})
        rn_prev = rn
    return x, rn, rounds, reason


# --------------------------------------------------------------------------
# Block CG (K5 through the operator's matmat)
# --------------------------------------------------------------------------
def _ridge(a: torch.Tensor) -> torch.Tensor:
    """Tiny trace-relative ridge for the k-by-k Gram systems."""
    k = a.shape[0]
    scale = torch.finfo(a.dtype).eps * (torch.trace(a) / k) + 1e-30
    return scale * torch.eye(k, dtype=a.dtype, device=a.device)


def _ridge_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the k-by-k system with a tiny trace-relative ridge so the
    block recurrences survive a column converging early (the Gram
    matrices go singular exactly when a residual column hits zero).
    ``solve_ex`` checks nothing, so it never waits for the device."""
    return torch.linalg.solve_ex(a + _ridge(a), b)[0]


def block_cg(a, b: torch.Tensor, *, x0: torch.Tensor | None = None,
             maxiter: int = 500, tol: float = 1e-6) -> SolveResult:
    """Block conjugate gradients (O'Leary 1980) for SPD A, k RHS at once.

    ``b``: (n, k).  ``a``: a SparseOperator (its ``matmat`` streams the
    matrix once for all k systems -- K5 for SELL / pJDS on the card) or
    a closure taking (n, k).  Stops when EVERY column's relative
    residual is below ``tol``; ``result.residual`` is the per-column
    float32 array and ``result.converged`` requires all columns.

    The k-by-k algebra (the two ridge-regularised Gram solves, the
    breakdown predicate) runs in float32 on the operand's device, as the
    reference runs it; the host reads the new Gram matrix's diagonal and
    the breakdown flag once per iteration for the exit and health
    tests."""
    matvec = _matvec_of(a)
    x0 = torch.zeros_like(b) if x0 is None else x0.clone()
    with np.errstate(all="ignore"):
        x, k, res, flag, syncs = _block_cg(matvec, b, x0, maxiter, tol,
                                           _HostReads.of(a))
    return _result("block_cg", x, k, res, tol, flag=flag,
                   strategy="composed", host_syncs=syncs)


def _block_cg(matvec, b, x, maxiter, tol, reads):
    n_rhs = b.shape[1]

    def gram(u, v):
        return reads.sum(u.T @ v)

    r = b - matvec(x)
    p = r.clone()
    rtr = gram(r, r)                                       # (k, k)
    b2_dev = torch.clamp(reads.sum(torch.sum(b * b, dim=0)),
                         min=1e-30)                    # (k,)
    got = reads.read(torch.cat([torch.diagonal(rtr), b2_dev]))
    rdiag, b2 = np.array(got[:n_rhs], F32), np.array(got[n_rhs:], F32)
    check = F32(tol) > 0
    flag, best, since = _health_init(np.max(rdiag / b2), tol)
    it = 0
    while flag == 0 and _not_done(rdiag / b2, tol) and it < maxiter:
        ap = matvec(p)
        ptap = gram(p, ap)
        alpha = _ridge_solve(ptap, rtr)                    # (k, k)
        # A direction with p_j.Ap_j <= 0 (indefinite A) or a Gram solve
        # gone non-finite is a block breakdown: zero the step so x/r hold
        # the last healthy iterate.  Columns already under tol are
        # exempt -- their directions legitimately shrink to 0.
        live = torch.diagonal(rtr) / b2_dev > tol * tol
        bad = (torch.any(live & (torch.diagonal(ptap) <= 0))
               | ~torch.all(torch.isfinite(alpha)))
        if check:
            alpha = torch.where(bad, torch.zeros_like(alpha), alpha)
        x.add_(p @ alpha)
        r = r - ap @ alpha
        rtr_new = gram(r, r)
        beta = _ridge_solve(rtr, rtr_new)
        p = r + p @ beta
        got = reads.read(torch.cat([torch.diagonal(rtr_new),
                                    bad.float().reshape(1)]))
        rdiag = np.array(got[:n_rhs], F32)
        flag, best, since = _health(flag, np.max(rdiag / b2), best, since,
                                    breakdown=bool(check and got[n_rhs]),
                                    check=check)
        rtr = rtr_new
        it += 1
    return x, it, np.sqrt(rdiag / b2), flag, reads.n
