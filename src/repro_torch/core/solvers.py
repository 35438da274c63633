"""Krylov solvers: composed CG over any operator, the fused CG whose
iteration is one K3 pass, and block CG over ``matmat`` (K5).

Port of the CG part of ``repro/core/solvers.py``.  PyTorch has no
``lax.while_loop``, so each loop runs on the host over device-resident
carriers: the vector work (spMV, axpys) stays on the device, and the
few scalars the exit test needs are read back once per iteration (the
fused loop: the five dots of its K3 pass in ONE transfer; the composed
loop: two; block CG: one).  Every scalar recurrence -- alpha, beta, the
look-ahead residual clamped at 0, the failure flags -- is evaluated in
float32 on the host exactly as the reference evaluates it in float32 on
the device, so the exit contract matches the reference's:

* the same iteration count ``k`` at exit;
* ``tol <= 0`` runs to ``maxiter`` (fixed-length probes);
* breakdown / diverged / non-finite statuses, gated on ``tol > 0``.

Each result's ``info["host_syncs"]`` counts the device->host reads of
the solve.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

__all__ = ["SolveResult", "STATUS_NAMES", "cg", "fused_cg", "block_cg"]

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
    0 instead of stopping at a denormal."""

    def __init__(self):
        self.n = 0

    def dots(self, *pairs) -> list:
        """float32 <a, b> for each (a, b) pair, in one transfer."""
        vals = torch.stack([torch.dot(a, b) for a, b in pairs])
        return self.read(vals)

    def read(self, t: torch.Tensor) -> list:
        self.n += 1
        a = t.float().cpu().numpy()
        a = np.where(np.abs(a) < _F32_TINY_NORMAL, F32(0), a)
        return [F32(v) for v in a]


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


# --------------------------------------------------------------------------
# Composed CG
# --------------------------------------------------------------------------
def cg(a, b: torch.Tensor, *, x0: torch.Tensor | None = None,
       maxiter: int = 500, tol: float = 1e-6) -> SolveResult:
    """Conjugate gradients for SPD A (unpreconditioned).

    ``a``: a SparseOperator or a matvec closure.  Convergence is checked
    on ||r|| / ||b||."""
    matvec = _matvec_of(a)
    x0 = torch.zeros_like(b) if x0 is None else x0.clone()
    with np.errstate(all="ignore"):
        x, k, res, flag, syncs = _cg(matvec, b, x0, maxiter, tol)
    return _result("cg", x, k, res, tol, flag=flag, strategy="composed",
                   host_syncs=syncs)


def _cg(matvec, b, x, maxiter, tol):
    reads = _HostReads()
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


# --------------------------------------------------------------------------
# Fused CG (one K3 pass per iteration)
# --------------------------------------------------------------------------
def fused_cg(matvec_dots, b: torch.Tensor, *,
             x0: torch.Tensor | None = None, maxiter: int = 500,
             tol: float = 1e-6) -> SolveResult:
    """CG whose iteration is ONE fused spMV+dots pass and three axpys.

    ``matvec_dots(v, w1, w2)`` (``kernels.fused_iter.make_matvec_dots``)
    returns ``(Av, [<Av,w1>, <Av,w2>, <Av,Av>, <w2,w2>, <w1,w2>])``.
    Each pass ``matvec_dots(p, p, r)`` gives Ap with <Ap,p>, <Ap,r>,
    <Ap,Ap> and the EXACT <r,r>; only the exit test's look-ahead
    ``<r',r'> = <r,r> - 2 alpha <Ap,r> + alpha^2 <Ap,Ap>`` is a
    recurrence (clamped at 0).  ``_fused_drive`` then certifies the TRUE
    residual with one more pass and warm-restarts if the look-ahead
    exited optimistically.  Carriers live at the operand's padded
    length; ``x0`` is copied, not modified."""
    return _fused_drive(_fused_cg, "cg", matvec_dots, b, x0, maxiter, tol)


def _fused_drive(loop_fn, method, matvec_dots, b, x0, maxiter, tol):
    """Run the loop, certify the true residual, warm-restart while it
    still improves.  Certification is the arbiter: a loop that claims
    convergence whose true residual stays above tol is demoted to
    ``status="diverged"``."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    total, restarts, syncs = 0, 0, 0
    rn_prev = float("inf")
    flag, demoted = 0, False
    with np.errstate(all="ignore"):
        while True:
            x, k, _, lflag, n = loop_fn(matvec_dots, b, x, maxiter - total,
                                        tol)
            total += int(k)
            flag = int(lflag)
            rn, n_rn = _true_residual(matvec_dots, b, x)
            syncs += n + n_rn
            if not math.isfinite(rn):
                flag = flag or STATUS_NON_FINITE
                break
            if (tol > 0 and rn <= tol) or flag != 0 or total >= maxiter:
                break
            if int(k) == 0 or rn >= rn_prev:
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
    return _result(method, x, total, rn, tol, flag=flag,
                   diagnostics=diagnostics, strategy="fused",
                   restarts=restarts, host_syncs=syncs)


def _true_residual(matvec_dots, b, x):
    """(||b - A x|| / ||b|| through one fused pass, host reads)."""
    reads = _HostReads()
    r = b - matvec_dots(x, x, x)[0]
    rr, bb = reads.dots((r, r), (b, b))
    return float(np.sqrt(rr / np.maximum(bb, _TINY))), reads.n


def _fused_cg(matvec_dots, b, x, maxiter, tol):
    reads = _HostReads()
    r = b - matvec_dots(x, x, b)[0]
    rs, bb = reads.dots((r, r), (b, b))         # exact, once per (re)start
    b2 = np.maximum(bb, _TINY)
    check = F32(tol) > 0
    flag, best, since = _health_init(rs / b2, tol)
    p = r.clone()
    k = 0
    while flag == 0 and _not_done(rs / b2, tol) and k < maxiter:
        ap, dots = matvec_dots(p, p, r)
        pap, r_ap, apap, rr, _ = reads.read(dots)   # rr exact
        bad = check and bool(pap <= 0 or not np.isfinite(pap))
        alpha = F32(0) if bad else rr / _nz(pap)
        x.add_(p, alpha=float(alpha))
        r.add_(ap, alpha=-float(alpha))
        rs = np.maximum(rr - F32(2) * alpha * r_ap + alpha * alpha * apap,
                        F32(0))
        flag, best, since = _health(flag, rs / b2, best, since,
                                    breakdown=bad, check=check)
        p.mul_(float(rs / np.maximum(rr, _TINY))).add_(r)
        k += 1
    return x, k, np.sqrt(rs / b2), flag, reads.n


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
        x, k, res, flag, syncs = _block_cg(matvec, b, x0, maxiter, tol)
    return _result("block_cg", x, k, res, tol, flag=flag,
                   strategy="composed", host_syncs=syncs)


def _block_cg(matvec, b, x, maxiter, tol):
    reads = _HostReads()
    n_rhs = b.shape[1]
    r = b - matvec(x)
    p = r.clone()
    rtr = r.T @ r                                          # (k, k)
    b2_dev = torch.clamp(torch.sum(b * b, dim=0), min=1e-30)   # (k,)
    got = reads.read(torch.cat([torch.diagonal(rtr), b2_dev]))
    rdiag, b2 = np.array(got[:n_rhs], F32), np.array(got[n_rhs:], F32)
    check = F32(tol) > 0
    flag, best, since = _health_init(np.max(rdiag / b2), tol)
    it = 0
    while flag == 0 and _not_done(rdiag / b2, tol) and it < maxiter:
        ap = matvec(p)
        ptap = p.T @ ap
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
        rtr_new = r.T @ r
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
