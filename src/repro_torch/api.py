"""``repro_torch.solve`` -- the front door to a linear solve.

Port of ``repro/api.py`` for CG, BiCGStab and block CG.  For a host
matrix it builds the operator (on CUDA unless ``device="cpu"``), picks
the strategy -- the fused spMV+dots iteration over K3 (CG: one pass per
iteration; BiCGStab: two) whenever the operand is a single-device SELL
matrix with the resident-x grid, square, with a 1-D RHS and no
preconditioner; the composed CG / preconditioned CG / BiCGStab
otherwise; and for ``method="block_cg"`` (``b`` of shape (n, k)) block
CG over the operator's ``matmat`` -- runs it, and certifies the true
residual: a result with ``status == "converged"`` has
``||b - A x|| / ||b|| <= tol`` (for block CG, in every column).

``precond`` takes ``None``, ``"jacobi"`` (from the operator's
``diagonal()``) or a callable ``z = M(r)`` on tensors.  With the default
``fallback="auto"`` a failed solve walks the reference's degradation
ladder -- the primary configuration, ``fused->composed``, and a fresh
start with Jacobi (``escalate:fresh-x0+jacobi``) -- records each rung
in ``info["ladder"]`` and raises :class:`SolveFailure` when every rung
fails.  Unlike the reference, no rung catches an exception (in the
port one can only be a kernel build, capture or launch failure), and
the ``kernel->ref`` and ``bf16->f32`` rungs never appear (ROADMAP.md,
faults found against the reference).

The keywords keep the reference's names and defaults.  Values the port
does not run yet raise ``NotImplementedError`` naming their ROADMAP
item, never a quiet fallback: ``tune`` other than ``"off"`` (so the
default ``"auto"`` raises too; block CG does not tune, as in the
reference), and refinement and sub-f32 ``dtype`` for CG and BiCGStab.
So the calls are::

    res = repro_torch.solve(m, b, tune="off")
    res = repro_torch.solve(m, b, method="bicgstab", tune="off")
    res = repro_torch.solve(m, b, precond="jacobi", tune="off")
    res = repro_torch.solve(m, B, method="block_cg", format="sell",
                            tune="off")
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch._todo import not_ported
from repro_torch.core import solvers as S
from repro_torch.core.solvers import SolveResult
from repro_torch.kernels._backend import host_tensor, resolve_device

__all__ = ["solve", "SolveFailure", "SolveResult"]

_METHODS = ("cg", "bicgstab", "block_cg")
_DEFAULT_MAXITER = {"cg": 500, "bicgstab": 1000, "block_cg": 500}


class SolveFailure(RuntimeError):
    """Raised by :func:`solve` when ``fallback="auto"`` and every rung
    of the degradation ladder ended in a failure status (breakdown /
    diverged / non_finite, or a "converged" claim demoted by the
    true-residual certification).  ``ladder`` is the per-rung record
    (label, status, restarts, certified residual) and ``result`` the
    last rung's :class:`SolveResult`."""

    def __init__(self, message: str, *, result=None, ladder=None):
        super().__init__(message)
        self.result = result
        self.ladder = list(ladder or [])


def _is_host_matrix(a) -> bool:
    from repro_torch.core import formats as F
    return isinstance(a, F.CSRMatrix)


def _is_sub_f32(dtype) -> bool:
    if dtype is None:
        return False
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point and dtype.itemsize < 4
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return name in ("bfloat16", "float16")


def _fused_eligible(op, method: str, precond, b: torch.Tensor) -> bool:
    """The fused iteration needs a single-device SELL operand with the
    resident-x grid (``x_tiles == 1``, as the reference requires),
    square, a 1-D RHS, no preconditioner, and CG or BiCGStab."""
    from repro_torch.core.operator import DeviceOperator
    return (method in ("cg", "bicgstab") and precond is None
            and b.dim() == 1 and isinstance(op, DeviceOperator)
            and op.fmt == "sell" and op.dev.x_tiles == 1
            and op.shape[0] == op.shape[1])


def _fused_dots_of(op):
    """The fused-pass object over ``op``'s SELL operand, cached on the
    converted operand (``SparseDevice.fused``), so every operator and
    every solve over one conversion share its device loops and their
    CUDA graphs."""
    from repro_torch.kernels.fused_iter import make_matvec_dots
    cache = op.dev.fused
    if op.backend not in cache:
        cache[op.backend] = make_matvec_dots(op.dev.dev, backend=op.backend)
    return cache[op.backend]


def _pad_to(v: torch.Tensor, n_pad: int) -> torch.Tensor:
    return v if v.shape[0] == n_pad else \
        torch.nn.functional.pad(v, (0, n_pad - v.shape[0]))


def _one_solve(op, b, *, method, strategy, maxiter, tol, precond,
               x0=None) -> SolveResult:
    if strategy == "fused":
        mvd = _fused_dots_of(op)
        n, n_pad = op.shape[0], mvd.n_pad
        x0p = None if x0 is None else _pad_to(x0, n_pad)
        fn = S.fused_cg if method == "cg" else S.fused_bicgstab
        res = fn(mvd, _pad_to(b, n_pad), x0=x0p, maxiter=maxiter, tol=tol)
        res.x = res.x[:n]
        return res
    if method == "cg":
        return S.cg(op, b, x0=x0, maxiter=maxiter, tol=tol, M=precond)
    if method == "bicgstab":
        return S.bicgstab(op, b, x0=x0, maxiter=maxiter, tol=tol, M=precond)
    return S.block_cg(op, b, x0=x0, maxiter=maxiter, tol=tol)


def _true_rel_residual(op, b, x) -> float:
    """Certified relative true residual ||b - A x|| / ||b|| (the largest
    over the columns of a block RHS)."""
    r = b - S._matvec_of(op)(x)
    if b.dim() == 1:
        nb = torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
        return float(torch.linalg.vector_norm(r) / nb)
    num = torch.linalg.vector_norm(r, dim=0)
    den = torch.clamp(torch.linalg.vector_norm(b, dim=0), min=1e-30)
    return float(torch.max(num / den))


def _certify(res: SolveResult, op, b, tol: float) -> SolveResult:
    """Demote a "converged" claim whose certified true residual misses
    tol.  Skipped when the solver certified already (the fused drive
    measures the true residual itself).  Unlike the reference, an error
    raised while certifying is not caught: it would be a kernel launch
    failure, and those surface."""
    if tol <= 0:
        return res
    if "true_residual" not in res.diagnostics:
        rn = _true_rel_residual(op, b, res.x)
        res.diagnostics["true_residual"] = rn
        res.diagnostics["certified"] = rn == rn and rn <= tol
    if res.status == "converged" and not res.diagnostics.get("certified"):
        res.status_code = S.STATUS_DIVERGED
        res.converged = False
        res.diagnostics["demoted"] = True
    return res


def _certified_solve(op, b, *, method, strategy, maxiter, tol, precond,
                     x0):
    """One ladder rung: solve, certify, and warm-restart (at most twice)
    while a certification miss from recurrence drift still improves.
    Returns ``(result, warm restarts)``."""
    rn_prev, restarts, iters_acc, syncs_acc = float("inf"), 0, 0, 0
    while True:
        res = _one_solve(op, b, method=method, strategy=strategy,
                         maxiter=maxiter, tol=tol, precond=precond, x0=x0)
        res = _certify(res, op, b, tol)
        # a warm restart continues the same solve: report its totals
        iters_acc += res.iters
        syncs_acc += res.info["host_syncs"]
        res.iters = iters_acc
        res.info["host_syncs"] = syncs_acc
        rn = res.diagnostics.get("true_residual")
        if (res.diagnostics.get("demoted") and restarts < 2
                and rn is not None and math.isfinite(rn) and rn < rn_prev):
            x0, rn_prev, restarts = res.x, rn, restarts + 1
            continue
        return res, restarts


def _build_rungs(op, *, method, strategy, precond, fallback):
    """The degradation ladder, most- to least-aggressive, as the
    reference builds it: the preferred configuration, then
    fused->composed, and a final escalation (fresh x0, plus Jacobi where
    the method and operator support it).  A generator, so the happy
    path builds only the primary rung.  The reference's bf16->f32 rung
    needs refinement (not ported) and its kernel->ref rung would run a
    plain version on the main path; neither is yielded."""
    yield {"label": "primary", "strategy": strategy, "precond": precond,
           "fresh_x0": False}
    if fallback in ("off", False, None):
        return
    if strategy == "fused":
        yield {"label": "fused->composed", "strategy": "composed",
               "precond": precond, "fresh_x0": False}
    esc_precond = precond
    if (precond is None and method in ("cg", "bicgstab")
            and getattr(op, "diagonal", None) is not None):
        esc_precond = "jacobi"
    yield {"label": "escalate:fresh-x0"
           + ("+jacobi" if esc_precond == "jacobi" and precond is None
              else ""),
           "strategy": "composed", "precond": esc_precond, "fresh_x0": True}


def _ladder_solve(op, b, *, method, strategy, maxiter, tol, precond, x0,
                  fallback):
    """Walk the ladder.  Each rung runs, is certified and recorded;
    "converged" returns at once, and so does "maxiter" (an honest
    out-of-budget status, not a fault).  When every rung fails,
    ``fallback="auto"`` raises :class:`SolveFailure`; ``fallback="off"``
    returns the single rung's typed result.  Nothing is caught: a rung
    that raises ends the solve with its exception."""
    fallback_on = fallback not in ("off", False, None)
    ladder, res, warm = [], None, None
    for rung in _build_rungs(op, method=method, strategy=strategy,
                             precond=precond, fallback=fallback):
        rung_x0 = None if rung["fresh_x0"] else (x0 if warm is None
                                                 else warm)
        res, restarts = _certified_solve(
            op, b, method=method, strategy=rung["strategy"],
            maxiter=maxiter, tol=tol, precond=rung["precond"], x0=rung_x0)
        status = res.status
        rn = res.diagnostics.get("true_residual")
        entry = {"rung": rung["label"], "status": status}
        if restarts:
            entry["restarts"] = restarts
        if rn is not None:
            entry["true_residual"] = rn
        ladder.append(entry)
        if status in ("converged", "maxiter") or not fallback_on:
            break
        # warm-start the next rung from any finite partial progress
        if rn is not None and math.isfinite(rn) and rn < 1.0:
            warm = res.x
    else:
        raise SolveFailure(
            f"solve({method}) failed on every ladder rung "
            f"(last: {ladder[-1]}); see .ladder / .result for diagnostics",
            result=res, ladder=ladder)
    return res, ladder


def _as_vector(v, dev: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return host_tensor(np.asarray(v), dev)


def solve(a, b, *, method: str = "cg", precond=None, tol: float = 1e-6,
          maxiter: int | None = None, x0=None, tune="auto",
          refine="auto", fallback="auto", format: str = "auto", dtype=None,
          index_dtype="auto", backend="auto", device=None,
          **convert_kwargs) -> SolveResult:
    """Solve ``A x = b``; see the module docstring for the strategy,
    the ladder and what raises.

    ``a``: a host ``CSRMatrix`` (an operator is built on ``device`` --
    CUDA by default, raising when there is none -- with ``format`` /
    ``dtype`` / ``index_dtype`` / ``backend`` and further ``as_device``
    keywords), an existing ``DeviceOperator`` (used as-is), or a bare
    matvec closure (composed strategy).  ``b``: a numpy array or
    tensor (moved to the operator's device; float64 becomes float32),
    1-D for ``"cg"`` and ``"bicgstab"``, (n, k) for ``"block_cg"``.
    With ``format="auto"`` a host matrix is built as SELL for CG and
    BiCGStab without a preconditioner (the fused strategy's format), and
    by ``select_format`` otherwise, as in the reference.
    """
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}; got {method!r}")
    if fallback not in ("auto", True, "off", False, None):
        raise ValueError(f"fallback must be 'auto' or 'off'; got "
                         f"{fallback!r}")
    if refine is True and method == "block_cg":
        raise ValueError("refine is not available for block_cg "
                         "(no block refinement path)")
    if tune not in ("off", False, None) and method != "block_cg":
        raise not_ported(f"tune={tune!r}", "tune")
    if refine is True or (_is_sub_f32(dtype) and method != "block_cg"):
        raise not_ported("refinement and sub-f32 dtype", "refine")
    maxiter = _DEFAULT_MAXITER[method] if maxiter is None else maxiter
    phase_s: dict = {"tune": 0.0}

    t0 = time.perf_counter()
    if _is_host_matrix(a):
        from repro_torch.core.operator import operator
        build_kwargs = dict(convert_kwargs)
        build_kwargs.setdefault("format", format)
        if (build_kwargs["format"] == "auto"
                and method in ("cg", "bicgstab") and precond is None):
            build_kwargs["format"] = "sell"       # fused-eligible build
        op = operator(a, dtype=dtype, index_dtype=index_dtype,
                      backend=backend, device=device, **build_kwargs)
        dev = op.device
    else:
        from repro_torch.core.operator import SparseOperator
        if not (isinstance(a, SparseOperator) or callable(a)):
            raise TypeError(
                f"solve takes a repro_torch CSRMatrix, a SparseOperator or "
                f"a matvec callable; got {type(a).__name__}")
        op = a
        dev = op.device if hasattr(op, "device") else resolve_device(device)
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"the operator lives on {dev}, not {device}")
    phase_s["build"] = time.perf_counter() - t0

    b = _as_vector(b, dev)
    if method == "block_cg" and b.dim() != 2:
        raise ValueError(f"block_cg expects b of shape (n, k); got "
                         f"{tuple(b.shape)}")
    if method != "block_cg" and b.dim() != 1:
        raise ValueError(f"{method} expects a 1-D b; got shape "
                         f"{tuple(b.shape)}")
    x0 = None if x0 is None else _as_vector(x0, dev)
    strategy = "fused" if _fused_eligible(op, method, precond, b) \
        else "composed"

    t0 = time.perf_counter()
    res, ladder = _ladder_solve(op, b, method=method, strategy=strategy,
                                maxiter=maxiter, tol=tol, precond=precond,
                                x0=x0, fallback=fallback)
    phase_s["solve"] = time.perf_counter() - t0
    res.info["phase_s"] = phase_s
    if len(ladder) > 1 or fallback not in ("off", False, None):
        res.info["ladder"] = ladder
    return res
