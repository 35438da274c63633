"""``repro_torch.solve`` -- the front door to a linear solve.

Port of ``repro/api.py`` for CG, BiCGStab and block CG, with the
reference's keywords and defaults::

    res = repro_torch.solve(m, b)                       # tuned CG
    res = repro_torch.solve(m, b, method="bicgstab")
    res = repro_torch.solve(m, b, dtype=torch.bfloat16) # bf16, refined
    res = repro_torch.solve(m, b, precond="jacobi")
    res = repro_torch.solve(m, B, method="block_cg")

For a host matrix it builds the operator on ``device`` (CUDA unless
``device="cpu"``; with neither it raises) and owns three decisions:

* TUNING -- ``tune="auto"`` (the default) asks ``tune.tune_solver`` for
  the (strategy, layout) that is fastest per solver iteration on that
  device, measured once and then served from the persistent cache
  (``"force"`` re-measures, ``"off"`` builds the heuristic SELL layout);
  block CG does not tune, as in the reference;
* STRATEGY -- the fused spMV+dots iteration over K3 (CG: one pass per
  iteration; BiCGStab: two) whenever the operand is a single-device SELL
  matrix with the resident-x grid, square, with a 1-D RHS and no
  preconditioner, unless the tuner measured the composed loop faster;
  the composed CG / preconditioned CG / BiCGStab otherwise;
* PRECISION -- ``refine="auto"`` turns mixed-precision refinement on
  when a host matrix is asked for at a sub-f32 ``dtype``: the outer
  operator is built at f32, the inner one at the requested dtype, and
  ``core.solvers.iterative_refinement`` corrects the inner solves
  against f32 residuals; ``refine=True`` forces it (for an existing f32
  operator the inner operand is a bf16 + int16 clone of it).

Every result's true residual is certified: ``status == "converged"``
means ``||b - A x|| / ||b|| <= tol`` (for block CG, in every column).
``precond`` takes ``None``, ``"jacobi"`` (from the operator's
``diagonal()``) or a callable ``z = M(r)`` on tensors.  With the default
``fallback="auto"`` a failed solve walks the reference's degradation
ladder -- the primary configuration, ``fused->composed``, ``bf16->f32``
for a refined solve, and a fresh start with Jacobi
(``escalate:fresh-x0+jacobi``) -- records each rung in
``info["ladder"]`` and raises :class:`SolveFailure` when every rung
fails.  Unlike the reference, no rung catches an exception (in the port
one can only be a kernel build, capture or launch failure), and the
``kernel->ref`` rung never appears (ROADMAP.md, faults found against the
reference).  ``info`` carries ``strategy``, per-phase wall clock
``phase_s`` (tune / build / solve), the tuner's decision under ``tune``
and, for a refined solve, the rounds under ``refine``.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time

import numpy as np
import torch

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


def _bf16_fields(inner) -> dict:
    """Every floating tensor of a device container, as bf16."""
    return {f.name: getattr(inner, f.name).to(torch.bfloat16)
            for f in dataclasses.fields(inner)
            if isinstance(getattr(inner, f.name), torch.Tensor)
            and getattr(inner, f.name).is_floating_point()}


def _cast_low_precision(op):
    """A bf16 clone of an f32 ``DeviceOperator`` or ``DistOperator`` for
    refinement's inner solves: every floating tensor of the device
    container (of each rank operand) drops to bf16, and a single-device
    SELL operand whose column space fits int16 also stores ``col_idx``
    as int16 (the 0.50x bytes/nnz layout), as in the reference.  The
    structure -- index maps, permutations, halo sets and the walk
    lengths derived from them -- is shared.  A single-device clone is a
    new ``SparseDevice``: its fused pass, device loops and CUDA graphs
    (``fused``) and K5's row map start empty, so an inner fused solve
    never replays the f32 operand's graph.  A distributed clone keeps
    the diagonal and drops the transpose partition, as the
    reference's does."""
    from repro_torch.core.operator import DeviceOperator, DistOperator
    from repro_torch.kernels.ops import SparseDevice

    if isinstance(op, DistOperator):
        lo = copy.copy(op)
        lo.shard = op.shard.with_operands(
            lambda a: dataclasses.replace(a, **_bf16_fields(a)))
        lo.t_dist = lo.t_shard = None
        return lo
    if not isinstance(op, DeviceOperator):
        raise ValueError(
            "refine=True needs a device or distributed operator (or a host "
            f"matrix) to cast to bf16; got {type(op).__name__}")
    sd, inner = op.dev, op.dev.dev
    low = _bf16_fields(inner)
    if (op.fmt == "sell"
            and op.shape[1] <= torch.iinfo(torch.int16).max):
        low["col_idx"] = inner.col_idx.to(torch.int16)
    lo = SparseDevice(fmt=sd.fmt, shape=sd.shape,
                      dev=dataclasses.replace(inner, **low),
                      inv_perm=sd.inv_perm, x_tiles=sd.x_tiles)
    return DeviceOperator(lo, backend=op.backend)


def _refined_solve(op, op_lo, b, *, method, maxiter, tol, precond,
                   x0=None) -> SolveResult:
    """Mixed-precision refinement: inner ``method`` solves on the
    low-precision operand (fused when it is eligible), residual
    corrections on the full-precision one.  The inner tolerance is
    floored at 1e-3 -- bf16 storage cannot resolve much further, and the
    outer loop closes the rest.  A stalled or non-finite refinement is a
    typed failure (diverged / non_finite), so the ladder escalates to
    the f32 rung."""
    apply_full = S._matvec_of(op)
    inner_tol = max(tol, 1e-3)
    inner_strategy = ("fused" if _fused_eligible(op_lo, method, precond, b)
                      else "composed")
    inner_syncs = []

    def residual_of(x):
        return b - apply_full(x)

    def inner(r):
        rr = _one_solve(op_lo, r.to(b.dtype), method=method,
                        strategy=inner_strategy, maxiter=maxiter,
                        tol=inner_tol, precond=precond)
        inner_syncs.append(rr.info["host_syncs"])
        return rr.x.to(b.dtype), rr.iters, rr.residual

    x, rn, rounds, reason = S.iterative_refinement(
        residual_of, inner, b, x0=x0, tol=tol,
        reads=S._HostReads.of(op))
    flag = {"stalled": S.STATUS_DIVERGED,
            "non_finite": S.STATUS_NON_FINITE}.get(reason, 0)
    total = sum(r["inner_iters"] for r in rounds)
    with np.errstate(all="ignore"):
        res = S._result(method, x, total, rn, tol, flag=flag,
                        diagnostics={"refine_reason": reason,
                                     "true_residual": rn,
                                     "certified": reason == "converged"},
                        strategy=f"{inner_strategy}+refined",
                        host_syncs=sum(inner_syncs) + len(rounds) + 2)
    res.info["refine"] = {
        "rounds": rounds,
        "reason": reason,
        "inner_dtype": str(op_lo.dtype).removeprefix("torch."),
        "inner_tol": inner_tol,
    }
    return res


def _true_rel_residual(op, b, x) -> float:
    """Certified relative true residual ||b - A x|| / ||b|| (the largest
    over the columns of a block RHS), summed over the ranks of a
    distributed operator."""
    num, den = S._HostReads.of(op).norms(b - S._matvec_of(op)(x), b)
    return float(torch.max(num / torch.clamp(den, min=1e-30)))


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


def _certified_solve(op, op_lo, b, *, method, strategy, maxiter, tol,
                     precond, x0):
    """One ladder rung: solve (refined over ``op_lo`` when it is given),
    certify, and warm-restart (at most twice) while a certification miss
    from recurrence drift still improves.  Returns ``(result, warm
    restarts)``."""
    rn_prev, restarts, iters_acc, syncs_acc = float("inf"), 0, 0, 0
    while True:
        if op_lo is not None:
            res = _refined_solve(op, op_lo, b, method=method,
                                 maxiter=maxiter, tol=tol, precond=precond,
                                 x0=x0)
        else:
            res = _one_solve(op, b, method=method, strategy=strategy,
                             maxiter=maxiter, tol=tol, precond=precond,
                             x0=x0)
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


def _build_rungs(op, op_lo, *, method, strategy, precond, fallback):
    """The degradation ladder, most- to least-aggressive, as the
    reference builds it: the preferred configuration, then
    fused->composed, bf16-refined->f32, and a final escalation (fresh
    x0, plus Jacobi where the method and operator support it).  A
    generator, so the happy path builds only the primary rung.  The
    reference's kernel->ref rung would run a plain version on the main
    path and is not yielded."""
    yield {"label": "primary", "op_lo": op_lo, "strategy": strategy,
           "precond": precond, "fresh_x0": False}
    if fallback in ("off", False, None):
        return
    if strategy == "fused":
        yield {"label": "fused->composed", "op_lo": op_lo,
               "strategy": "composed", "precond": precond,
               "fresh_x0": False}
    if op_lo is not None:
        yield {"label": "bf16->f32", "op_lo": None, "strategy": "composed",
               "precond": precond, "fresh_x0": False}
    esc_precond = precond
    if (precond is None and method in ("cg", "bicgstab")
            and getattr(op, "diagonal", None) is not None):
        esc_precond = "jacobi"
    yield {"label": "escalate:fresh-x0"
           + ("+jacobi" if esc_precond == "jacobi" and precond is None
              else ""),
           "op_lo": None, "strategy": "composed", "precond": esc_precond,
           "fresh_x0": True}


def _ladder_solve(op, op_lo, b, *, method, strategy, maxiter, tol, precond,
                  x0, fallback):
    """Walk the ladder.  Each rung runs, is certified and recorded;
    "converged" returns at once, and so does "maxiter" (an honest
    out-of-budget status, not a fault) -- except on a refined rung,
    whose round cap escalates to the f32 rung.  When every rung fails,
    ``fallback="auto"`` raises :class:`SolveFailure`; ``fallback="off"``
    returns the single rung's typed result.  Nothing is caught: a rung
    that raises ends the solve with its exception."""
    fallback_on = fallback not in ("off", False, None)
    ladder, res, warm = [], None, None
    for rung in _build_rungs(op, op_lo, method=method, strategy=strategy,
                             precond=precond, fallback=fallback):
        rung_x0 = None if rung["fresh_x0"] else (x0 if warm is None
                                                 else warm)
        res, restarts = _certified_solve(
            op, rung["op_lo"], b, method=method, strategy=rung["strategy"],
            maxiter=maxiter, tol=tol, precond=rung["precond"], x0=rung_x0)
        status = res.status
        rn = res.diagnostics.get("true_residual")
        entry = {"rung": rung["label"], "status": status}
        if restarts:
            entry["restarts"] = restarts
        if rn is not None:
            entry["true_residual"] = rn
        ladder.append(entry)
        if status == "converged":
            break
        if status == "maxiter" and rung["op_lo"] is None:
            break                      # honest out-of-budget, not a fault
        if not fallback_on:
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
    """Solve ``A x = b``; see the module docstring for the decisions
    this front door makes.

    ``a``: a host ``CSRMatrix`` (an operator is built on ``device`` --
    CUDA by default, raising when there is none -- with the tuned
    layout, or with ``format`` / ``dtype`` / ``index_dtype`` /
    ``backend`` and further ``as_device`` keywords when ``tune="off"``;
    ``validate`` survives tuning), an existing ``DeviceOperator`` (used
    as-is), a ``DistOperator`` (every rank calls ``solve`` with its
    slice of b; composed strategy, the dots summed over the ranks), or
    a bare matvec closure (composed strategy).  ``b``: a
    numpy array or tensor (moved to the operator's device; float64
    becomes float32), 1-D for ``"cg"`` and ``"bicgstab"``, (n, k) for
    ``"block_cg"``.  With ``tune="off"`` and ``format="auto"`` a host
    matrix is built as SELL for CG and BiCGStab without a preconditioner
    (the fused strategy's format), and by ``select_format`` otherwise,
    as in the reference.  ``refine``: ``"auto"`` / ``True`` / ``False``;
    refining a bare closure, a block solve or with a callable
    ``precond`` raises.
    """
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}; got {method!r}")
    if fallback not in ("auto", True, "off", False, None):
        raise ValueError(f"fallback must be 'auto' or 'off'; got "
                         f"{fallback!r}")
    if refine is True and method == "block_cg":
        raise ValueError("refine is not available for block_cg "
                         "(no block refinement path)")
    if refine is True and callable(precond):
        raise ValueError("refine=True cannot re-derive a callable precond "
                         "for the low-precision operand; use precond="
                         "'jacobi' or None")
    maxiter = _DEFAULT_MAXITER[method] if maxiter is None else maxiter
    phase_s: dict = {}
    info_tune = None
    strategy_pref = None
    op_lo = None

    if _is_host_matrix(a):
        from repro_torch.core.operator import operator
        m = a
        dev = resolve_device(device)
        do_refine = (refine is True
                     or (refine == "auto" and _is_sub_f32(dtype)
                         and method != "block_cg"))
        inner_dtype = dtype if _is_sub_f32(dtype) else torch.bfloat16
        build_kwargs = dict(convert_kwargs)
        t0 = time.perf_counter()
        if tune not in ("off", False, None) and method != "block_cg":
            from repro_torch import tune as T
            st = T.tune_solver(m, method=method,
                               dtype=None if do_refine else dtype,
                               index_dtype=index_dtype,
                               force=(tune == "force"), device=dev)
            strategy_pref = st.strategy
            build_kwargs = st.layout.build_kwargs()
            if "validate" in convert_kwargs:   # the admission gate survives
                build_kwargs["validate"] = convert_kwargs["validate"]
            info_tune = {"cached": st.cached, "strategy": st.strategy,
                         "layout": st.layout.label()}
        else:
            build_kwargs.setdefault("format", format)
            if (build_kwargs["format"] == "auto"
                    and method in ("cg", "bicgstab") and precond is None):
                build_kwargs["format"] = "sell"   # fused-eligible build
        phase_s["tune"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        op = operator(m, dtype=None if do_refine else dtype,
                      index_dtype=index_dtype, backend=backend, device=dev,
                      **build_kwargs)
        if do_refine:
            op_lo = operator(m, dtype=inner_dtype, index_dtype=index_dtype,
                             backend=backend, device=dev, **build_kwargs)
        phase_s["build"] = time.perf_counter() - t0
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
        do_refine = refine is True
        if do_refine and not isinstance(op, SparseOperator):
            raise ValueError("refine=True needs an operator or host matrix; "
                             "got a bare closure")
        if do_refine and _is_sub_f32(getattr(op, "dtype", None)):
            raise ValueError("refine=True expects a full-precision operator "
                             "to refine against; this one is already "
                             f"{op.dtype} -- pass the host matrix instead")
        t0 = time.perf_counter()
        if do_refine:
            op_lo = _cast_low_precision(op)
        phase_s["build"] = time.perf_counter() - t0

    b = _as_vector(b, dev)
    if method == "block_cg" and b.dim() != 2:
        raise ValueError(f"block_cg expects b of shape (n, k); got "
                         f"{tuple(b.shape)}")
    if method != "block_cg" and b.dim() != 1:
        raise ValueError(f"{method} expects a 1-D b; got shape "
                         f"{tuple(b.shape)}")
    x0 = None if x0 is None else _as_vector(x0, dev)
    strategy = ("fused"
                if (_fused_eligible(op, method, precond, b)
                    and strategy_pref != "composed")
                else "composed")

    t0 = time.perf_counter()
    res, ladder = _ladder_solve(op, op_lo, b, method=method,
                                strategy=strategy, maxiter=maxiter, tol=tol,
                                precond=precond, x0=x0, fallback=fallback)
    phase_s["solve"] = time.perf_counter() - t0
    res.info["phase_s"] = phase_s
    if info_tune is not None:
        res.info["tune"] = info_tune
    if len(ladder) > 1 or fallback not in ("off", False, None):
        res.info["ladder"] = ladder
    return res
