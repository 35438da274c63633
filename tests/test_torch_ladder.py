"""The degradation ladder (``fallback="auto"``) against the reference's.

Same rungs, labels and statuses as ``repro.solve``: on Poisson 128^2
with b = ones the f32 recurrences drift, certification demotes every
rung and both packages raise ``SolveFailure`` with the ladder
primary -> fused->composed -> escalate:fresh-x0+jacobi, all
"diverged"; at tol 1e-4 the primary rung converges.  NaN values fail
typed on every rung.  The port's deliberate differences (ROADMAP.md,
faults found against the reference): no rung catches an exception, so
a rung that raises ends the solve with that exception; the kernel->ref
rung never appears.  The bf16->f32 rung of a refined solve is held to
the reference's in ``tests/test_torch_refine.py``.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import SolveFailure
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM


def _jax():
    pytest.importorskip("jax")
    import repro
    from repro.core import formats as F
    return repro, F


def _jm(F, tm):
    return F.CSRMatrix(tm.indptr, tm.indices, tm.data, tm.shape)


def _rungs(ladder):
    return [(e["rung"], e.get("status", "error")) for e in ladder]


_POISSON128_LADDER = [("primary", "diverged"),
                      ("fused->composed", "diverged"),
                      ("escalate:fresh-x0+jacobi", "diverged")]


def test_ladder_exhausts_on_poisson128_as_in_the_reference():
    repro, F = _jax()
    tm = TM.poisson_2d(128, 128)
    b = np.ones(tm.n_rows, np.float32)
    with pytest.raises(repro.SolveFailure) as ej:
        repro.solve(_jm(F, tm), b, tol=1e-5, tune="off")
    with pytest.raises(SolveFailure) as et:
        repro_torch.solve(tm, b, tol=1e-5, tune="off", device="cpu")
    assert _rungs(et.value.ladder) == _rungs(ej.value.ladder) \
        == _POISSON128_LADDER
    res = et.value.result
    assert res.status == "diverged" and res.diagnostics["demoted"]
    for e in et.value.ladder:
        assert 1e-5 < e["true_residual"] < 1e-3


def test_ladder_converges_on_the_primary_rung_at_1e4():
    repro, F = _jax()
    tm = TM.poisson_2d(128, 128)
    b = np.ones(tm.n_rows, np.float32)
    rj = repro.solve(_jm(F, tm), b, tol=1e-4, tune="off")
    rt = repro_torch.solve(tm, b, tol=1e-4, tune="off", device="cpu")
    assert _rungs(rt.info["ladder"]) == _rungs(rj.info["ladder"]) \
        == [("primary", "converged")]
    assert rt.info["strategy"] == "fused"
    assert abs(rt.iters - int(rj.iters)) <= 2
    assert rt.diagnostics["true_residual"] <= 1e-4


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_poisoned_values_fail_typed_on_every_rung(method):
    # the port's counterpart of test_poisoned_values_fail_typed_not_silent
    repro, F = _jax()
    tm = TM.poisson_2d(8, 8)
    data = tm.data.copy()
    data[np.random.default_rng(0).choice(data.size, 3, replace=False)] = \
        np.nan
    tp = TF.CSRMatrix(tm.indptr, tm.indices, data, tm.shape)
    b = np.random.default_rng(1).standard_normal(tm.n_rows).astype(
        np.float32)
    res = repro_torch.solve(tp, b, method=method, tune="off",
                            fallback="off", device="cpu")
    assert res.status == "non_finite" and not res.converged
    assert "ladder" not in res.info
    with pytest.raises(repro.SolveFailure) as ej:
        repro.solve(_jm(F, tp), b, method=method, tune="off")
    with pytest.raises(SolveFailure) as et:
        repro_torch.solve(tp, b, method=method, tune="off", device="cpu")
    assert _rungs(et.value.ladder) == _rungs(ej.value.ladder)
    assert all(s in ("non_finite", "breakdown", "diverged")
               for _, s in _rungs(et.value.ladder))
    # the clean matrix converges, certified
    res = repro_torch.solve(tm, b, method=method, tune="off", device="cpu")
    assert res.status == "converged" and res.diagnostics["certified"]


def test_ladder_of_a_bare_closure_escalates_without_jacobi():
    # a closure has no diagonal(): the last rung restarts fresh, as in
    # the reference; NaN in b makes every rung fail
    repro, F = _jax()
    from repro.core.operator import operator as joperator
    tm = TM.poisson_2d(10, 10)
    b = np.ones(tm.n_rows, np.float32)
    b[4] = np.nan
    op = repro_torch.operator(tm, "pjds", device="cpu")
    with pytest.raises(SolveFailure) as et:
        repro_torch.solve(op.matvec, b, tune="off", device="cpu")
    with pytest.raises(repro.SolveFailure) as ej:
        repro.solve(joperator(_jm(F, tm), format="pjds").matvec, b,
                    tune="off")
    assert _rungs(et.value.ladder) == _rungs(ej.value.ladder) == [
        ("primary", "non_finite"), ("escalate:fresh-x0", "non_finite")]


def test_maxiter_ends_the_ladder_without_escalating():
    tm = TM.poisson_2d(24, 24)
    b = np.random.default_rng(0).standard_normal(tm.n_rows).astype(
        np.float32)
    res = repro_torch.solve(tm, b, tol=1e-5, maxiter=5, tune="off",
                            device="cpu")
    assert res.status == "maxiter" and res.iters == 5
    assert _rungs(res.info["ladder"]) == [("primary", "maxiter")]


def test_fallback_off_returns_the_typed_failure():
    tm = TM.poisson_2d(128, 128)
    res = repro_torch.solve(tm, np.ones(tm.n_rows, np.float32), tol=1e-5,
                            tune="off", fallback="off", device="cpu")
    assert res.status == "diverged" and "ladder" not in res.info


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("fallback", ["auto", "off"])
def test_a_rung_that_raises_propagates(fallback):
    # the reference records the error and walks on; the port does not
    # catch it (in the port it can only be a kernel failure)
    tm = TM.poisson_2d(12, 12)
    calls = []

    def precond(r):
        calls.append(1)
        raise _Boom("preconditioner failed")

    with pytest.raises(_Boom):
        repro_torch.solve(tm, np.ones(tm.n_rows), precond=precond,
                          tune="off", fallback=fallback, device="cpu")
    assert len(calls) == 1


def test_a_later_rung_that_raises_propagates():
    # the primary rung fails typed (NaN in b); the escalation rung's
    # Jacobi build raises -- and that exception, not SolveFailure, ends
    # the solve
    tm = TM.poisson_2d(12, 12)
    op = repro_torch.operator(tm, "sell", device="cpu")

    def diagonal():
        raise _Boom("diagonal failed")

    op.diagonal = diagonal
    b = np.ones(tm.n_rows, np.float32)
    b[0] = np.nan
    with pytest.raises(_Boom):
        repro_torch.solve(op, b, tune="off", device="cpu")


def test_solve_failure_carries_the_last_result():
    tm = TM.poisson_2d(12, 12)
    b = torch.ones(tm.n_rows)
    b[2] = float("inf")
    with pytest.raises(SolveFailure, match="every ladder rung") as e:
        repro_torch.solve(tm, b, method="bicgstab", tune="off",
                          device="cpu")
    assert e.value.result.status == "non_finite"
    assert [r for r, _ in _rungs(e.value.ladder)] == [
        "primary", "fused->composed", "escalate:fresh-x0+jacobi"]
