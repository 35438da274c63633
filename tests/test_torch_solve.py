"""``repro_torch.solve`` against ``repro.solve``: the fused CG and
BiCGStab over K3's function, the composed CG, BiCGStab and
preconditioned CG (Jacobi or a callable) over every format, and block
CG over K5's, with the same arguments, end in the same status and
strategy, within 2 iterations, with x within 1e-4 relative; the exit
contract (maxiter, tol <= 0, NaN) matches; the fused loop reads the
device once per chunk of iterations, block CG once per iteration;
unported options raise.

Tolerances: iterations +-2 and x relative 1e-4 -- both run the same f32
recurrences, but dot products sum in a different order, which moves the
exit test's last digits.  The systems are kept away from the edge of
their tolerance (tol 1e-5 on the Poisson grids; the sAMG analogue
converges in a handful of iterations), so the status cannot flip.
"""
import math

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import matrices as TM
from repro_torch.core import solvers as TS
from repro_torch.kernels import fused_iter as TFI
from repro_torch.kernels import ref as TR


def _jax():
    """The reference package, imported on use so the card test of this
    file runs where JAX is not installed."""
    pytest.importorskip("jax")
    import repro
    from repro.core import formats as F
    return repro, F


_CASES = {
    "samg": (lambda: TM.samg(scale=1e-4), 1e-6),
    "samg_seed4": (lambda: TM.samg(scale=2e-4, seed=4), 1e-6),
    "poisson24": (lambda: TM.poisson_2d(24, 24), 1e-5),
    "poisson17x19": (lambda: TM.poisson_2d(17, 19), 1e-5),
}


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _both(tm, b, **kw):
    repro, F = _jax()
    m = F.CSRMatrix(tm.indptr, tm.indices, tm.data, tm.shape)
    rj = repro.solve(m, b, tune="off", fallback="off", **kw)
    rt = repro_torch.solve(tm, b, tune="off", fallback="off", device="cpu",
                           **kw)
    return rj, rt


def _x_close(rj, rt, tol=1e-4):
    xj = np.asarray(rj.x, np.float64)
    xt = rt.x.numpy().astype(np.float64)
    assert xt.shape == xj.shape
    assert np.abs(xt - xj).max() <= tol * max(np.abs(xj).max(), 1e-30)


@pytest.mark.parametrize("fmt,strategy", [("auto", "fused"),
                                          ("pjds", "composed"),
                                          ("csr", "composed")])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_solve_matches_reference(name, fmt, strategy):
    mk, tol = _CASES[name]
    tm = mk()
    rj, rt = _both(tm, _rhs(tm.n_rows), format=fmt, tol=tol)
    assert rj.status == rt.status == "converged"
    assert rj.info["strategy"] == rt.info["strategy"] == strategy
    assert abs(int(rj.iters) - rt.iters) <= 2
    assert rt.diagnostics["true_residual"] <= tol
    _x_close(rj, rt)


# convection 17x19 at tol 3e-6, not 1e-5: float64 BiCGStab sits on a
# plateau at 9.89e-6 at iteration 25, right at 1e-5, where the
# reference's own formats end anywhere between 25 and 30 iterations;
# from there the residual falls tenfold within five iterations.
_BICG_CASES = {
    "convection17x19": (lambda: TM.convection_poisson(17, 19, beta=0.4),
                        3e-6),
    "poisson24": (lambda: TM.poisson_2d(24, 24), 1e-5),
    "samg": (lambda: TM.samg(scale=1e-4), 1e-6),
    "samg_seed4": (lambda: TM.samg(scale=2e-4, seed=4), 1e-6),
}


@pytest.mark.parametrize("fmt,strategy", [("auto", "fused"),
                                          ("pjds", "composed"),
                                          ("csr", "composed"),
                                          ("cmrs", "composed"),
                                          ("ellpack_r", "composed")])
@pytest.mark.parametrize("name", sorted(_BICG_CASES))
def test_bicgstab_matches_reference(name, fmt, strategy):
    mk, tol = _BICG_CASES[name]
    tm = mk()
    rj, rt = _both(tm, _rhs(tm.n_rows), method="bicgstab", format=fmt,
                   tol=tol)
    assert rj.status == rt.status == "converged"
    assert rj.info["strategy"] == rt.info["strategy"] == strategy
    assert abs(int(rj.iters) - rt.iters) <= 2
    assert rt.diagnostics["true_residual"] <= tol
    _x_close(rj, rt)


@pytest.mark.parametrize("name", sorted(_BICG_CASES))
def test_composed_bicgstab_over_sell_matches_reference(name):
    # format="sell" takes the fused strategy in solve; the composed
    # solver over the same SELL operand, called directly
    repro, F = _jax()
    from repro.core import solvers as JS
    from repro.core.operator import operator as joperator
    mk, tol = _BICG_CASES[name]
    tm = mk()
    b = _rhs(tm.n_rows)
    rj = JS.bicgstab(joperator(F.CSRMatrix(tm.indptr, tm.indices, tm.data,
                                           tm.shape), format="sell"),
                     np.asarray(b), tol=tol)
    rt = TS.bicgstab(repro_torch.operator(tm, "sell", device="cpu"),
                     torch.from_numpy(b), tol=tol)
    assert rj.status == rt.status == "converged"
    assert abs(int(rj.iters) - rt.iters) <= 2
    assert rt.info["host_syncs"] == 3 * rt.iters + 1
    _x_close(rj, rt)


def _half(r):
    """A callable preconditioner both packages can run: z = r / 2."""
    return r * 0.5


@pytest.mark.parametrize("precond", ["jacobi", "callable"])
@pytest.mark.parametrize("method", ["cg", "bicgstab"])
@pytest.mark.parametrize("name", sorted(_BICG_CASES))
def test_preconditioned_solve_matches_reference(name, method, precond):
    if method == "cg" and name == "convection17x19":
        pytest.skip("CG needs a symmetric operator")
    mk, tol = _BICG_CASES[name]
    tm = mk()
    pre = _half if precond == "callable" else precond
    rj, rt = _both(tm, _rhs(tm.n_rows), method=method, precond=pre, tol=tol)
    assert rj.status == rt.status == "converged"
    assert rj.info["strategy"] == rt.info["strategy"] == "composed"
    assert abs(int(rj.iters) - rt.iters) <= 2
    assert rt.diagnostics["true_residual"] <= tol
    _x_close(rj, rt)
    # format="auto" with a preconditioner goes through select_format
    from repro_torch.kernels import ops as TO
    assert TO.select_format(tm) != "sell" or tm.n_rows < 256


@pytest.mark.parametrize("fmt", ["auto", "pjds"])
def test_bicgstab_exit_contract_matches_reference(fmt):
    tm = TM.convection_poisson(17, 19, beta=0.4)
    b = _rhs(tm.n_rows)
    rj, rt = _both(tm, b, method="bicgstab", format=fmt, tol=1e-5,
                   maxiter=7)
    assert rj.status == rt.status == "maxiter"
    assert int(rj.iters) == rt.iters == 7
    _x_close(rj, rt)
    rj, rt = _both(tm, b, method="bicgstab", format=fmt, tol=0.0,
                   maxiter=30)
    assert int(rj.iters) == rt.iters == 30
    b[3] = np.nan
    rj, rt = _both(tm, b, method="bicgstab", format=fmt, tol=1e-5)
    assert rj.status == rt.status == "non_finite"
    assert not rt.converged


@pytest.mark.parametrize("fmt", ["auto", "pjds"])
def test_maxiter_is_an_honest_status(fmt):
    tm = TM.poisson_2d(24, 24)
    rj, rt = _both(tm, _rhs(tm.n_rows), format=fmt, tol=1e-5, maxiter=7)
    assert rj.status == rt.status == "maxiter"
    assert int(rj.iters) == rt.iters == 7
    _x_close(rj, rt)


@pytest.mark.parametrize("tol", [0.0, -1.0])
@pytest.mark.parametrize("fmt", ["auto", "pjds"])
def test_tol_le_zero_runs_to_maxiter(fmt, tol):
    # a probe: no early exit even once the residual reaches exactly 0,
    # and no failure flags (they are gated on tol > 0)
    tm = TM.samg(scale=1e-4)
    rj, rt = _both(tm, _rhs(tm.n_rows), format=fmt, tol=tol, maxiter=40)
    assert int(rj.iters) == rt.iters == 40
    # Only a residual of exactly 0 reads "converged" at tol <= 0.  XLA on
    # the CPU flushes float32 denormals to zero; the port's host reads do
    # the same, so past convergence both reach the same status, and the
    # composed loop the same recurrence residual (0.0 here).  The fused
    # drive reports the certified TRUE residual, which past convergence
    # sits at the float32 round-off floor of ||b - A x||; its digits
    # depend on the summation order (ROADMAP.md, faults found against
    # the reference), so that case is held to the floor only.
    assert rt.status == rj.status
    if fmt == "pjds":
        assert rt.residual == float(rj.residual)
    else:
        assert max(rt.residual, float(rj.residual)) <= 1e-6
    assert np.isfinite(rt.x.numpy()).all()


@pytest.mark.parametrize("fmt", ["auto", "pjds"])
def test_nan_in_b_is_non_finite(fmt):
    tm = TM.poisson_2d(12, 12)
    b = _rhs(tm.n_rows)
    b[5] = np.nan
    rj, rt = _both(tm, b, format=fmt, tol=1e-5)
    assert rj.status == rt.status == "non_finite"
    assert not rt.converged


def test_fused_loop_reads_the_device_once_per_iteration():
    # The loop runs on the device in chunks of TS.FUSED_CHUNK iterations;
    # per loop run the host reads (k, flag, done) once per chunk --
    # max(1, ceil(k / chunk)) reads -- and certifies with one more.
    tm = TM.poisson_2d(24, 24)
    chunk = TS.FUSED_CHUNK
    for method in ("cg", "bicgstab"):
        res = repro_torch.solve(tm, _rhs(tm.n_rows), method=method,
                                tune="off", fallback="off", tol=1e-5,
                                device="cpu")
        assert res.info["strategy"] == "fused" and res.status == "converged"
        assert res.diagnostics["restarts"] == 0 and res.iters > chunk
        assert res.info["chunk"] == chunk
        assert res.info["host_syncs"] == math.ceil(res.iters / chunk) + 1


def test_fused_cg_counts_the_plain_pass_on_cpu():
    # per run: one K3 pass to start, one per iteration of each chunk run
    # (masked ones after the exit included: they return at once), one
    # to certify; the init step once, then a step and an update each
    tm = TM.samg(scale=1e-4)
    TR.reset_calls()
    res = repro_torch.solve(tm, _rhs(tm.n_rows), tune="off", fallback="off",
                            device="cpu")
    assert res.diagnostics["restarts"] == 0 and res.status == "converged"
    chunk = TS.FUSED_CHUNK
    ran = chunk * max(1, math.ceil(res.iters / chunk))
    assert TR.fused_matvec_dots_ref.calls == ran + 2
    assert TR.krylov_step_ref.calls == ran + 1
    assert TR.krylov_update_ref.calls == ran


def test_solve_takes_an_operator_or_a_closure():
    tm = TM.poisson_2d(16, 16)
    b = _rhs(tm.n_rows)
    op = repro_torch.operator(tm, "sell", device="cpu")
    r_op = repro_torch.solve(op, b, tune="off", fallback="off", tol=1e-5)
    assert r_op.info["strategy"] == "fused" and r_op.status == "converged"
    r_cl = repro_torch.solve(op.matvec, b, tune="off", fallback="off",
                             tol=1e-5, device="cpu")
    assert r_cl.info["strategy"] == "composed"
    assert r_cl.status == "converged"
    np.testing.assert_allclose(r_cl.x.numpy(), r_op.x.numpy(), rtol=0,
                               atol=1e-4 * np.abs(r_op.x.numpy()).max())


def test_solve_refuses_what_is_neither_matrix_nor_operator():
    repro, F = _jax()
    m = F.CSRMatrix(*(getattr(TM.poisson_2d(4, 4), f)
                      for f in ("indptr", "indices", "data", "shape")))
    with pytest.raises(TypeError, match="CSRMatrix"):
        repro_torch.solve(m, np.ones(16), tune="off", fallback="off",
                          device="cpu")


def test_composed_cg_accepts_x0():
    tm = TM.poisson_2d(16, 16)
    b = torch.from_numpy(_rhs(tm.n_rows))
    op = repro_torch.operator(tm, "pjds", device="cpu")
    cold = TS.cg(op, b, tol=1e-5)
    warm = TS.cg(op, b, x0=cold.x, tol=1e-5)
    assert warm.iters <= 1 and warm.status == "converged"


@pytest.mark.parametrize("kw,item", [
    (dict(tune="off", fallback="off", reorder="auto"), "RCM"),
])
def test_unported_options_raise(kw, item):
    tm = TM.poisson_2d(8, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        repro_torch.solve(tm, np.ones(tm.n_rows), device="cpu", **kw)
    assert item in str(e.value)


def _rhs_block(n, k, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


@pytest.mark.parametrize("fmt", ["sell", "pjds", "csr", "cmrs", "auto"])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_block_cg_matches_reference(name, fmt):
    # same iterations and status, per-column recurrence residuals within
    # 10 % of each other (f32 Gram matrices summed in another order drift
    # apart over tens of iterations: 2.9 % measured on poisson17x19),
    # x within 1e-4
    mk, tol = _CASES[name]
    tm = mk()
    rj, rt = _both(tm, _rhs_block(tm.n_rows, 4), method="block_cg",
                   format=fmt, tol=tol)
    assert rj.status == rt.status == "converged"
    assert rt.info["strategy"] == rj.info["strategy"] == "composed"
    assert abs(int(rj.iters) - rt.iters) <= 2
    res_j = np.asarray(rj.residual, np.float64)
    assert rt.residual.shape == res_j.shape == (4,)
    np.testing.assert_allclose(rt.residual, res_j, rtol=0.1)
    assert rt.diagnostics["true_residual"] <= tol
    _x_close(rj, rt)
    # one read to start, one per iteration
    assert rt.info["host_syncs"] == rt.iters + 1


def test_block_cg_exit_contract_matches_reference():
    tm = TM.poisson_2d(24, 24)
    b = _rhs_block(tm.n_rows, 3)
    rj, rt = _both(tm, b, method="block_cg", format="sell", tol=1e-5,
                   maxiter=7)
    assert rj.status == rt.status == "maxiter"
    assert int(rj.iters) == rt.iters == 7
    _x_close(rj, rt)
    rj, rt = _both(tm, b, method="block_cg", format="pjds", tol=0.0,
                   maxiter=12)
    assert int(rj.iters) == rt.iters == 12
    assert rj.status == rt.status
    b[5, 1] = np.nan
    rj, rt = _both(tm, b, method="block_cg", format="sell", tol=1e-5)
    assert rj.status == rt.status == "non_finite"


def test_block_cg_runs_k5_plain_version_once_per_iteration_on_cpu():
    tm = TM.samg(scale=1e-4)
    TR.reset_calls()
    res = repro_torch.solve(tm, _rhs_block(tm.n_rows, 2), method="block_cg",
                            format="sell", tune="off", fallback="off",
                            device="cpu")
    # start + one per iteration + certification
    assert res.status == "converged"
    assert TR.pjds_matmat_ref.calls == res.iters + 2
    assert TR.sell_matvec_ref.calls == TR.fused_matvec_dots_ref.calls == 0


def test_block_cg_argument_rules():
    tm = TM.poisson_2d(8, 8)
    with pytest.raises(ValueError, match="shape"):
        repro_torch.solve(tm, np.ones(tm.n_rows), method="block_cg",
                          tune="off", fallback="off", device="cpu")
    with pytest.raises(ValueError, match="refine"):
        repro_torch.solve(tm, np.ones((tm.n_rows, 2)), method="block_cg",
                          refine=True, tune="off", fallback="off",
                          device="cpu")
    # block CG does not tune (as in the reference): tune="auto" runs
    res = repro_torch.solve(tm, _rhs_block(tm.n_rows, 2), method="block_cg",
                            fallback="off", device="cpu", tol=1e-5)
    assert res.status == "converged" and res.method == "block_cg"


def test_bad_arguments_raise_value_error():
    tm = TM.poisson_2d(8, 8)
    with pytest.raises(ValueError):
        repro_torch.solve(tm, np.ones(tm.n_rows), method="gmres",
                          device="cpu")
    with pytest.raises(ValueError):
        repro_torch.solve(tm, np.ones((tm.n_rows, 2)), tune="off",
                          fallback="off", device="cpu")
    with pytest.raises(ValueError):
        repro_torch.solve(tm, np.ones(tm.n_rows), fallback="maybe",
                          device="cpu")


def test_result_contract():
    tm = TM.poisson_2d(10, 10)
    res = repro_torch.solve(tm, _rhs(tm.n_rows), tune="off", fallback="off",
                            tol=1e-5, device="cpu")
    assert isinstance(res, TS.SolveResult)
    assert res.method == "cg" and res.converged is True
    assert res.status in TS.STATUS_NAMES
    assert set(res.info["phase_s"]) == {"tune", "build", "solve"}
    assert res.x.shape == (tm.n_rows,) and res.x.dtype == torch.float32
    assert isinstance(res.iters, int) and isinstance(res.residual, float)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,kernel", [("auto", "fused"), ("pjds", "pjds")])
def test_solve_on_card_matches_cpu(fmt, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels.pjds_spmv import pjds_matvec_kernel_call
    tm = TM.poisson_2d(40, 40)
    b = _rhs(tm.n_rows)
    r_cpu = repro_torch.solve(tm, b, tune="off", fallback="off", tol=1e-5,
                              format=fmt, device="cpu")
    counter = (TFI.fused_spmv_dots_kernel_call if kernel == "fused"
               else pjds_matvec_kernel_call)
    counter.launches = 0
    TR.reset_calls()
    r_gpu = repro_torch.solve(tm, b, tune="off", fallback="off", tol=1e-5,
                              format=fmt)
    assert r_gpu.status == r_cpu.status == "converged"
    assert abs(r_gpu.iters - r_cpu.iters) <= 2
    assert counter.launches >= r_gpu.iters + 1
    assert TR.fused_matvec_dots_ref.calls == TR.pjds_matvec_ref.calls == 0
    xg, xc = r_gpu.x.cpu().numpy(), r_cpu.x.numpy()
    assert np.abs(xg - xc).max() <= 1e-4 * np.abs(xc).max()


@pytest.mark.cuda
def test_block_cg_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels.pjds_spmm import pjds_matmat_kernel_call
    tm = TM.poisson_2d(40, 40)
    b = _rhs_block(tm.n_rows, 4)
    kw = dict(method="block_cg", format="sell", tune="off", fallback="off",
              tol=1e-5)
    r_cpu = repro_torch.solve(tm, b, device="cpu", **kw)
    pjds_matmat_kernel_call.launches = 0
    TR.reset_calls()
    r_gpu = repro_torch.solve(tm, b, **kw)
    assert r_gpu.status == r_cpu.status == "converged"
    assert abs(r_gpu.iters - r_cpu.iters) <= 2
    assert pjds_matmat_kernel_call.launches >= r_gpu.iters + 1
    assert not any(f.calls for f in TR._COUNTED)
    xg, xc = r_gpu.x.cpu().numpy(), r_cpu.x.numpy()
    assert np.abs(xg - xc).max() <= 1e-4 * np.abs(xc).max()


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kernel", [
    (dict(method="bicgstab"), "fused"),
    (dict(method="bicgstab", format="pjds"), "pjds"),
    (dict(precond="jacobi", format="cmrs"), "cmrs"),
    (dict(method="bicgstab", precond="jacobi", format="ellpack_r"), "ellr"),
])
def test_bicgstab_and_pcg_on_card_match_cpu(kw, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels import krylov_step as KS
    from repro_torch.kernels.cmrs_spmv import cmrs_matvec_kernel_call
    from repro_torch.kernels.ellr_spmv import ell_matvec_kernel_call
    from repro_torch.kernels.pjds_spmv import pjds_matvec_kernel_call
    tm = (TM.poisson_2d(40, 40) if kw.get("method", "cg") == "cg"
          else TM.convection_poisson(40, 40, beta=0.4))
    b = _rhs(tm.n_rows)
    r_cpu = repro_torch.solve(tm, b, tune="off", tol=1e-6, device="cpu",
                              **kw)
    counter = {"fused": TFI.fused_spmv_dots_kernel_call,
               "pjds": pjds_matvec_kernel_call,
               "cmrs": cmrs_matvec_kernel_call,
               "ellr": ell_matvec_kernel_call}[kernel]
    counter.launches = KS.step_kernel_call.launches = 0
    TR.reset_calls()
    r_gpu = repro_torch.solve(tm, b, tune="off", tol=1e-6, **kw)
    assert r_gpu.status == r_cpu.status == "converged"
    assert r_gpu.info["strategy"] == r_cpu.info["strategy"]
    assert abs(r_gpu.iters - r_cpu.iters) <= 2
    assert counter.launches >= r_gpu.iters + 1
    assert (KS.step_kernel_call.launches > 0) == (kernel == "fused")
    assert not any(f.calls for f in TR._COUNTED)
    xg, xc = r_gpu.x.cpu().numpy(), r_cpu.x.numpy()
    assert np.abs(xg - xc).max() <= 1e-4 * np.abs(xc).max()
