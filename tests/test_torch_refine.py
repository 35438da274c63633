"""Mixed-precision refinement in ``repro_torch.solve`` against
``repro.solve``: a bf16 (+ int16) inner operand, f32 residual
corrections (``core.solvers.iterative_refinement``), the same refine
reason and status, rounds within 1 and x within tolerance; the bf16 clone
of an f32 operator shares no fused loop or CUDA graph with it; a stalled
or capped refinement walks the reference's ladder, ``bf16->f32``
included.

Tolerances: rounds +-1 -- the inner solves run the same f32 recurrences
over the same bf16 values, but their dots sum in another order, which
can move an inner exit by an iteration and the last round's residual
across the outer tol.  x within 1e-4 * max|x| -- both sides certify
||b - A x|| / ||b|| <= 1e-6 against the same f32 operator, and these
systems are conditioned well enough that this bounds x's difference
far below it.  Products of the bf16 clones within 1e-5 * max|y| (the
same bf16 bits, f32 accumulation in another order).
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import api as TA
from repro_torch.core import matrices as TM
from repro_torch.core import solvers as TS
from repro_torch.kernels import ref as TR


def _jax():
    """The reference modules, imported on use so the card tests of this
    file run where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    import repro
    from repro import api as JA
    from repro.core import formats as F
    from repro.core import solvers as JS
    from repro.core.operator import operator as joperator
    return jnp, repro, JA, F, JS, joperator


_CASES = {
    "samg": (lambda: TM.samg(scale=1e-4), "cg"),
    "samg_seed4": (lambda: TM.samg(scale=2e-4, seed=4), "cg"),
    "poisson24": (lambda: TM.poisson_2d(24, 24), "cg"),
    "poisson17x19": (lambda: TM.poisson_2d(17, 19), "cg"),
    "samg_bicgstab": (lambda: TM.samg(scale=1e-4), "bicgstab"),
    "convection": (lambda: TM.convection_poisson(17, 19, beta=0.4),
                   "bicgstab"),
}


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _ref_matrix(tm):
    _, _, _, F, _, _ = _jax()
    return F.CSRMatrix(tm.indptr, tm.indices, tm.data, tm.shape)


def _x_close(xt, xj, tol=1e-4):
    xt = np.asarray(xt, np.float64)
    xj = np.asarray(xj, np.float64)
    assert np.abs(xt - xj).max() <= tol * max(np.abs(xj).max(), 1e-30)


def _same_refinement(rt, rj):
    assert rt.status == rj.status
    assert rt.diagnostics["refine_reason"] == rj.diagnostics["refine_reason"]
    assert rt.info["refine"]["reason"] == rj.info["refine"]["reason"]
    assert rt.info["refine"]["inner_dtype"] == \
        rj.info["refine"]["inner_dtype"] == "bfloat16"
    assert rt.info["refine"]["inner_tol"] == rj.info["refine"]["inner_tol"]
    assert abs(len(rt.info["refine"]["rounds"])
               - len(rj.info["refine"]["rounds"])) <= 1
    assert rt.info["strategy"] == rj.info["strategy"]
    _x_close(rt.x.numpy(), rj.x)


@pytest.mark.parametrize("spelling", ["bfloat16", torch.bfloat16])
@pytest.mark.parametrize("case", list(_CASES))
def test_bf16_solve_matches_reference(case, spelling):
    jnp, repro, *_ = _jax()
    mk, method = _CASES[case]
    tm = mk()
    b = _rhs(tm.n_rows)
    rj = repro.solve(_ref_matrix(tm), b, method=method, tune="off",
                     dtype=jnp.bfloat16)
    rt = repro_torch.solve(tm, b, method=method, tune="off", dtype=spelling,
                           device="cpu")
    assert rt.status == "converged"
    assert rt.info["strategy"] == "fused+refined"
    assert rt.info["ladder"] == [{"rung": "primary", "status": "converged",
                                  "true_residual":
                                      rt.diagnostics["true_residual"]}]
    _same_refinement(rt, rj)
    assert rt.diagnostics["true_residual"] <= 1e-6
    assert rt.iters == sum(r["inner_iters"]
                           for r in rt.info["refine"]["rounds"])
    assert rt.info["host_syncs"] >= len(rt.info["refine"]["rounds"]) + 2


def test_bf16_solve_with_the_default_tune(tmp_path, monkeypatch):
    """The reference's defaults: ``tune="auto"`` (served here from a
    cache seeded with fused winning, so the pick is fixed) and
    ``refine="auto"``; the tuner measured the f32 layout."""
    jnp, repro, *_ = _jax()
    from repro_torch import tune as TT
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    tm = TM.poisson_2d(24, 24)
    b = _rhs(tm.n_rows, 3)
    TT.tune_solver(tm, device="cpu",
                   measure_fn=lambda m, s, c, **kw: 1.0 if s == "fused"
                   else 2.0)
    rt = repro_torch.solve(tm, b, dtype="bfloat16", device="cpu")
    assert rt.info["tune"]["cached"] and rt.info["tune"]["strategy"] == \
        "fused"
    rj = repro.solve(_ref_matrix(tm), b, dtype=jnp.bfloat16, tune="off")
    _same_refinement(rt, rj)


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_refine_true_on_a_host_matrix(precond):
    jnp, repro, *_ = _jax()
    tm = TM.samg(scale=2e-4, seed=4)
    b = _rhs(tm.n_rows, 1)
    rj = repro.solve(_ref_matrix(tm), b, tune="off", refine=True,
                     precond=precond)
    rt = repro_torch.solve(tm, b, tune="off", refine=True, precond=precond,
                           device="cpu")
    _same_refinement(rt, rj)
    assert rt.info["strategy"] == ("fused+refined" if precond is None
                                   else "composed+refined")


@pytest.mark.parametrize("fmt", ["sell", "pjds", "ellpack_r", "cmrs", "csr"])
def test_cast_low_precision_matches_reference(fmt):
    jnp, repro, JA, F, JS, joperator = _jax()
    tm = TM.samg(scale=2e-4)
    op = repro_torch.operator(tm, fmt, device="cpu")
    jop = joperator(_ref_matrix(tm), fmt)
    lo, jlo = TA._cast_low_precision(op), JA._cast_low_precision(jop)
    assert lo.dtype == torch.bfloat16 and lo.fmt == jlo.fmt == fmt
    vals = np.asarray(jlo.dev.dev.data if fmt == "csr" else jlo.dev.dev.val)
    got = lo.values.view(torch.int16).numpy()
    if fmt == "csr":
        np.testing.assert_array_equal(got, vals.view(np.int16))
    else:
        np.testing.assert_array_equal(got.reshape(-1),
                                      vals.view(np.int16).reshape(-1)
                                      [: got.size])
    if fmt != "csr":
        assert str(lo.dev.dev.col_idx.dtype).removeprefix("torch.") == \
            str(jlo.dev.dev.col_idx.dtype)
    x = _rhs(tm.n_cols, 2)
    y = (lo @ torch.from_numpy(x)).numpy()
    yj = np.asarray(jlo @ jnp.asarray(x))
    assert np.abs(y - yj).max() <= 1e-5 * np.abs(yj).max()


def test_the_bf16_clone_shares_no_fused_loop():
    tm = TM.poisson_2d(24, 24)
    b = torch.from_numpy(_rhs(tm.n_rows))
    op = repro_torch.operator(tm, "sell", device="cpu")
    first = repro_torch.solve(op, b, tol=1e-5, fallback="off")
    mvd = op.dev.fused["auto"]
    loops = dict(mvd.loops)
    assert loops                                   # the f32 loop exists
    op.dev.row_map()
    d = op.dev.dev
    dtypes = (d.val.dtype, d.col_idx.dtype)
    lo = TA._cast_low_precision(op)
    assert lo.dev is not op.dev and lo.dev.fused == {}
    assert lo.dev.fused is not op.dev.fused and lo.dev._out_row is None
    dl = lo.dev.dev
    assert dl.val.dtype == torch.bfloat16 and dl.col_idx.dtype == torch.int16
    assert dl.warp_len is d.warp_len and dl.inv_perm is d.inv_perm
    assert (d.val.dtype, d.col_idx.dtype) == dtypes == (torch.float32,
                                                        torch.int16)
    res = repro_torch.solve(op, b, tol=1e-5, refine=True, fallback="off")
    assert res.status == "converged"
    assert res.info["strategy"] == "fused+refined"
    # the f32 operand's fused pass and loops are the same objects, and a
    # fused solve on it repeats its first result bit for bit
    assert op.dev.fused == {"auto": mvd} and mvd.loops == loops
    again = repro_torch.solve(op, b, tol=1e-5, fallback="off")
    assert torch.equal(again.x, first.x) and again.iters == first.iters


def test_refine_on_an_operator_matches_reference():
    jnp, repro, JA, F, JS, joperator = _jax()
    tm = TM.poisson_2d(17, 19)
    b = _rhs(tm.n_rows, 5)
    rj = repro.solve(joperator(_ref_matrix(tm), "sell"), jnp.asarray(b),
                     refine=True)
    rt = repro_torch.solve(repro_torch.operator(tm, "sell", device="cpu"),
                           b, refine=True)
    _same_refinement(rt, rj)


def test_refine_false_solves_in_bf16():
    jnp, repro, *_ = _jax()
    tm = TM.samg(scale=1e-4)
    b = _rhs(tm.n_rows)
    rj = repro.solve(_ref_matrix(tm), b, tune="off", dtype=jnp.bfloat16,
                     refine=False, fallback="off")
    rt = repro_torch.solve(tm, b, tune="off", dtype="bfloat16", refine=False,
                           fallback="off", device="cpu")
    assert rt.status == rj.status and "refine" not in rt.info
    assert rt.info["strategy"] == "fused"
    assert abs(rt.iters - int(rj.iters)) <= 2


def _stalling(orig, zeros):
    def fn(residual_of, inner, b_, **kw):
        # the inner solve never improves anything -- the way a matrix
        # too ill-conditioned for bf16 values surfaces
        return orig(residual_of, lambda r: (zeros(r), 1, 1.0), b_, **kw)
    return fn


def _capped(orig):
    def fn(residual_of, inner, b_, **kw):
        return orig(residual_of, inner, b_, max_rounds=1, **kw)
    return fn


@pytest.mark.parametrize("how", ["stalled", "max_rounds"])
def test_a_failed_refinement_walks_the_reference_ladder(how, monkeypatch):
    jnp, repro, JA, F, JS, joperator = _jax()
    tm = TM.poisson_2d(8, 8)
    b = _rhs(tm.n_rows, 7)
    if how == "stalled":
        monkeypatch.setattr(JS, "iterative_refinement",
                            _stalling(JS.iterative_refinement,
                                      jnp.zeros_like))
        monkeypatch.setattr(TS, "iterative_refinement",
                            _stalling(TS.iterative_refinement,
                                      torch.zeros_like))
    else:
        monkeypatch.setattr(JS, "iterative_refinement",
                            _capped(JS.iterative_refinement))
        monkeypatch.setattr(TS, "iterative_refinement",
                            _capped(TS.iterative_refinement))
    m = _ref_matrix(tm)
    for fallback in ("off", "auto"):
        rj = repro.solve(m, b, dtype="bfloat16", tune="off",
                         fallback=fallback)
        rt = repro_torch.solve(tm, b, dtype="bfloat16", tune="off",
                               fallback=fallback, device="cpu")
        assert rt.status == rj.status
        assert rt.diagnostics.get("refine_reason") == \
            rj.diagnostics.get("refine_reason")
        if fallback == "off":
            assert "ladder" not in rt.info and "ladder" not in rj.info
            continue
        want = [(e["rung"], e.get("status")) for e in rj.info["ladder"]]
        got = [(e["rung"], e.get("status")) for e in rt.info["ladder"]]
        assert got == want
    assert got[-1][1] == "converged" and rt.diagnostics["certified"]
    if how == "stalled":           # no refined rung can succeed
        assert got == [("primary", "diverged"),
                       ("fused->composed", "diverged"),
                       ("bf16->f32", "converged")]
    else:                          # a capped round is not the end
        assert got[0] == ("primary", "maxiter") and len(got) > 1


def test_iterative_refinement_reason_codes():
    b = torch.ones(8)
    residual_of = lambda x: b - x                    # A = I
    x, rn, rounds, reason = TS.iterative_refinement(
        residual_of, lambda r: (r, 1, 0.0), b)
    assert reason == "converged" and rn <= 1e-6 and len(rounds) == 1
    x, rn, rounds, reason = TS.iterative_refinement(
        residual_of, lambda r: (torch.zeros_like(r), 1, 1.0), b)
    assert reason == "stalled" and len(rounds) == 1
    x, rn, rounds, reason = TS.iterative_refinement(
        residual_of, lambda r: (torch.full_like(r, float("nan")), 1, 1.0), b)
    assert reason == "non_finite"
    x, rn, rounds, reason = TS.iterative_refinement(
        residual_of, lambda r: (0.5 * r, 3, 0.5), b, max_rounds=2)
    assert reason == "max_rounds" and len(rounds) == 2
    assert rounds[0] == {"residual_in": 1.0, "inner_iters": 3,
                         "inner_residual": 0.5}


def test_refinement_refuses_what_it_cannot_cast():
    tm = TM.poisson_2d(8, 8)
    b = _rhs(tm.n_rows)
    op = repro_torch.operator(tm, "sell", device="cpu")
    with pytest.raises(ValueError, match="callable precond"):
        repro_torch.solve(tm, b, refine=True, precond=lambda r: r,
                          device="cpu")
    with pytest.raises(ValueError, match="block"):
        repro_torch.solve(tm, np.ones((tm.n_rows, 2)), method="block_cg",
                          refine=True, device="cpu")
    with pytest.raises(ValueError, match="closure"):
        repro_torch.solve(op.matvec, torch.from_numpy(b), refine=True,
                          device="cpu")
    lo = repro_torch.operator(tm, "sell", device="cpu", dtype="bfloat16")
    with pytest.raises(ValueError, match="full-precision"):
        repro_torch.solve(lo, b, refine=True)


# ------------------------------------------------------------ the card
@pytest.mark.cuda
def test_bf16_solve_on_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    tm = TM.samg(scale=3e-3)
    b = _rhs(tm.n_rows)
    cpu = repro_torch.solve(tm, b, dtype="bfloat16", tune="off",
                            device="cpu")
    TR.reset_calls()
    res = repro_torch.solve(tm, b, dtype="bfloat16", tune="off")
    assert not any(f.calls for f in TR._COUNTED)      # kernels only
    assert res.status == cpu.status == "converged"
    assert res.x.device.type == "cuda"
    assert abs(len(res.info["refine"]["rounds"])
               - len(cpu.info["refine"]["rounds"])) <= 1
    _x_close(res.x.cpu().numpy(), cpu.x.numpy())
    tuned = repro_torch.solve(tm, b, dtype="bfloat16")
    assert tuned.status == "converged" and "tune" in tuned.info


@pytest.mark.cuda
def test_refine_cast_on_card_keeps_the_f32_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    tm = TM.poisson_2d(64, 64)
    b = torch.from_numpy(_rhs(tm.n_rows)).cuda()
    op = repro_torch.operator(tm, "sell")
    first = repro_torch.solve(op, b, tol=1e-5, fallback="off")
    mvd = op.dev.fused["auto"]
    graphs = {k: loop.graph for k, loop in mvd.loops.items()}
    assert all(g is not None for g in graphs.values())
    res = repro_torch.solve(op, b, tol=1e-5, refine=True, fallback="off")
    assert res.status == "converged"
    assert {k: loop.graph for k, loop in mvd.loops.items()} == graphs
    again = repro_torch.solve(op, b, tol=1e-5, fallback="off")
    assert torch.equal(again.x, first.x)
    assert again.info["graph_capture_s"] == 0.0
