"""The port's fault harness (``repro_torch.testing.faults``): the
counterparts of ``tests/test_robustness.py``, side by side with the
reference where the outcome is shared.

Every fault ends in a typed status, a raised error, or a mismatch that
a check against the clean matrix sees -- never a silent wrong answer.
Two outcomes differ from the reference's on purpose (ROADMAP.md,
queue 3): the port's ladder catches nothing and has no ``kernel->ref``
rung, so a rung that raises (``fail_strategy``, ``fail_kernel_backend``)
ends ``solve`` with the :class:`faults.InjectedFault`, where the
reference's ladder walks on; the serving scheduler turns that raise
into a typed ``"error"`` status.  The halo faults run on the same
4-rank partition of ``poisson_2d(16, 16)`` on both packages (the
reference on four virtual host devices in a subprocess): a consistent
wrong y under ``drop_halo`` (the port's within 1e-5 * max|y| of the
reference's), and a solve that is not certified under ``garble_halo``.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro_torch
from repro_torch.api import SolveFailure
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.core.dist_comm import ThreadComm, run_ranks
from repro_torch.core.operator import dist_operator
from repro_torch.kernels import ops as TO
from repro_torch.serve import SolveEngine, SolveRequest
from repro_torch.testing import faults

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


def _jax():
    """The reference modules, imported on use so the card tests of this
    file run where JAX is not installed."""
    pytest.importorskip("jax")
    import repro
    from repro.core import formats as F
    from repro.testing import faults as JF
    return repro, F, JF


def _spd(seed=0):
    tm = TM.poisson_2d(8, 8)
    b = np.random.default_rng(seed).standard_normal(tm.n_rows).astype(
        np.float32)
    return tm, b


def _ref(tm):
    _, F, _ = _jax()
    return F.CSRMatrix(tm.indptr, tm.indices, tm.data, tm.shape)


def _rungs(ladder):
    return [(e["rung"], e.get("status", "error")) for e in ladder]


# ------------------------------------------------------------ value poison
def test_poisoned_values_fail_typed_not_silent():
    repro, _, JF = _jax()
    tm, b = _spd()
    m = _ref(tm)
    with faults.poison_values(tm, count=3), JF.poison_values(m, count=3):
        res = repro_torch.solve(tm, b, tune="off", fallback="off",
                                device="cpu")
        jres = repro.solve(m, b, tune="off", fallback="off")
        assert res.status == jres.status == "non_finite"
        assert not bool(res.converged)
        with pytest.raises(SolveFailure) as ei:
            repro_torch.solve(tm, b, tune="off", fallback="auto",
                              device="cpu")
        with pytest.raises(repro.SolveFailure) as ej:
            repro.solve(m, b, tune="off", fallback="auto")
    assert _rungs(ei.value.ladder) == _rungs(ej.value.ladder)
    assert all(e["status"] in ("non_finite", "breakdown", "diverged")
               for e in ei.value.ladder)
    res = repro_torch.solve(tm, b, tune="off", device="cpu")
    assert res.status == "converged" and res.diagnostics["certified"]


def test_poison_restores_values():
    tm, _ = _spd()
    before = tm.data.copy()
    with faults.poison_values(tm, count=5, value=np.inf):
        assert not np.all(np.isfinite(tm.data))
    np.testing.assert_array_equal(tm.data, before)
    with pytest.raises(ValueError, match="no stored values"):
        with faults.poison_values(TF.csr_from_dense(np.zeros((3, 3)))):
            pass


def test_poison_reaches_builds_inside_the_block_only():
    """The conversion cache is cleared on entry and exit: an operator
    built before the block stays clean, one built inside is poisoned,
    and one built after is clean again."""
    tm, _ = _spd()
    x = torch.ones(tm.n_rows)
    before = repro_torch.operator(tm, "sell", device="cpu")
    with faults.poison_values(tm, count=2):
        inside = repro_torch.operator(tm, "sell", device="cpu")
        assert not torch.isfinite(inside @ x).all()
        assert torch.isfinite(before @ x).all()
    after = repro_torch.operator(tm, "sell", device="cpu")
    assert after is not inside and torch.isfinite(after @ x).all()


# ------------------------------------------------------------ validation
def test_validate_check_raises_on_poison():
    tm, b = _spd()
    with faults.poison_values(tm, count=2):
        with pytest.raises(TF.CSRValidationError) as ei:
            repro_torch.solve(tm, b, tune="off", validate="check",
                              device="cpu")
    assert "non_finite_values" in ei.value.report.issues


def test_validate_repair_drops_poison_and_solves():
    repro, _, JF = _jax()
    tm, b = _spd()
    m = _ref(tm)
    with faults.poison_values(tm, count=2), JF.poison_values(m, count=2):
        res = repro_torch.solve(tm, b, tune="off", validate="repair",
                                fallback="off", device="cpu")
        jres = repro.solve(m, b, tune="off", validate="repair",
                           fallback="off")
        assert res.status == jres.status
        assert res.status in ("converged", "maxiter", "breakdown",
                              "diverged")
        assert torch.isfinite(res.x).all()
        res = repro_torch.solve(tm, b, method="bicgstab", tune="off",
                                validate="repair", device="cpu")
    assert res.status == "converged" and res.diagnostics["certified"]


def test_as_device_validate_wiring():
    tm, _ = _spd()
    with faults.poison_values(tm, count=1):
        with pytest.raises(TF.CSRValidationError):
            TO.as_device(tm, validate="check", device="cpu")
        dev = TO.as_device(tm, validate="repair", device="cpu")
        assert torch.isfinite(dev.matvec(torch.ones(tm.n_rows))).all()
    with pytest.raises(ValueError):
        TO.as_device(tm, validate="sometimes", device="cpu")


# ------------------------------------------------------------ tune cache
@pytest.mark.parametrize("mode", ["truncate", "garbage", "bad_schema",
                                  "missing_keys"])
def test_corrupt_tune_cache_degrades_to_remeasure(mode, tmp_path,
                                                  monkeypatch):
    from repro_torch import tune as T
    from repro_torch.tune import cache as TC
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tc.json"))
    monkeypatch.setattr(TC, "_DEFAULT", None)
    tm, b = _spd()
    r0 = repro_torch.solve(tm, b, device="cpu")
    assert r0.status == "converged" and not r0.info["tune"]["cached"]
    cache_path = T.default_cache().path
    assert cache_path.exists()

    def fresh_process():
        monkeypatch.setattr(TC, "_DEFAULT", None)

    with faults.corrupt_tune_cache(cache_path, mode=mode):
        if mode in ("bad_schema", "missing_keys"):
            fresh = TC.TuneCache(cache_path)
            for key in json.loads(cache_path.read_text())["entries"]:
                assert fresh.get(key, require=("strategy",)) is None
            assert fresh.quarantined
        fresh_process()
        res = repro_torch.solve(tm, b, device="cpu")
        assert res.status == "converged"
        assert not res.info["tune"]["cached"]
    fresh_process()
    res = repro_torch.solve(tm, b, device="cpu")
    assert res.info["tune"]["cached"]


def test_corrupt_tune_cache_unknown_mode(tmp_path):
    with pytest.raises(ValueError, match="mode"):
        with faults.corrupt_tune_cache(tmp_path / "c.json", mode="melt"):
            pass
    with pytest.raises(FileNotFoundError):
        with faults.corrupt_tune_cache(tmp_path / "none.json"):
            pass


# ------------------------------------------------------------ forced rungs
def test_fused_failure_falls_through_to_composed():
    """Deliberate difference: the reference's ladder records the
    injected fused failure and converges on ``fused->composed``; the
    port's ladder catches nothing, so the fault ends the solve."""
    repro, _, JF = _jax()
    tm, b = _spd()
    with JF.fail_strategy("fused"):
        jres = repro.solve(_ref(tm), b, tune="off", fallback="auto")
    assert jres.status == "converged"
    assert jres.info["ladder"][-1]["rung"] == "fused->composed"
    with faults.fail_strategy("fused"):
        with pytest.raises(faults.InjectedFault, match="fused"):
            repro_torch.solve(tm, b, tune="off", fallback="auto",
                              device="cpu")
        # a rung the fault does not name runs as before
        res = repro_torch.solve(tm, b, tune="off", format="csr",
                                fallback="auto", device="cpu")
    assert res.status == "converged" and res.info["strategy"] == "composed"


def test_fused_failure_with_fallback_off_raises_original():
    repro, _, JF = _jax()
    tm, b = _spd()
    with JF.fail_strategy("fused"):
        with pytest.raises(JF.InjectedFault):
            repro.solve(_ref(tm), b, tune="off", fallback="off")
    with faults.fail_strategy("fused"):
        with pytest.raises(faults.InjectedFault):
            repro_torch.solve(tm, b, tune="off", fallback="off",
                              device="cpu")


def test_kernel_failure_falls_through_to_ref(monkeypatch):
    """Deliberate difference: the reference walks to ``kernel->ref``
    (the Pallas kernel's plain version); the port has no such rung, and
    the fault propagates.  On the CPU the operator resolves to the plain
    versions, so the fault stays quiet until the test makes the CPU
    stand in for a card."""
    repro, _, JF = _jax()
    tm, b = _spd()
    with JF.fail_kernel_backend():
        jres = repro.solve(_ref(tm), b, tune="off", backend="kernel",
                           fallback="auto")
    assert jres.status == "converged"
    assert any("injected" in e.get("error", "")
               for e in jres.info["ladder"][:-1])
    with faults.fail_kernel_backend():
        res = repro_torch.solve(tm, b, tune="off", device="cpu")
        assert res.status == "converged"       # the CPU runs no kernel
        monkeypatch.setattr(faults, "resolve_backend",
                            lambda x, backend="auto": "kernel")
        with pytest.raises(faults.InjectedFault, match="kernel-launch"):
            repro_torch.solve(tm, b, tune="off", fallback="auto",
                              device="cpu")


def test_all_rungs_fail_raises_solve_failure():
    """The reference raises ``SolveFailure`` listing every rung's
    injected error; the port raises the first rung's fault."""
    repro, _, JF = _jax()
    tm, b = _spd()
    with JF.fail_strategy("fused", "composed"):
        with pytest.raises(repro.SolveFailure) as ej:
            repro.solve(_ref(tm), b, tune="off", fallback="auto")
    assert all("injected" in e["error"] for e in ej.value.ladder)
    with faults.fail_strategy("fused", "composed"):
        with pytest.raises(faults.InjectedFault, match="fused"):
            repro_torch.solve(tm, b, tune="off", fallback="auto",
                              device="cpu")


# ------------------------------------------------------------ serve engine
def _engine_setup(**kw):
    tm = TM.poisson_2d(12, 12)
    op = repro_torch.operator(tm, b_r=32, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [SolveRequest(rid=i, b=rng.standard_normal(tm.n_rows)
                         .astype(np.float32)) for i in range(4)]
    return SolveEngine(op, slots=4, maxiter=1200, tol=1e-6, **kw), reqs, tm


def _true_rel(tm, x, b):
    a = sp.csr_matrix((tm.data, tm.indices, tm.indptr), shape=tm.shape)
    return np.linalg.norm(a @ np.asarray(x, np.float64) - b) \
        / np.linalg.norm(b)


def test_engine_rejects_nonfinite_rhs():
    eng, reqs, _ = _engine_setup()
    reqs[2].b = reqs[2].b.copy()
    reqs[2].b[5] = np.nan
    eng.run(reqs)
    assert reqs[2].status == "rejected"
    assert "non-finite" in reqs[2].diagnostics["reason"]
    assert all(r.status == "converged" for r in reqs if r.rid != 2)


def test_engine_bisects_poisoned_batch():
    eng, reqs, tm = _engine_setup()
    eng._admit = lambda req: True          # let the poison through
    reqs[1].b = reqs[1].b.copy()
    reqs[1].b[3] = np.nan
    eng.run(reqs)
    assert reqs[1].done and reqs[1].status in ("non_finite", "breakdown",
                                               "diverged")
    for r in reqs:
        if r.rid != 1:
            assert r.status == "converged"
            assert _true_rel(tm, r.x, r.b) < 1e-4


def test_engine_sheds_expired_deadlines():
    eng, reqs, _ = _engine_setup()
    reqs[0].deadline_s = 0.0
    eng.run(reqs)
    assert reqs[0].status == "shed" and reqs[0].x is None
    assert reqs[0].diagnostics["deadline_s"] == 0.0
    assert all(r.status == "converged" for r in reqs[1:])


def test_engine_infrastructure_error_is_typed(monkeypatch):
    eng, reqs, _ = _engine_setup()
    monkeypatch.setattr(
        eng, "_dispatch",
        lambda batch: (_ for _ in ()).throw(RuntimeError("boom")))
    eng.run(reqs[:1])
    assert reqs[0].status == "error"
    assert "boom" in reqs[0].diagnostics["error"]


def test_injected_solve_fault_is_a_typed_error_in_serving(monkeypatch):
    """A fault that propagates out of ``solve`` (the port's ladder
    catches nothing) reaches the scheduler, which bisects the group and
    types every request ``"error"`` with the fault in its diagnostics."""
    for fault in ("strategy", "kernel"):
        eng, reqs, _ = _engine_setup()
        if fault == "strategy":
            ctx = faults.fail_strategy("composed")
        else:
            monkeypatch.setattr(faults, "resolve_backend",
                                lambda x, backend="auto": "kernel")
            ctx = faults.fail_kernel_backend()
        with ctx:
            eng.run(reqs)
        assert [r.status for r in reqs] == ["error"] * 4
        assert all("InjectedFault" in r.diagnostics["error"] for r in reqs)
        assert eng.metrics.counters["error"] == 4
        assert eng.metrics.counters["group_splits"] == 3
        monkeypatch.undo()


# ------------------------------------------------------------ halo faults
_REF_HALO = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import repro
    from repro.core import matrices as M
    from repro.core.operator import dist_operator
    from repro.testing import faults

    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    m = M.poisson_2d(16, 16)
    out = {}

    def padded(op, seed):
        v = np.zeros(op.dist.n_global_pad, np.float32)
        v[:m.n_rows] = np.random.default_rng(seed).standard_normal(m.n_rows)
        return v, jax.device_put(jnp.asarray(v),
                                 jax.NamedSharding(mesh, P("data")))

    with faults.drop_halo():
        op = dist_operator(m, mesh, b_r=32)
        x, xj = padded(op, 1)
        f = jax.jit(op.matvec)
        out["drop_y"] = np.asarray(f(xj))
        out["drop_y2"] = np.asarray(f(xj))
        b, bj = padded(op, 2)
        res = repro.solve(op, bj, tune="off", fallback="off", maxiter=400)
        out["drop_status"] = np.array(res.status)
        out["drop_x"] = np.asarray(res.x)
    with faults.garble_halo(scale=1.0):
        op = dist_operator(m, mesh, b_r=32)
        b, bj = padded(op, 2)
        try:
            res = repro.solve(op, bj, tune="off", fallback="off",
                              maxiter=400)
            out["garble_status"] = np.array(res.status)
        except Exception as e:
            out["garble_status"] = np.array(f"raise:{type(e).__name__}")
    op = dist_operator(m, mesh, b_r=32)
    x, xj = padded(op, 1)
    out["clean_y"] = np.asarray(jax.jit(op.matvec)(xj))
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def ref_halo(tmp_path_factory):
    """The reference's outcome on the same partition (four virtual host
    devices, one subprocess)."""
    _jax()
    out = tmp_path_factory.mktemp("halo") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF_HALO, str(out)],
                       capture_output=True, text=True, env=env, timeout=560)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out))


_HALO_M = TM.poisson_2d(16, 16)


def _padded(n_pad, seed):
    v = np.zeros(n_pad, np.float32)
    v[:_HALO_M.n_rows] = np.random.default_rng(seed).standard_normal(
        _HALO_M.n_rows)
    return v


def _halo_ranks(fn, device="cpu"):
    """``fn(op, comm)`` on each of four ranks of the reference's
    partition (``dist_operator(m, b_r=32)``, modes and halos default)."""
    return run_ranks(ThreadComm.create(4, device), lambda c: fn(
        dist_operator(_HALO_M, c, b_r=32, device=device), c))


def _y(op, seed=1):
    v = _padded(op.shape[0], seed)
    return op.gather_vector(op.matvec(op.shard_vector(v))).cpu().numpy()


def _close(y, y_ref, tol=TOL):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    err = np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1e-30)
    assert err <= tol, err


def test_drop_halo_is_a_consistent_wrong_operator(ref_halo):
    with faults.drop_halo():
        got = _halo_ranks(lambda op, c: (_y(op), _y(op)))
    y, y2 = got[0]
    assert np.array_equal(y, y2)                      # consistent
    _close(y, ref_halo["drop_y"])                     # the reference's y
    assert np.array_equal(ref_halo["drop_y"], ref_halo["drop_y2"])
    clean = _halo_ranks(lambda op, c: _y(op))[0]
    _close(clean, ref_halo["clean_y"])
    scale = np.abs(clean).max()
    assert np.abs(y - clean).max() > 1e-2 * scale     # and it is wrong


def test_drop_halo_solve_is_wrong_out_of_band(ref_halo):
    """In-band certification is blind to a consistent wrong operator;
    the clean matrix shows a large residual, on both packages."""
    a = sp.csr_matrix((_HALO_M.data, _HALO_M.indices, _HALO_M.indptr),
                      shape=_HALO_M.shape)
    n = _HALO_M.n_rows

    def solve(op, c):
        b = _padded(op.shape[0], 2)
        res = repro_torch.solve(op, op.shard_vector(b), tune="off",
                                fallback="off", maxiter=400)
        return res.status, op.gather_vector(res.x).numpy()

    with faults.drop_halo():
        status, x = _halo_ranks(solve)[0]
    b = _padded(x.shape[0], 2)[:n].astype(np.float64)
    rel = np.linalg.norm(a @ x[:n] - b) / np.linalg.norm(b)
    x_ref = ref_halo["drop_x"][:n].astype(np.float64)
    rel_ref = np.linalg.norm(a @ x_ref - b) / np.linalg.norm(b)
    assert rel > 1e-2 and rel_ref > 1e-2
    assert status == str(ref_halo["drop_status"])


def test_garble_halo_is_not_certified(ref_halo):
    def solve(op, c):
        b = _padded(op.shape[0], 2)
        try:
            return repro_torch.solve(op, op.shard_vector(b), tune="off",
                                     fallback="off", maxiter=400).status
        except Exception as e:
            return f"raise:{type(e).__name__}"

    with faults.garble_halo(scale=1.0):
        got = _halo_ranks(solve)
    assert len(set(got)) == 1                         # every rank alike
    assert got[0] != "converged"
    assert str(ref_halo["garble_status"]) != "converged"
    # restored: the same solve converges
    assert set(_halo_ranks(solve)) == {"converged"}


def test_garble_halo_is_nonlinear_and_patches_built_operators():
    """The patch reaches operators built before the block (the product
    looks the exchange up at every call) and leaves with it; inside,
    A(2x) != 2 A(x)."""
    comms = ThreadComm.create(4, "cpu")
    ops_ = run_ranks(comms, lambda c: dist_operator(_HALO_M, c, b_r=32,
                                                    device="cpu"))
    v = _padded(ops_[0].shape[0], 1)

    def apply(scale):
        return torch.cat(run_ranks(comms, lambda c: ops_[c.rank].matvec(
            ops_[c.rank].shard_vector(scale * v))))

    clean = apply(1.0)
    with faults.garble_halo():
        y1, y2 = apply(1.0), apply(2.0)
    after = apply(1.0)
    assert torch.equal(after, clean)
    assert not torch.equal(y1, clean)
    assert not torch.allclose(y2, 2 * y1, rtol=1e-3, atol=1e-3)


def test_halo_faults_in_every_mode():
    """The fault sits on the received buffers, which every mode reads
    (``pipeline`` through its stages)."""
    from repro_torch.core import dist_spmv as D
    orig = D._post_halo
    plan = D.partition_csr(_HALO_M, 4, b_r=32)
    from repro_torch.core.operator import DistOperator
    v = _padded(plan.n_global_pad, 1)
    ys = {}
    for mode in D.MODES:
        for halo in D.HALOS:
            def body(c):
                op = DistOperator(plan, c, mode=mode, halo=halo,
                                  device="cpu")
                return op.gather_vector(op.matvec(op.shard_vector(v)))
            with faults.drop_halo():
                ys[mode, halo] = run_ranks(ThreadComm.create(4, "cpu"),
                                           body)[0]
    first = next(iter(ys.values()))
    for key, y in ys.items():
        torch.testing.assert_close(y, first, rtol=1e-6, atol=1e-6,
                                   msg=str(key))
    assert D._post_halo is orig                 # the harness restored it


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_kernel_fault_on_card_is_a_typed_serving_error():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    tm, b = _spd()
    with faults.fail_kernel_backend():
        with pytest.raises(faults.InjectedFault):
            repro_torch.solve(tm, b, tune="off")
        eng = SolveEngine(repro_torch.operator(tm, b_r=32), slots=2,
                          maxiter=500, tol=1e-6)
        reqs = [SolveRequest(rid=0, b=b)]
        eng.run(reqs)
    assert reqs[0].status == "error"
    assert "InjectedFault" in reqs[0].diagnostics["error"]


@pytest.mark.cuda
def test_drop_halo_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    with faults.drop_halo():
        card = _halo_ranks(lambda op, c: _y(op), device=None)[0]
        cpu = _halo_ranks(lambda op, c: _y(op))[0]
    _close(card, cpu)
