"""The port's solve serving (``repro_torch.serve``) side by side with the
reference's (``repro.serve``): the counterparts of
``tests/test_serve_registry.py``, ``tests/test_serve_scheduler.py`` and
the ``SolveEngine`` tests of ``tests/test_serve_engine.py``, each run on
both packages with the same matrices and right-hand sides under one
fake clock.

Held equal: statuses, shed sets, ``batch_k``, the order in which ticks
finish requests (EDF), metric counters and latency snapshots, registry
keys (structural fingerprints, as strings), LRU eviction order, and the
value maps of every format, array for array.  x within 1e-5 relative
(``max|x - x_ref| <= 1e-5 * max|x_ref|``: f32 block CG on both sides,
sums in another order).  The port's operators run on the CPU here
(``device="cpu"``); card tests (marked ``cuda``) serve on the card.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro_torch
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.serve import (OperatorRegistry, RegistryMismatch,
                               ServeMetrics, SolveEngine, SolveRequest,
                               SolveScheduler)
from repro_torch.tune.cache import TuneCache

X_TOL = 1e-5


def _jax():
    """The reference modules, imported on use so the card tests of this
    file run where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    import repro
    from repro import serve as JS
    from repro.core import formats as F
    from repro.tune.cache import TuneCache as JTuneCache
    return jnp, repro, JS, F, JTuneCache


def _ref_csr(tm):
    _, _, _, F, _ = _jax()
    return F.CSRMatrix(tm.indptr, tm.indices, tm.data, tm.shape)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _x_close(x, x_ref, tol=X_TOL):
    x, x_ref = np.asarray(x, np.float64), np.asarray(x_ref, np.float64)
    assert x.shape == x_ref.shape
    err = np.abs(x - x_ref).max() / max(np.abs(x_ref).max(), 1e-30)
    assert err <= tol, err


def _true_rel(tm, x, b):
    a = sp.csr_matrix((tm.data, tm.indices, tm.indptr), shape=tm.shape)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a @ np.asarray(x, np.float64) - b) \
        / np.linalg.norm(b)


# ----------------------------------------------------------------- registry
def _counting_measure():
    calls = {"n": 0}

    def fake(m, c, **kw):
        calls["n"] += 1
        return 1e-3 + 1.0 / (c.b_r * c.chunk_l)

    return calls, fake


def test_cold_admit_measures_warm_admit_does_not(tmp_path):
    """The zero-warm-up contract on both packages: a structure tuned
    once admits in a new registry over the same cache file with zero
    measurements, under the same key."""
    _, _, JS, _, JTuneCache = _jax()
    tm = TM.poisson_2d(10, 10)
    out = {}
    for side, Reg, Cache, kw in (
            ("ref", JS.OperatorRegistry, JTuneCache, {}),
            ("port", OperatorRegistry, TuneCache, {"device": "cpu"})):
        calls, fake = _counting_measure()
        m = tm if side == "port" else _ref_csr(tm)
        reg = Reg(tune="auto", cache=Cache(tmp_path / f"{side}.json"),
                  measure_fn=fake, **kw)
        e = reg.admit(m)
        assert calls["n"] > 0 and e.tune_info["cached"] is False
        calls["n"] = 0
        reg2 = Reg(tune="auto", cache=Cache(tmp_path / f"{side}.json"),
                   measure_fn=fake, **kw)
        e2 = reg2.admit(m)
        assert calls["n"] == 0 and e2.tune_info["cached"] is True
        assert e2.key == e.key
        out[side] = e.key
    assert isinstance(out["port"], str) and out["port"] == out["ref"]


def test_warm_admit_same_values_is_pure_lookup():
    reg = OperatorRegistry(tune="off", device="cpu")
    e = reg.admit(TM.poisson_2d(8, 8))
    op_before = e.op
    e2 = reg.admit(TM.poisson_2d(8, 8))     # fresh object, equal bytes
    assert e2 is e and e2.op is op_before
    assert e2.hits == 1 and e2.swaps == 0


# value-dependent fields a swap derives again (the walk lengths follow
# which slots hold more than padding); the reference derives none
_WALK = ("warp_len", "strip_nnz")


@pytest.mark.parametrize("fmt", ["csr", "ellpack_r", "pjds", "sell",
                                 "cmrs"])
def test_value_swap_is_zero_reconversion(fmt):
    """New coefficients swap through the value map: the answers follow
    the new values and every structure tensor is the same object as
    before the swap (no conversion ran)."""
    rng = np.random.default_rng(0)
    reg = OperatorRegistry(tune="off", device="cpu")
    tm = TM.poisson_2d(10, 10)
    e = reg.admit(tm, format=fmt)
    inner_before = e.op.dev.dev
    m2 = dataclasses.replace(
        tm, data=(tm.data * rng.uniform(1.5, 2.5)).astype(tm.data.dtype))
    assert TF.structural_fingerprint(m2) == e.key
    e2 = reg.admit(m2)
    assert e2 is e and e.swaps == 1 and e.version == 1
    inner_after = e.op.dev.dev
    shared = 0
    for f in dataclasses.fields(inner_after):
        if f.name in ("val", "data") + _WALK:
            continue
        a, b = getattr(inner_after, f.name), getattr(inner_before, f.name)
        if isinstance(a, torch.Tensor):
            assert a is b, f"structure tensor {f.name} was rebuilt"
            shared += 1
    assert shared >= 1
    x = rng.standard_normal(tm.shape[1]).astype(np.float32)
    y = (e.op @ torch.from_numpy(x)).numpy()
    a2 = sp.csr_matrix((m2.data, m2.indices, m2.indptr), shape=m2.shape)
    np.testing.assert_allclose(y, a2 @ x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["csr", "ellpack_r", "pjds", "sell",
                                 "cmrs"])
def test_value_maps_match_reference(fmt):
    """The stored-slot -> host non-zero map equals the reference's array
    for every format (the port's vectorised pJDS fill included)."""
    _, _, JS, _, _ = _jax()
    tm = TM.samg(scale=2e-4)
    m = _ref_csr(tm)
    ref = JS.OperatorRegistry(tune="off")
    port = OperatorRegistry(tune="off", device="cpu")
    er, ep = ref.admit(m, format=fmt), port.admit(tm, format=fmt)
    assert ep.op.fmt == er.op.fmt == fmt
    assert ep.build_kwargs == er.build_kwargs
    want = ref._value_map(er, m)
    got = port._value_map(ep, tm)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() == tm.nnz


def test_value_swap_solves_to_new_answers():
    jnp, repro, JS, _, _ = _jax()
    rng = np.random.default_rng(1)
    tm = TM.poisson_2d(8, 8)
    b = rng.standard_normal(tm.n_rows).astype(np.float32)
    m2 = dataclasses.replace(tm, data=(tm.data * 3.0).astype(tm.data.dtype))
    reg, jreg = (OperatorRegistry(tune="off", device="cpu"),
                 JS.OperatorRegistry(tune="off"))
    e, je = reg.admit(tm, format="sell"), jreg.admit(_ref_csr(tm),
                                                     format="sell")
    x1 = repro_torch.solve(e.op, b, tune="off").x.numpy()
    reg.admit(m2)
    jreg.admit(_ref_csr(m2))
    x2 = repro_torch.solve(e.op, b, tune="off").x.numpy()
    jx2 = np.asarray(repro.solve(je.op, jnp.asarray(b), tune="off").x)
    np.testing.assert_allclose(x2, x1 / 3.0, rtol=1e-4, atol=1e-5)
    _x_close(x2, jx2)
    assert e.swaps == je.swaps == 1


def test_value_swap_past_the_exact_map_reconverts(monkeypatch):
    """Past ``_MAP_EXACT_NNZ`` the tag stream would lose integers: the
    swap rebuilds the operator instead, as the reference does."""
    from repro_torch.serve import registry as R
    monkeypatch.setattr(R, "_MAP_EXACT_NNZ", 10)
    reg = OperatorRegistry(tune="off", device="cpu")
    tm = TM.poisson_2d(8, 8)
    e = reg.admit(tm, format="sell")
    before = e.op
    m2 = dataclasses.replace(tm, data=tm.data * 2.0)
    reg.admit(m2)
    assert e.op is not before and e.op.fmt == "sell" and e.swaps == 1
    assert e._val_map is None
    x = np.ones(tm.n_rows, np.float32)
    a2 = sp.csr_matrix((m2.data, m2.indices, m2.indptr), shape=m2.shape)
    np.testing.assert_allclose((e.op @ torch.from_numpy(x)).numpy(),
                               a2 @ x, rtol=1e-5, atol=1e-5)


def test_lru_eviction_order_matches_reference():
    _, _, JS, _, _ = _jax()
    mats = {k: TM.poisson_2d(k, k) for k in (6, 7, 8, 9)}
    ref = JS.OperatorRegistry(capacity=2, tune="off")
    port = OperatorRegistry(capacity=2, tune="off", device="cpu")
    keys = {}
    script = [("admit", 6), ("admit", 7), ("get", 6), ("admit", 8),
              ("admit", 7), ("get", 8), ("admit", 9), ("evict", 8),
              ("admit", 6)]
    for act, k in script:
        for side, reg in (("ref", ref), ("port", port)):
            m = mats[k] if side == "port" else _ref_csr(mats[k])
            if act == "admit":
                keys[k] = reg.admit(m).key
            elif act == "get":
                reg.get(keys[k])
            else:
                reg.evict(keys[k])
        assert port.keys() == ref.keys()
        assert port.evictions == ref.evictions
    assert len(port) == 2 and port.evictions == 3


def test_fingerprint_hit_with_mismatched_dtype_policy_rejected():
    jnp, _, JS, _, _ = _jax()
    tm = TM.poisson_2d(8, 8)
    reg = OperatorRegistry(tune="off", device="cpu")
    jreg = JS.OperatorRegistry(tune="off")
    reg.admit(tm)
    jreg.admit(_ref_csr(tm))
    with pytest.raises(RegistryMismatch, match="dtype"):
        reg.admit(TM.poisson_2d(8, 8), dtype=torch.bfloat16)
    with pytest.raises(JS.RegistryMismatch, match="dtype"):
        jreg.admit(_ref_csr(tm), dtype=jnp.bfloat16)
    key = TF.structural_fingerprint(tm)
    assert reg.get(key).policy == jreg.get(key).policy == "native+auto"


def test_fingerprint_hit_with_mismatched_shape_rejected():
    reg = OperatorRegistry(tune="off", device="cpu")
    tm = TM.poisson_2d(8, 8)
    e = reg.admit(tm)
    e.shape = (3, 3)
    with pytest.raises(RegistryMismatch, match="structure"):
        reg.admit(TM.poisson_2d(8, 8))
    e.shape = tuple(tm.shape)
    e.nnz = 1
    with pytest.raises(RegistryMismatch, match="structure"):
        reg.admit(TM.poisson_2d(8, 8))


def test_opaque_entry_cannot_serve_host_admissions():
    reg = OperatorRegistry(tune="off", device="cpu")
    tm = TM.poisson_2d(8, 8)
    reg.admit_operator(repro_torch.operator(tm, b_r=32, device="cpu"),
                       key=TF.structural_fingerprint(tm))
    with pytest.raises(RegistryMismatch):
        reg.admit(tm)


def test_admit_rejects_non_host_inputs():
    reg = OperatorRegistry(tune="off", device="cpu")
    with pytest.raises(TypeError, match="admit_operator"):
        reg.admit(repro_torch.operator(TM.poisson_2d(6, 6), b_r=32,
                                       device="cpu"))
    with pytest.raises(ValueError, match="capacity"):
        OperatorRegistry(capacity=0)
    with pytest.raises(ValueError, match="tune"):
        OperatorRegistry(tune="sometimes", device="cpu").admit(
            TM.poisson_2d(6, 6))


def test_stats_match_reference():
    _, _, JS, _, _ = _jax()
    reg = OperatorRegistry(capacity=2, tune="off", device="cpu")
    jreg = JS.OperatorRegistry(capacity=2, tune="off")
    reg.admit(TM.poisson_2d(6, 6))
    jreg.admit(_ref_csr(TM.poisson_2d(6, 6)))
    assert reg.stats() == jreg.stats()
    assert reg.stats()["entries"][0]["nnz"] == TM.poisson_2d(6, 6).nnz


def test_registry_refuses_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OperatorRegistry(tune="off").admit(TM.poisson_2d(6, 6))


# ---------------------------------------------------------------- scheduler
class _Pair:
    """The same serving scenario on both packages, under one clock."""

    def __init__(self, mats, *, fmt="sell", **kw):
        _, _, JS, _, _ = _jax()
        self.clock = FakeClock()
        kw.setdefault("slots", 4)
        kw.setdefault("maxiter", 1500)
        kw.setdefault("tol", 1e-6)
        self.reg = OperatorRegistry(tune="off", device="cpu")
        self.jreg = JS.OperatorRegistry(tune="off")
        self.entries = [self.reg.admit(tm, format=fmt) for tm in mats]
        self.jentries = [self.jreg.admit(_ref_csr(tm), format=fmt)
                         for tm in mats]
        self.sched = SolveScheduler(self.reg, clock=self.clock, **kw)
        self.jsched = JS.SolveScheduler(self.jreg, clock=self.clock, **kw)
        self.JS = JS

    def reqs(self, bs, **kw):
        return ([SolveRequest(rid=i, b=b.copy(), **kw)
                 for i, b in enumerate(bs)],
                [self.JS.SolveRequest(rid=i, b=b.copy(), **kw)
                 for i, b in enumerate(bs)])

    def submit(self, port, ref, tenant=None):
        for r in port:
            self.sched.submit(r, tenant)
        for r in ref:
            self.jsched.submit(r, tenant)

    def tick(self):
        a, b = self.sched.tick(), self.jsched.tick()
        assert a == b
        return a

    def same(self, port, ref, check_x=True):
        assert [r.status for r in port] == [r.status for r in ref]
        assert [r.done for r in port] == [r.done for r in ref]
        assert dict(self.sched.metrics.counters) == \
            dict(self.jsched.metrics.counters)
        assert self.sched.metrics.snapshot() == \
            self.jsched.metrics.snapshot()
        for p, j in zip(port, ref):
            assert p.diagnostics.get("serve") == j.diagnostics.get("serve")
            assert p.diagnostics.get("reason") == j.diagnostics.get("reason")
            if check_x and p.status == "converged":
                _x_close(p.x, j.x)
                assert abs(p.iters - j.iters) <= 2


def _bs(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


def test_async_admission_then_one_tick_coalesces():
    tm = TM.poisson_2d(10, 10)
    pr = _Pair([tm])
    port, ref = pr.reqs(_bs(tm.n_rows, 3))
    pr.submit(port, ref)
    assert all(r.status == "queued" and not r.done for r in port)
    assert pr.sched.pending() == pr.jsched.pending() == 3
    assert pr.tick() == 3
    pr.same(port, ref)
    assert pr.sched.metrics.counters["batches"] == 1
    for r in port:
        assert r.status == "converged" and r.diagnostics["serve"][
            "batch_k"] == 3
        assert _true_rel(tm, r.x, r.b) < 1e-4
    assert pr.sched.metrics.occupancy.snapshot()["max_s"] == 0.75


def test_admission_rejects_bad_rhs_immediately():
    tm = TM.poisson_2d(10, 10)
    pr = _Pair([tm])
    for b in (np.ones((4, 4), np.float32),
              np.full(tm.n_rows, np.nan, np.float32),
              np.ones(tm.n_rows + 3, np.float32)):
        port, ref = pr.reqs([b])
        pr.submit(port, ref)
        pr.same(port, ref)
        assert port[0].status == "rejected" and port[0].done
    assert pr.sched.pending() == 0
    assert pr.sched.metrics.counters["rejected"] == 3


def test_expired_deadlines_shed_before_dispatch():
    tm = TM.poisson_2d(10, 10)
    pr = _Pair([tm])
    live_p, live_r = pr.reqs(_bs(tm.n_rows, 2))
    doom_p, doom_r = pr.reqs(_bs(tm.n_rows, 1, seed=9), deadline_s=1.0)
    pr.submit(live_p + doom_p, live_r + doom_r)
    pr.clock.advance(2.0)
    pr.tick()
    pr.same(live_p + doom_p, live_r + doom_r)
    assert doom_p[0].status == "shed" and doom_p[0].x is None
    assert doom_p[0].diagnostics["deadline_s"] == 1.0
    assert doom_p[0].diagnostics["serve"]["queue_s"] == 2.0


def test_deadline_order_earliest_first():
    """slots=1: each tick finishes one request, EDF; both packages
    finish the same request at every tick."""
    tm = TM.poisson_2d(10, 10)
    pr = _Pair([tm], slots=1)
    bs = _bs(tm.n_rows, 3)
    port, ref = [], []
    for b, dl in zip(bs, (50.0, None, 10.0)):
        p, r = pr.reqs([b], deadline_s=dl)
        port += p
        ref += r
    pr.submit(port, ref)
    order_p, order_r = [], []
    while pr.sched.pending() or pr.jsched.pending():
        pr.tick()
        order_p.append([i for i, r in enumerate(port) if r.done])
        order_r.append([i for i, r in enumerate(ref) if r.done])
    assert order_p == order_r == [[2], [0, 2], [0, 1, 2]]
    pr.same(port, ref)
    assert pr.sched.metrics.counters["batches"] == 3


def test_tick_order_is_edf_not_fifo():
    tm = TM.poisson_2d(10, 10)
    pr = _Pair([tm], slots=2)
    bs = _bs(tm.n_rows, 3)
    port, ref = [], []
    for b, dl in zip(bs, (None, 20.0, 10.0)):
        p, r = pr.reqs([b], deadline_s=dl)
        port += p
        ref += r
    pr.submit(port, ref)
    pr.tick()
    assert [r.done for r in port] == [r.done for r in ref] == \
        [False, True, True]
    pr.tick()
    pr.same(port, ref)


def test_slot_recycling_after_poisoned_bisection():
    """Six requests, four slots, one poisoned column let past admission:
    the same bisection splits, counters and statuses on both sides, and
    the healthy answers agree."""
    tm = TM.poisson_2d(12, 12)
    pr = _Pair([tm])
    bs = _bs(tm.n_rows, 6)
    bs[1][3] = np.nan
    port, ref = pr.reqs(bs)
    pr.sched.solver_for(pr.entries[0])._admit_fn = lambda req: True
    pr.jsched.solver_for(pr.jentries[0])._admit_fn = lambda req: True
    pr.submit(port, ref)
    assert pr.tick() == 4
    pr.same(port, ref)
    assert port[1].status in ("non_finite", "breakdown", "diverged")
    assert pr.sched.metrics.counters["group_splits"] >= 1
    assert pr.sched.pending() == 2
    assert pr.tick() == 2
    pr.same(port, ref)
    assert pr.sched.metrics.counters["converged"] == 5
    assert pr.sched.metrics.counters["failed"] == 1
    for r in port:
        if r.rid != 1:
            assert _true_rel(tm, r.x, r.b) < 1e-4


def test_latency_accounting_under_fake_clock():
    tm = TM.poisson_2d(10, 10)
    pr = _Pair([tm])
    port, ref = pr.reqs(_bs(tm.n_rows, 1))
    pr.submit(port, ref)
    pr.clock.advance(3.0)
    pr.tick()
    pr.same(port, ref)
    s = port[0].diagnostics["serve"]
    assert s["queue_s"] == 3.0 and s["solve_s"] == 0.0
    assert s["total_s"] == 3.0
    snap = pr.sched.metrics.snapshot()
    assert snap["queue_s"]["p50_s"] == 3.0
    assert snap["total_s"]["count"] == 1


def test_multi_tenant_routing_and_ambiguity():
    t1, t2 = TM.poisson_2d(8, 8), TM.poisson_2d(9, 9)
    pr = _Pair([t1, t2])
    assert [e.key for e in pr.entries] == [e.key for e in pr.jentries]
    with pytest.raises(ValueError, match="ambiguous"):
        pr.sched.submit(SolveRequest(rid=0, b=np.ones(64, np.float32)))
    with pytest.raises(KeyError):
        pr.sched.submit(SolveRequest(rid=0, b=np.ones(64, np.float32),
                                     tenant="no-such-tenant"))
    port, ref = [], []
    for i, (tm, e) in enumerate(zip((t1, t2), pr.entries)):
        p, r = pr.reqs(_bs(tm.n_rows, 1, seed=i), tenant=e.key)
        port += p
        ref += r
    pr.submit(port, ref)
    pr.sched.run_until_drained()
    pr.jsched.run_until_drained()
    pr.same(port, ref)
    assert [r.diagnostics["serve"]["tenant"] for r in port] == \
        [e.key for e in pr.entries]
    assert pr.sched.metrics.counters["batches"] == 2


def test_shared_metrics_object_injectable():
    mx = ServeMetrics()
    reg = OperatorRegistry(tune="off", device="cpu")
    entry = reg.admit(TM.poisson_2d(8, 8))
    sched = SolveScheduler(reg, slots=2, maxiter=1500, tol=1e-6,
                           clock=FakeClock(), metrics=mx)
    for i, b in enumerate(_bs(entry.shape[0], 2)):
        sched.submit(SolveRequest(rid=i, b=b))
    sched.run_until_drained()
    assert mx.counters["converged"] == 2
    assert mx.occupancy.snapshot()["max_s"] == 1.0


def test_scheduler_with_jacobi_passes_a_closure():
    """With Jacobi scaling the group solve takes the bare closure
    ``s * op.matmat(s * X)``: the same statuses and answers as the
    reference's."""
    tm = TM.poisson_2d(10, 10)
    pr = _Pair([tm], jacobi_precond=True)
    port, ref = pr.reqs(_bs(tm.n_rows, 3))
    pr.submit(port, ref)
    pr.tick()
    pr.same(port, ref)
    assert all(r.status == "converged" for r in port)


# ------------------------------------------------------------ SolveEngine
def test_solve_engine_batches_rhs_against_operator():
    jnp, repro, JS, _, _ = _jax()
    from repro.core.operator import operator as joperator
    tm = TM.poisson_2d(16, 16)
    bs = _bs(tm.n_rows, 5, seed=3)
    eng = SolveEngine(repro_torch.operator(tm, "sell", b_r=32, device="cpu"),
                      slots=4, maxiter=1500, tol=1e-7)
    jeng = JS.SolveEngine(joperator(_ref_csr(tm), "sell", b_r=32), slots=4,
                          maxiter=1500, tol=1e-7)
    port = [SolveRequest(rid=i, b=b.copy()) for i, b in enumerate(bs)]
    ref = [JS.SolveRequest(rid=i, b=b.copy()) for i, b in enumerate(bs)]
    eng.run(port)
    jeng.run(ref)
    assert [r.status for r in port] == [r.status for r in ref]
    for p, j in zip(port, ref):
        assert p.done and p.residual < 1e-6
        assert _true_rel(tm, p.x, p.b) < 1e-4
        _x_close(p.x, j.x)


def test_solve_engine_jacobi_scaling():
    """On a badly scaled SPD matrix the Jacobi option needs over 5 x
    fewer iterations, as in the reference, with the same answers."""
    jnp, repro, JS, F, _ = _jax()
    from repro.core.operator import operator as joperator
    rng = np.random.default_rng(0)
    tm = TM.poisson_2d(16, 16)
    s = (10.0 ** rng.uniform(-1.5, 1.5, tm.n_rows)).astype(np.float32)
    d = sp.csr_matrix((tm.data, tm.indices, tm.indptr),
                      shape=tm.shape).toarray()
    a = (s[:, None] * d * s[None, :]).astype(np.float32)
    ta = TF.csr_from_dense(a)
    b = rng.standard_normal(tm.n_rows).astype(np.float32)
    op = repro_torch.operator(ta, b_r=32, device="cpu")
    plain = SolveEngine(op, slots=2, maxiter=20000, tol=1e-6)
    scaled = SolveEngine(op, slots=2, maxiter=20000, tol=1e-6,
                         jacobi_precond=True)
    r0, r1 = SolveRequest(rid=0, b=b), SolveRequest(rid=1, b=b)
    plain.run([r0])
    scaled.run([r1])
    assert r1.iters * 5 < r0.iters
    err = np.linalg.norm(a.astype(np.float64) @ r1.x - b) / np.linalg.norm(b)
    assert err < 1e-3
    jscaled = JS.SolveEngine(joperator(F.csr_from_dense(a), b_r=32),
                             slots=2, maxiter=20000, tol=1e-6,
                             jacobi_precond=True)
    j1 = JS.SolveRequest(rid=1, b=b)
    jscaled.run([j1])
    assert r1.status == j1.status == "converged"
    assert abs(r1.iters - j1.iters) <= 2


def test_solve_engine_is_a_shim_over_the_scheduler():
    tm = TM.poisson_2d(10, 10)
    eng = SolveEngine(repro_torch.operator(tm, b_r=32, device="cpu"),
                      slots=4, maxiter=1500, tol=1e-6)
    assert isinstance(eng.scheduler, SolveScheduler)
    assert len(eng.registry) == 1
    reqs = [SolveRequest(rid=i, b=b) for i, b in enumerate(
        _bs(tm.n_rows, 5))]
    eng.run(reqs)
    assert all(r.status == "converged" for r in reqs)
    assert eng.metrics.counters["batches"] == 2          # 4 + 1
    assert eng.metrics.counters["converged"] == 5
    assert reqs[0].diagnostics["serve"]["batch_k"] == 4
    assert reqs[4].diagnostics["serve"]["batch_k"] == 1


def test_serve_exports_the_reference_names():
    _, _, JS, _, _ = _jax()
    import repro_torch.serve as S
    assert sorted(S.__all__) == sorted(JS.__all__)


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_serving_on_card(tmp_path):
    """Two tenants on the card, tuned admission on a fresh cache, the
    kernels only: every request converges, the answers match the same
    scheduler on the CPU, a value swap on the card follows the new
    values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels import ref as TR
    mats = [TM.poisson_2d(48, 48), TM.samg(scale=3e-3)]
    out = {}
    for dev in ("cuda", "cpu"):
        reg = OperatorRegistry(tune="auto" if dev == "cuda" else "off",
                               cache=TuneCache(tmp_path / "c.json"),
                               device=dev)
        es = [reg.admit(tm) for tm in mats]
        sched = SolveScheduler(reg, slots=4, maxiter=3000, tol=1e-6,
                               clock=FakeClock())
        reqs = []
        for e, tm in zip(es, mats):
            for i, b in enumerate(_bs(tm.n_rows, 3, seed=len(reqs))):
                reqs.append(SolveRequest(rid=len(reqs), b=b, tenant=e.key))
        if dev == "cuda":
            TR.reset_calls()
        for r in reqs:
            sched.submit(r)
        sched.run_until_drained()
        if dev == "cuda":
            assert not any(f.calls for f in TR._COUNTED)   # kernels only
            m2 = dataclasses.replace(mats[0], data=mats[0].data * 2.0)
            reg.admit(m2)
            assert es[0].swaps == 1
        out[dev] = reqs
    for g, c in zip(out["cuda"], out["cpu"]):
        assert g.status == c.status == "converged"
        tm = mats[0] if g.rid < 3 else mats[1]
        assert _true_rel(tm, g.x, g.b) < 1e-4
