"""The port's autotuner (``repro_torch.tune``) against the reference's
(``repro.tune``): the same candidate sets, prices, cache records and
calibration fit, and -- under the same injected timings -- the same
picks and rows; the tuned ``as_device`` / ``operator`` / ``solve``
paths build exactly the winner; a real measurement runs on the CPU only
when asked (``device="cpu"``), and on a card (``cuda`` marker).

Tolerances: candidate sets, picks, labels and record fields exactly;
prices and ``model_s`` within 1e-12 relative (the same float64 formula
on both sides); the calibration fit within 1e-12 relative; y within
1e-5 * max|y| (f32 accumulation, another summation order).
"""
import json
import zlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import tune as TT
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.core import perf_model as TPM
from repro_torch.kernels import ops as TO


def _jax():
    """The reference modules, imported on use so the card tests of this
    file run where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro import tune as JT
    from repro.core import formats as F
    from repro.core import matrices as M
    from repro.core import perf_model as PM
    return jnp, JT, F, M, PM


def _dense_rect(rows=200, cols=300, density=0.04, seed=5):
    rng = np.random.default_rng(seed)
    return ((rng.random((rows, cols)) < density)
            * rng.standard_normal((rows, cols))).astype(np.float32)


# name -> builder of a reference CSRMatrix (the port gets the same arrays)
_MATS = {
    "samg": lambda M, F: M.samg(scale=2e-4),
    "poisson": lambda M, F: M.poisson_2d(24, 24),
    "power_law": lambda M, F: M.power_law(512),
    "convection": lambda M, F: M.convection_poisson(20, 20, beta=0.4),
    "degenerate": lambda M, F: M.poisson_2d(4, 4),
    "non_square": lambda M, F: F.csr_from_dense(_dense_rect()),
}


def _pair(name):
    jnp, JT, F, M, PM = _jax()
    m = _MATS[name](M, F)
    return m, TF.CSRMatrix(m.indptr, m.indices, m.data, m.shape)


def _policies(jnp):
    """(reference dtype, port dtype, index dtype) per storage policy."""
    return {"native": (None, None, "auto"),
            "bf16": (jnp.bfloat16, torch.bfloat16, "auto"),
            "int16": (None, None, np.int16)}


def _cands(cs):
    return [c.as_dict() for c in cs]


_SPACE_FNS = ("heuristic", "enumerate", "solver", "prune")


@pytest.mark.parametrize("fn", _SPACE_FNS)
@pytest.mark.parametrize("policy", ["native", "bf16", "int16"])
@pytest.mark.parametrize("name", list(_MATS))
def test_search_space_matches_reference(name, policy, fn):
    jnp, JT, F, M, PM = _jax()
    m, tm = _pair(name)
    jd, td, idx = _policies(jnp)[policy]
    v5e = TPM.TPU_V5E
    if fn == "heuristic":
        want = [JT.heuristic_candidate(m, "auto", jd, idx),
                JT.heuristic_candidate(m, "sell", jd, idx)]
        got = [TT.heuristic_candidate(tm, "auto", td, idx, spec=v5e),
               TT.heuristic_candidate(tm, "sell", td, idx, spec=v5e)]
    elif fn == "enumerate":
        want = JT.enumerate_candidates(m, "auto", jd, idx)
        got = TT.enumerate_candidates(tm, "auto", td, idx, spec=v5e)
        assert TT.heuristic_candidate(tm, "auto", td, idx, spec=v5e) in got
    elif fn == "solver":
        for method in ("cg", "bicgstab"):
            w = JT.solver_candidates(m, method=method, dtype=jd,
                                     index_dtype=idx)
            g = TT.solver_candidates(tm, method=method, dtype=td,
                                     index_dtype=idx, spec=v5e)
            assert [(s, c.as_dict()) for s, c in g] == \
                [(s, c.as_dict()) for s, c in w]
        return
    else:
        want = JT.prune_candidates(
            m, JT.enumerate_candidates(m, "auto", jd, idx), top_k=4,
            dtype=jd, index_dtype=idx, spec=PM.TPU_V5E)
        got = TT.prune_candidates(
            tm, TT.enumerate_candidates(tm, "auto", td, idx, spec=v5e),
            top_k=4, dtype=td, index_dtype=idx, spec=v5e)
    assert _cands(got) == _cands(want)


@pytest.mark.parametrize("policy", ["native", "bf16", "int16"])
@pytest.mark.parametrize("name", list(_MATS))
def test_price_candidate_matches_reference(name, policy):
    jnp, JT, F, M, PM = _jax()
    m, tm = _pair(name)
    jd, td, idx = _policies(jnp)[policy]
    cands = JT.enumerate_candidates(m, "auto", jd, idx)
    for cal in (None, "default"):
        for c in cands:
            want = JT.price_candidate(m, c, dtype=jd, index_dtype=idx,
                                      spec=PM.TPU_V5E, calibration=cal)
            got = TT.price_candidate(tm, TT.Candidate(**c.as_dict()),
                                     dtype=td, index_dtype=idx,
                                     spec=TPM.TPU_V5E, calibration=cal)
            assert got == pytest.approx(want, rel=1e-12, abs=0), c.label()


def test_default_spec_is_the_h100():
    _, tm = _pair("samg")
    c = TT.heuristic_candidate(tm)
    assert c.fmt == TO.select_format(tm, diag_align=16)
    assert TT.price_candidate(tm, c) == TT.price_candidate(
        tm, c, spec=TPM.H100)


# ------------------------------------------------------------ timings
def _fake_seconds(c) -> float:
    """A deterministic 'measured' time from the candidate's label alone,
    so both packages see the same timings."""
    return 1e-6 * (1.0 + (zlib.crc32(c.label().encode()) % 997) / 997.0)


def _measure(calls):
    def fn(m, c, **kw):
        calls.append(c.label())
        return _fake_seconds(c)
    return fn


def _solver_measure(calls, fused_s=1e-6, composed_s=2e-6):
    def fn(m, strategy, c, **kw):
        calls.append((strategy, c.label()))
        return (fused_s if strategy == "fused" else composed_s) \
            + 1e-12 * (zlib.crc32(c.label().encode()) % 7)
    return fn


@pytest.fixture
def cache(tmp_path):
    return TT.TuneCache(tmp_path / "tune_cache.json")


@pytest.fixture(autouse=True)
def _no_global_calibration():
    yield
    TPM.clear_calibration()


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "model_s":
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("policy", ["native", "bf16", "int16"])
@pytest.mark.parametrize("name", ["samg", "poisson", "power_law",
                                  "non_square"])
def test_autotune_picks_and_rows_match_reference(name, policy, tmp_path):
    jnp, JT, F, M, PM = _jax()
    m, tm = _pair(name)
    jd, td, idx = _policies(jnp)[policy]
    rj = JT.autotune(m, dtype=jd, index_dtype=idx, spec=PM.TPU_V5E,
                     cache=JT.TuneCache(tmp_path / "j.json"),
                     measure_fn=_measure([]))
    rt = TT.autotune(tm, dtype=td, index_dtype=idx, spec=TPM.TPU_V5E,
                     cache=TT.TuneCache(tmp_path / "t.json"),
                     measure_fn=_measure([]), device="cpu")
    assert rt.best.as_dict() == rj.best.as_dict()
    _rows_equal(rt.rows, rj.rows)
    assert rt.heuristic_row["label"] == rj.heuristic_row["label"]
    fp = rt.key.split("/")[0]
    assert fp == rj.key.split("/")[0] == F.structural_fingerprint(m)
    assert rt.key.split("/")[2:] == rj.key.split("/")[2:]


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
@pytest.mark.parametrize("fused_wins", [True, False])
@pytest.mark.parametrize("name", ["samg", "poisson", "convection"])
def test_tune_solver_picks_and_rows_match_reference(name, fused_wins,
                                                    method, tmp_path):
    jnp, JT, F, M, PM = _jax()
    m, tm = _pair(name)
    times = dict(fused_s=1e-6, composed_s=2e-6) if fused_wins \
        else dict(fused_s=5e-6, composed_s=1e-6)
    sj = JT.tune_solver(m, method=method,
                        cache=JT.TuneCache(tmp_path / "j.json"),
                        measure_fn=_solver_measure([], **times))
    st = TT.tune_solver(tm, method=method,
                        cache=TT.TuneCache(tmp_path / "t.json"),
                        measure_fn=_solver_measure([], **times),
                        spec=TPM.TPU_V5E, device="cpu")
    assert st.strategy == sj.strategy == ("fused" if fused_wins
                                          else "composed")
    assert st.layout.as_dict() == sj.layout.as_dict()
    assert st.rows == sj.rows
    assert st.key.split("/")[2:] == sj.key.split("/")[2:]


# --------------------------------------------------------------- cache
def test_cache_hit_skips_measurement(cache):
    _, tm = _pair("power_law")
    calls = []
    r1 = TT.autotune(tm, cache=cache, measure_fn=_measure(calls),
                     device="cpu")
    assert not r1.cached and calls
    n_first = len(calls)
    r2 = TT.autotune(tm, cache=cache, measure_fn=_measure(calls),
                     device="cpu")
    assert r2.cached and len(calls) == n_first      # nothing re-measured
    assert r2.best == r1.best and r2.key == r1.key and r2.rows == r1.rows
    r3 = TT.autotune(tm, cache=cache, measure_fn=_measure(calls),
                     force=True, device="cpu")
    assert not r3.cached and len(calls) == 2 * n_first   # force re-measures


def test_tune_solver_cached_under_method_key(cache):
    _, tm = _pair("poisson")
    calls = []
    st1 = TT.tune_solver(tm, cache=cache, measure_fn=_solver_measure(calls),
                         device="cpu")
    n_first = len(calls)
    assert not st1.cached and {s for s, _ in calls} == {"fused", "composed"}
    st2 = TT.tune_solver(tm, cache=cache, measure_fn=_solver_measure(calls),
                         device="cpu")
    assert st2.cached and len(calls) == n_first
    assert (st2.strategy, st2.layout, st2.key) == (st1.strategy, st1.layout,
                                                   st1.key)
    st3 = TT.tune_solver(tm, method="bicgstab", cache=cache,
                         measure_fn=_solver_measure(calls), device="cpu")
    assert not st3.cached and st3.key != st1.key
    st4 = TT.tune_solver(tm, cache=cache, force=True,
                         measure_fn=_solver_measure(calls), device="cpu")
    assert not st4.cached and st4.key == st1.key


def test_cache_survives_reload_and_corruption(cache):
    _, tm = _pair("power_law")
    r1 = TT.autotune(tm, cache=cache, measure_fn=_measure([]), device="cpu")
    again = TT.TuneCache(cache.path)
    assert TT.autotune(tm, cache=again, measure_fn=_measure([]),
                       device="cpu").cached
    cache.path.write_text("{ not json")
    assert TT.TuneCache(cache.path).get(r1.key) is None


def test_record_schema_quarantine_round_trip(cache):
    _, tm = _pair("power_law")
    r1 = TT.autotune(tm, cache=cache, measure_fn=_measure([]), device="cpu")
    rec = cache.get(r1.key, require=("best",))
    assert rec is not None and rec["schema"] == TT.RECORD_SCHEMA
    payload = json.loads(cache.path.read_text())
    entries = payload["entries"]
    entries[r1.key] = {**entries[r1.key], "schema": 999}
    entries["k_str"] = "not a dict"
    entries["k_bare"] = {"schema": TT.RECORD_SCHEMA}
    cache.path.write_text(json.dumps(payload))

    fresh = TT.TuneCache(cache.path)
    assert fresh.get(r1.key) is None
    assert "schema" in fresh.quarantined[r1.key]
    assert fresh.get("k_str") is None and "dict" in fresh.quarantined["k_str"]
    assert fresh.get("k_bare", require=("best",)) is None
    assert "missing" in fresh.quarantined["k_bare"]
    assert fresh.get("k_bare") is not None

    calls = []
    r2 = TT.autotune(tm, cache=fresh, measure_fn=_measure(calls),
                     device="cpu")
    assert not r2.cached and calls and r1.key not in fresh.quarantined
    assert fresh.get(r1.key, require=("best",)) is not None


def test_malformed_nested_record_quarantines(cache):
    _, tm = _pair("power_law")
    r1 = TT.autotune(tm, cache=cache, measure_fn=_measure([]), device="cpu")
    payload = json.loads(cache.path.read_text())
    payload["entries"][r1.key]["best"] = 42
    cache.path.write_text(json.dumps(payload))
    fresh = TT.TuneCache(cache.path)
    calls = []
    r2 = TT.autotune(tm, cache=fresh, measure_fn=_measure(calls),
                     device="cpu")
    assert not r2.cached and calls and r1.key not in fresh.quarantined
    assert isinstance(fresh.get(r1.key, require=("best",))["best"], dict)


def test_cache_key_anatomy_matches_reference():
    jnp, JT, F, M, PM = _jax()
    fp = "f" * 40
    pols = [(None, "auto"), (jnp.bfloat16, "auto"), (None, np.int32),
            (None, "int16"), (np.float32, np.int16)]
    tpols = [(None, "auto"), (torch.bfloat16, "auto"), (None, np.int32),
             (None, "int16"), (torch.float32, "int16")]
    for (jd, ji), (td, ti) in zip(pols, tpols):
        assert TT.dtype_policy(td, ti) == JT.dtype_policy(jd, ji)
    assert TT.dtype_policy("bfloat16", "auto") == "bfloat16+auto"
    assert TT.cache_key(fp, "d", "p", "fmt=sell") == \
        JT.cache_key(fp, "d", "p", "fmt=sell")
    keys = {TT.cache_key(fp, "torch-cpu", TT.dtype_policy(None, "auto")),
            TT.cache_key(fp, "torch-cuda:x", TT.dtype_policy(None, "auto")),
            TT.cache_key(fp, "torch-cpu", TT.dtype_policy(torch.bfloat16,
                                                          "auto")),
            TT.cache_key(fp, "torch-cpu", TT.dtype_policy(None, np.int32)),
            TT.cache_key(fp, "torch-cpu", TT.dtype_policy(None, "auto"),
                         "fmt=sell")}
    assert len(keys) == 5
    # the device kind names this package, never the reference's "cpu:..."
    assert TT.device_kind("cpu") == "torch-cpu" != JT.device_kind()


def test_fingerprint_matches_reference():
    jnp, JT, F, M, PM = _jax()
    for name in _MATS:
        m, tm = _pair(name)
        assert TF.structural_fingerprint(tm) == F.structural_fingerprint(m)
    m2 = TF.CSRMatrix(tm.indptr, tm.indices, tm.data * 7.5 + 1.0, tm.shape)
    assert TF.structural_fingerprint(m2) == TF.structural_fingerprint(tm)
    wide = TF.CSRMatrix(tm.indptr, tm.indices, tm.data,
                        (tm.shape[0], tm.shape[1] + 1))
    assert TF.structural_fingerprint(wide) != TF.structural_fingerprint(tm)


def test_a_reference_record_reads_back_into_the_same_candidate(tmp_path):
    jnp, JT, F, M, PM = _jax()
    m, tm = _pair("samg")
    path = tmp_path / "shared.json"
    rj = JT.autotune(m, cache=JT.TuneCache(path), measure_fn=_measure([]))
    sj = JT.tune_solver(m, cache=JT.TuneCache(path),
                        measure_fn=_solver_measure([]))
    tc = TT.TuneCache(path)
    rec = tc.get(rj.key, require=("best",))
    assert TT.Candidate.from_dict(rec["best"]) == \
        TT.Candidate(**rj.best.as_dict())
    srec = tc.get(sj.key, require=("strategy", "layout"))
    assert TT.Candidate.from_dict(srec["layout"]) == \
        TT.Candidate(**sj.layout.as_dict())
    # and the port's own record reads back into the reference's
    rt = TT.autotune(tm, cache=tc, measure_fn=_measure([]), device="cpu",
                     force=True)
    back = JT.TuneCache(path).get(rt.key, require=("best",))
    assert JT.Candidate.from_dict(back["best"]).as_dict() == \
        rt.best.as_dict()


def test_default_cache_follows_its_environment_variable(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "a.json"))
    assert TT.default_cache().path == tmp_path / "a.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "b.json"))
    assert TT.default_cache().path == tmp_path / "b.json"
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert TT.default_cache().path.parts[-2:] == ("repro-torch-spmv",
                                                  "tune_cache.json")


# ---------------------------------------------------------- calibration
def test_calibration_matches_reference():
    jnp, JT, F, M, PM = _jax()
    rng = np.random.default_rng(3)
    rows = [{"fmt": f, "model_s": float(ms),
             "measured_s": float(ms * s + o)}
            for f, ms, s, o in zip(
                ["sell", "pjds", "cmrs", "sell", "csr", "ellpack_r"] * 3,
                rng.uniform(1e-6, 1e-3, 18), rng.uniform(1.5, 3.0, 18),
                rng.uniform(0, 2e-6, 18))]
    cj = JT.fit_calibration(rows, source="x")
    ct = TT.fit_calibration(rows, source="x")
    assert ct.bw_scale == pytest.approx(cj.bw_scale, rel=1e-12, abs=0)
    assert set(ct.overhead_s) == set(cj.overhead_s)
    for f in ct.overhead_s:
        assert ct.overhead_s[f] == pytest.approx(cj.overhead_s[f],
                                                 rel=1e-12, abs=0)
    for cal_t, cal_j in ((None, None), (ct, cj)):
        assert TT.model_error(rows, cal_t) == pytest.approx(
            JT.model_error(rows, cal_j), rel=1e-12, abs=0)
    assert TT.model_error(rows, ct) <= TT.model_error(rows)
    TPM.set_calibration(ct)
    assert TPM.get_calibration() is ct
    with pytest.raises(ValueError):
        TT.fit_calibration([])


# -------------------------------------------------- the tuned builds
def _seed(cache_path, tm, **kw):
    return TT.autotune(tm, cache=TT.TuneCache(cache_path),
                       measure_fn=_measure([]), device="cpu", **kw)


@pytest.mark.parametrize("name", ["samg", "power_law", "poisson"])
def test_tuned_as_device_builds_the_winner(name, cache, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(cache.path))
    jnp, JT, F, M, PM = _jax()
    m, tm = _pair(name)
    best = _seed(cache.path, tm).best
    sd = TO.as_device(tm, tune="auto", device="cpu")
    own = TO.as_device(tm, device="cpu", **best.build_kwargs())
    assert sd.fmt == own.fmt == best.fmt
    for f in ("val", "col_idx", "row_block", "block_start", "warp_len",
              "inv_perm", "rowlen", "row_in_strip", "strip_nnz", "data",
              "indices"):
        if hasattr(own.dev, f):
            assert torch.equal(getattr(sd.dev, f), getattr(own.dev, f)), f
    if best.fmt in ("sell", "pjds"):
        assert (sd.dev.b_r, sd.dev.chunk_l) == (best.b_r, best.chunk_l)
    from repro.core.operator import operator as joperator
    x = np.random.default_rng(1).standard_normal(tm.n_cols).astype(
        np.float32)
    y = (repro_torch.operator(tm, tune="auto", device="cpu")
         @ torch.from_numpy(x)).numpy()
    yj = np.asarray(joperator(m, **best.build_kwargs()) @ jnp.asarray(x))
    scale = max(np.abs(yj).max(), 1e-30)
    assert np.abs(y - yj).max() <= 1e-5 * scale


def test_tune_force_re_measures_and_auto_hits(cache, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(cache.path))
    _, tm = _pair("power_law")
    calls = []
    real = TT.autotune

    def counting(m, **kw):
        calls.append(kw.get("force"))
        return real(m, measure_fn=_measure([]), **kw)

    monkeypatch.setattr(TT, "autotune", counting)
    a1 = TO.as_device(tm, tune="auto", device="cpu")
    a2 = TO.as_device(tm, tune="auto", device="cpu")
    assert a1 is a2 and calls == [False]        # conversion-cache hit
    TO.as_device(tm, tune="force", device="cpu")
    TO.as_device(tm, tune="force", device="cpu")
    assert calls == [False, True, True]         # force never serves a hit
    with pytest.raises(ValueError):
        TO.as_device(tm, tune="always", device="cpu")


def test_format_restriction_is_part_of_the_key(cache):
    _, tm = _pair("samg")
    ra = TT.autotune(tm, cache=cache, measure_fn=_measure([]), device="cpu")
    rs = TT.autotune(tm, format="sell", cache=cache, measure_fn=_measure([]),
                     device="cpu")
    assert not rs.cached and rs.key == ra.key + "/fmt=sell"
    assert rs.best.fmt == "sell"


def test_real_measurement_on_the_cpu_when_asked(cache):
    """A real (not injected) tuning run measures the plain versions on
    the CPU only because the caller named the CPU; tiny matrix."""
    tm = TM.samg(scale=2e-4)
    r = TT.autotune(tm, cache=cache, device="cpu", top_k=2, iters=2)
    assert not r.cached and len(r.rows) >= 2
    assert all(row["measured_s"] > 0 for row in r.rows)
    assert r.heuristic_row is not None
    assert r.key.split("/")[1] == "torch-cpu"
    t = TT.median_seconds(lambda: None, warmup=0, iters=3, device="cpu")
    assert t >= 0.0


def test_solve_tunes_by_default_and_then_hits(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    tm = TM.samg(scale=2e-4)
    b = np.random.default_rng(0).standard_normal(tm.n_rows).astype(
        np.float32)
    r1 = repro_torch.solve(tm, b, device="cpu")
    assert r1.status == "converged"
    assert r1.info["tune"]["cached"] is False
    assert r1.info["tune"]["strategy"] in ("fused", "composed")
    assert r1.info["phase_s"]["tune"] > 0
    r2 = repro_torch.solve(tm, b, device="cpu")
    assert r2.info["tune"]["cached"] is True
    assert r2.info["tune"] == {**r1.info["tune"], "cached": True}
    want = "fused" if r1.info["tune"]["strategy"] == "fused" else "composed"
    assert r2.info["strategy"] == want


def test_solve_follows_the_tuned_decision(tmp_path, monkeypatch):
    """The tuner's strategy and layout decide the solve: composed when
    it measured faster, even on a fused-eligible SELL layout."""
    _jax()
    import repro
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    m, tm = _pair("poisson")
    b = np.random.default_rng(2).standard_normal(tm.n_rows).astype(
        np.float32)
    for fused_wins, strategy in ((True, "fused"), (False, "composed")):
        times = dict(fused_s=1e-6, composed_s=2e-6) if fused_wins \
            else dict(fused_s=5e-6, composed_s=1e-6)
        st = TT.tune_solver(tm, measure_fn=_solver_measure([], **times),
                            device="cpu", force=True)
        res = repro_torch.solve(tm, b, tol=1e-5, device="cpu",
                                fallback="off")
        assert res.info["tune"] == {"cached": True, "strategy": strategy,
                                    "layout": st.layout.label()}
        assert res.info["strategy"] == strategy
        rj = repro.solve(m, b, tol=1e-5, fallback="off", tune="off",
                         **st.layout.build_kwargs())
        assert res.status == rj.status == "converged"
        assert abs(res.iters - int(rj.iters)) <= 2


def test_tune_partition_waits_for_the_distributed_tuner(tmp_path):
    """The distributed tuner (ROADMAP.md, item 1.20) raised until it was
    ported: now it measures on the CPU when asked, and like every entry
    point it needs a device or a card (``tests/test_torch_dist_tune.py``
    holds it to the reference)."""
    _, tm = _pair("poisson")
    tp = TT.tune_partition(tm, 4, b_r=32, device="cpu", iters=2,
                           cache=TT.TuneCache(tmp_path / "c.json"))
    assert isinstance(tp, TT.TunePartition) and not tp.cached
    assert tp.chunk_l in (8, 16, 32) and tp.halo is None


def test_tune_partition_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _pair("poisson")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.tune_partition(tm, 4)


# ------------------------------------------------------------ the card
@pytest.mark.cuda
def test_tuned_operator_on_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels import ref as TR
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    tm = TM.samg(scale=3e-3)
    r = TT.autotune(tm, device="cuda")
    assert r.key.split("/")[1] == \
        f"torch-cuda:{torch.cuda.get_device_name(0)}"
    op = repro_torch.operator(tm, tune="auto")
    assert op.device.type == "cuda" and op.fmt == r.best.fmt
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tm.n_cols).astype(np.float32))
    y_cpu = repro_torch.operator(tm, device="cpu",
                                 **r.best.build_kwargs()) @ x
    TR.reset_calls()
    y = (op @ x.cuda()).cpu()
    assert not any(f.calls for f in TR._COUNTED)      # kernels only
    scale = float(y_cpu.abs().max())
    assert float((y - y_cpu).abs().max()) <= 1e-5 * scale
    assert TT.autotune(tm, device="cuda").cached


@pytest.mark.cuda
def test_tuned_solve_on_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels import ref as TR
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    tm = TM.poisson_2d(64, 64)
    b = np.random.default_rng(0).standard_normal(tm.n_rows).astype(
        np.float32)
    r1 = repro_torch.solve(tm, b, tol=1e-5)
    assert r1.status == "converged" and not r1.info["tune"]["cached"]
    TR.reset_calls()
    r2 = repro_torch.solve(tm, b, tol=1e-5)
    assert not any(f.calls for f in TR._COUNTED)      # kernels only
    assert r2.info["tune"]["cached"] and r2.status == "converged"
    assert r2.x.device.type == "cuda"
