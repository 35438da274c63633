"""The port's distributed tuner (``repro_torch.tune.tune_partition``,
``dist_operator(tune=...)``) and link calibration against the
reference's (``repro.tune``).

* The host half equals the reference's exactly: the remote columns by
  ring distance, the candidate lists, and the slices, local / remote
  splits, windowed row sorts, ``halo_w`` and straggler ranks of the
  chunk sweep, on ``samg(0.002)`` and a 2-D Poisson at 2, 4 and 8 ranks.
* Under injected timings (one fake timing function monkeypatched into
  both packages) the picks and rows are the reference's; the port's
  ranks (``ThreadComm``) all return that pick.
* The link fit and ``link_model_error`` equal the reference's within
  1e-12 relative with ``spec=TPU_V5E`` (the reference's synthetic rows,
  and the rows of a sweep).
* The cache: a miss measures, a hit measures nothing; four gloo
  processes sharing one cache file agree on one pick, and a second run
  of them measures nothing on any rank.
* ``dist_operator(tune="auto")`` gives y equal to the untuned
  partition's within 1e-5 * max|y| (f32 sums in another tile order).

Card tests (marked ``cuda``) tune four ``ThreadComm`` ranks on the card.
"""
import importlib
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

from repro_torch import tune as TT
from repro_torch.core import dist_spmv as TD
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.core import perf_model as TPM
from repro_torch.core.dist_comm import ThreadComm, run_ranks
from repro_torch.core.operator import dist_operator
from repro_torch.tune import measure as TME

# the module (``repro_torch.tune.autotune`` is also the function's name)
TA = importlib.import_module("repro_torch.tune.autotune")

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5          # max|y - y_ref| <= TOL * max|y_ref|
REL = 1e-12         # the link fit: the same float64 formula on both sides
B_R = 32


def _jax():
    """The reference modules, imported on use so the card tests of this
    file run where JAX is not installed."""
    pytest.importorskip("jax")
    from repro import tune as JT
    from repro.core import dist_spmv as JD
    from repro.core import formats as F
    from repro.core import matrices as M
    from repro.core import perf_model as PM
    from repro.tune import measure as JME
    JA = importlib.import_module("repro.tune.autotune")
    return JT, JD, F, M, PM, JA, JME


_MATS = {"samg": lambda: TM.samg(scale=0.002),
         "poisson": lambda: TM.poisson_2d(40, 40)}


def _pair(name):
    _, _, F, _, _, _, _ = _jax()
    tm = _MATS[name]()
    return F.CSRMatrix(tm.indptr, tm.indices, tm.data, tm.shape), tm


def _csr_equal(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


# ---------------------------------------------------------------- host half
@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("name", list(_MATS))
def test_straggler_operands_match_reference(name, n_dev):
    """``csr_remote_columns_by_distance`` and the chunk sweep's slices,
    splits, sorts, ``halo_w`` and straggler ranks are the reference's
    (``repro/tune/autotune.py:319-336``, recomputed here with the
    reference's functions)."""
    _, JD, F, _, _, _, _ = _jax()
    m, tm = _pair(name)
    got = TA._straggler_operands(tm, n_dev, B_R, None)
    n_pad = JD.padded_global_size(m.n_rows, n_dev, B_R)
    n_loc = n_pad // n_dev
    slices = [JD._csr_row_slice(m, p * n_loc, (p + 1) * n_loc, n_loc)
              for p in range(n_dev)]
    needs = [F.csr_remote_columns_by_distance(sl, p, n_loc, n_dev)
             for p, sl in enumerate(slices)]
    halo_w = min(max((max((abs(d) for d in nd), default=0) for nd in needs),
                     default=0), n_dev // 2)
    splits = [JD._split_loc_rem(sl, p, n_loc, n_dev, halo_w)
              for p, sl in enumerate(slices)]
    sig = max(min(8 * B_R, n_loc), 1)
    perms = [F.windowed_sort_perm(loc.row_lengths() + rem.row_lengths(), sig)
             for loc, rem in splits]
    assert got["halo_w"] == halo_w and got["sigma"] == sig
    assert got["p_loc"] == int(np.argmax([lo.nnz for lo, _ in splits]))
    assert got["p_rem"] == int(np.argmax([r.nnz for _, r in splits]))
    for p in range(n_dev):
        _csr_equal(got["slices"][p], slices[p])
        _csr_equal(got["splits"][p][0], splits[p][0])
        _csr_equal(got["splits"][p][1], splits[p][1])
        np.testing.assert_array_equal(got["perms"][p], perms[p])
        # the port's own copy of the helper, slice by slice
        tn = TF.csr_remote_columns_by_distance(got["slices"][p], p, n_loc,
                                               n_dev)
        assert sorted(tn) == sorted(needs[p])
        for d in tn:
            assert tn[d].dtype == needs[p][d].dtype == np.int32
            np.testing.assert_array_equal(tn[d], needs[p][d])


def test_remote_columns_of_a_small_slice():
    """The reference's hand-checked case (``tests/test_dist_spmm.py``):
    4 ranks of 4 rows, rank 1 referencing both neighbours and one rank
    two steps away."""
    _, _, F, _, _, _, _ = _jax()
    dense = np.zeros((16, 16), np.float32)
    dense[4, [0, 3, 5, 9, 12]] = 1.0
    dense[6, [2, 8, 11]] = 1.0
    tm = TF.csr_from_dense(dense)
    sl = TD._csr_row_slice(tm, 4, 8, 4)
    got = TF.csr_remote_columns_by_distance(sl, 1, 4, 4)
    m = F.CSRMatrix(tm.indptr, tm.indices, tm.data, tm.shape)
    from repro.core import dist_spmv as JD
    want = F.csr_remote_columns_by_distance(
        JD._csr_row_slice(m, 4, 8, 4), 1, 4, 4)
    assert sorted(got) == sorted(want) == [-1, 1, 2]
    for d in got:
        np.testing.assert_array_equal(got[d], want[d])


@pytest.mark.parametrize("kw", [
    {}, {"halos": ("full",)}, {"modes": ("naive", "vector", "pipeline")},
    {"grids": [(2, 4), None, (8, 1)]}, {"halo_w_options": (None, 1, 2)}],
    ids=["default", "full", "modes", "grids", "halo_w"])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 6, 8, 16])
def test_dist_candidates_match_reference(n_dev, kw):
    JT = _jax()[0]
    got = TT.dist_candidates(n_dev, **kw)
    assert got == JT.dist_candidates(n_dev, **kw)
    if not kw and n_dev == 4:
        # 3 grids x 5 (halo, mode) pairs
        assert len(got) == 15
        assert {c["grid"] for c in got} == {None, (1, 4), (2, 2)}


# ------------------------------------------------- picks under fake timings
def _fake_operand(sub, perm, b_r, diag_align, chunk_l, index_dtype,
                  warmup, iters, **kw):
    """A timing that depends on the operand and the tile height only."""
    return 1e-4 + 1e-9 * sub.nnz * (1.0 + 0.37 * ((chunk_l * 7 + sub.nnz)
                                                 % 5)) / chunk_l


def _fake_dist(m, where, cand, **kw):
    """The reference's row for a candidate, timed by a formula of the
    candidate (the wire statistics from the reference's own partition
    would need a mesh; a formula keeps both sides' rows equal)."""
    g = cand.get("grid")
    code = sum(ord(ch) for ch in f"{g}{cand['halo']}{cand['mode']}")
    msgs = 2 + code % 3
    byts = 400 * (1 + code % 7)
    return dict(grid=g, halo=cand["halo"], mode=cand["mode"],
                halo_w=1, red_w=0, msgs=msgs, bytes=byts,
                measured_s=1e-4 + 2e-6 * msgs + 1e-9 * byts
                + 1e-7 * (code % 11))


def _fake_port_dist(m, comm, cand, **kw):
    r = _fake_dist(m, comm, cand)
    # the straggler decides: each rank reports another time, rank 1
    # the slowest, so the table's max is rank 1's
    r["measured_s"] *= 1.0 + 0.01 * ((comm.rank + 3) % 4 == 0)
    return r


def _picks(tp):
    return (tp.chunk_l, tp.rem_chunk_l, tp.halo, tp.mode, tp.grid)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("name", list(_MATS))
def test_picks_under_injected_timings_match_reference(name, n_dev,
                                                      monkeypatch, tmp_path):
    JT, _, _, _, _, JA, JME = _jax()
    m, tm = _pair(name)
    monkeypatch.setattr(JA, "_measure_operand", _fake_operand)
    monkeypatch.setattr(JME, "measure_dist_candidate", _fake_dist)
    monkeypatch.setattr(TA, "_measure_operand", _fake_operand)
    want = JT.tune_partition(m, n_dev, b_r=B_R, mesh=object(),
                             cache=JT.TuneCache(tmp_path / "ref.json"))
    want_chunks = JT.tune_partition(m, n_dev, b_r=B_R,
                                    cache=JT.TuneCache(tmp_path / "r2.json"))

    # one rank per thread; the straggler's (rank 1's, 1 % slower) times
    monkeypatch.setattr(TME, "measure_dist_candidate", _fake_port_dist)
    cache = TT.TuneCache(tmp_path / "port.json")
    comms = ThreadComm.create(n_dev, "cpu")
    got = run_ranks(comms, lambda c: TT.tune_partition(
        tm, n_dev, b_r=B_R, comm=c, cache=cache, device="cpu"))
    assert len({_picks(g) for g in got}) == 1
    assert _picks(got[0]) == _picks(want)
    assert [(r["operand"], r["device"], r["chunk_l"], r["measured_s"])
            for r in got[0].rows if r["operand"] != "comm"] == \
        [(r["operand"], r["device"], r["chunk_l"], r["measured_s"])
         for r in want.rows if r["operand"] != "comm"]
    keys = ("grid", "halo", "mode", "halo_w", "red_w", "msgs", "bytes",
            "group")
    comm_got = [r for r in got[0].rows if r["operand"] == "comm"]
    comm_want = [r for r in want.rows if r["operand"] == "comm"]
    assert [{k: r[k] for k in keys} for r in comm_got] == \
        [{k: r[k] for k in keys} for r in comm_want]
    for g, w in zip(comm_got, comm_want):
        # rank 1, the slowest, decides
        assert g["measured_s"] == pytest.approx(w["measured_s"] * 1.01,
                                                rel=1e-12)
        assert g["measured_s"] == max(g["rank_s"]) == g["rank_s"][1]
    # without a communicator only the chunk sweep runs
    alone = TT.tune_partition(tm, n_dev, b_r=B_R, device="cpu",
                              cache=TT.TuneCache(tmp_path / "p2.json"))
    assert _picks(alone) == _picks(want_chunks)
    assert alone.halo is None and alone.grid is None


# ------------------------------------------------------------ link fit
def _synthetic_rows(PM):
    """The reference's ``test_link_calibration_recovers_synthetic``
    rows: known per-message costs and link scale 0.5, 1 % noise."""
    rng = np.random.default_rng(11)
    base = {"g1": 120e-6, "g2": 210e-6}
    cost = {"gathered": 25e-6, "full": 5e-6}
    inv_bw = 1.0 / (PM.TPU_V5E.ici_bw * 0.5)
    rows = []
    for group in base:
        for halo in cost:
            for msgs, byts in ((2, 4e5), (4, 1.6e6), (6, 6.4e6)):
                t = base[group] + msgs * cost[halo] + byts * inv_bw
                rows.append(dict(group=group, halo=halo, msgs=msgs,
                                 bytes=byts,
                                 measured_s=t * rng.uniform(0.99, 1.01)))
    return rows


def _cal_close(a, b):
    assert a.link_bw_scale == pytest.approx(b.link_bw_scale, rel=REL)
    assert sorted(a.msg_overhead_s) == sorted(b.msg_overhead_s)
    for h in a.msg_overhead_s:
        assert a.msg_overhead_s[h] == pytest.approx(b.msg_overhead_s[h],
                                                    rel=REL)
    assert a.bw_scale == pytest.approx(b.bw_scale, rel=REL)
    assert a.source == b.source


def _port_cal(c):
    return TPM.Calibration(bw_scale=c.bw_scale, overhead_s=dict(c.overhead_s),
                           source=c.source, link_bw_scale=c.link_bw_scale,
                           msg_overhead_s=dict(c.msg_overhead_s))


def test_link_calibration_matches_reference():
    """The reference's synthetic recovery test on both packages: the
    same fit and errors within 1e-12 with the TPU v5e spec; the port's
    default (the H100) rescales only the link term."""
    JT, _, _, _, PM, _, _ = _jax()
    rows = _synthetic_rows(PM)
    want = JT.fit_link_calibration(rows, source="synthetic")
    got = TT.fit_link_calibration(rows, spec=TPM.TPU_V5E,
                                  source="synthetic")
    _cal_close(got, want)
    assert got.msg_overhead_s["gathered"] == pytest.approx(25e-6, rel=0.5)
    assert got.link_bw_scale == pytest.approx(0.5, rel=0.5)
    e0 = TT.link_model_error(rows, spec=TPM.TPU_V5E)
    e1 = TT.link_model_error(rows, got, spec=TPM.TPU_V5E)
    assert e0 == pytest.approx(JT.link_model_error(rows), rel=REL)
    assert e1 == pytest.approx(JT.link_model_error(rows, want), rel=REL)
    assert e1 < e0 and e1 < 0.05
    h100 = TT.fit_link_calibration(rows, source="synthetic")
    assert h100.link_bw_scale == pytest.approx(
        got.link_bw_scale * TPM.TPU_V5E.ici_bw / TPM.H100.ici_bw, rel=1e-9)
    assert TT.link_model_error(rows, h100) == pytest.approx(e1, rel=1e-9)


def test_link_calibration_rejects_bad_rows():
    with pytest.raises(ValueError):
        TT.fit_link_calibration([])
    with pytest.raises(ValueError):
        TT.fit_link_calibration([dict(group="g", halo="full", msgs=2,
                                      bytes=100, measured_s=0.0)])
    with pytest.raises(ValueError):
        TT.link_model_error([])


@pytest.mark.parametrize("name", list(_MATS))
def test_link_fit_of_sweep_rows_matches_reference(name, monkeypatch,
                                                  tmp_path):
    """The sweep's rows feed the fit on both sides alike, with a base
    calibration carried through."""
    JT, _, _, _, PM, JA, JME = _jax()
    m, _ = _pair(name)
    monkeypatch.setattr(JA, "_measure_operand", _fake_operand)
    monkeypatch.setattr(JME, "measure_dist_candidate", _fake_dist)
    rows = [r for r in JT.tune_partition(
        m, 4, b_r=B_R, mesh=object(),
        cache=JT.TuneCache(tmp_path / "r.json")).rows
        if r["operand"] == "comm"]
    base = PM.Calibration(bw_scale=0.7, overhead_s={"sell": 1e-6},
                          source="kernels")
    want = JT.fit_link_calibration(rows, base=base)
    got = TT.fit_link_calibration(rows, spec=TPM.TPU_V5E,
                                  base=_port_cal(base))
    _cal_close(got, want)
    assert TT.link_model_error(rows, got, spec=TPM.TPU_V5E) == \
        pytest.approx(JT.link_model_error(rows, want), rel=REL)


# ------------------------------------------------------------ the cache
def _counting(monkeypatch):
    calls = {"operand": 0, "dist": 0}
    op0, d0 = TA._measure_operand, TME.measure_dist_candidate

    def operand(*a, **kw):
        calls["operand"] += 1
        return op0(*a, **kw)

    def dist(*a, **kw):
        calls["dist"] += 1
        return d0(*a, **kw)

    monkeypatch.setattr(TA, "_measure_operand", operand)
    monkeypatch.setattr(TME, "measure_dist_candidate", dist)
    return calls


def test_cache_hit_and_miss(monkeypatch, tmp_path):
    """A miss measures 2 x 3 operands, a hit nothing (the reference's
    ``test_tune_partition_independent_and_cached``); another geometry,
    ``force`` and a malformed record each measure again."""
    calls = _counting(monkeypatch)
    tm = TM.poisson_2d(24, 24)
    cache = TT.TuneCache(tmp_path / "c.json")
    kw = dict(b_r=B_R, cache=cache, iters=2, device="cpu")
    tp = TT.tune_partition(tm, 4, **kw)
    assert not tp.cached and calls["operand"] == 6
    assert tp.chunk_l in (8, 16, 32) and tp.rem_chunk_l in (8, 16, 32)
    assert {r["operand"] for r in tp.rows} == {"loc", "rem"}
    assert set(tp.phase_s) == {"slices", "splits", "perms", "build",
                               "measure"}
    tp2 = TT.tune_partition(tm, 4, **kw)
    assert tp2.cached and calls["operand"] == 6
    assert _picks(tp2) == _picks(tp) and tp2.rows == json.loads(
        json.dumps(tp.rows)) and tp2.phase_s == {}
    assert tp2.key.split("/")[1] == "torch-cpu"
    assert not TT.tune_partition(tm, 2, **kw).cached
    assert not TT.tune_partition(tm, 4, force=True, **kw).cached
    assert calls["operand"] == 18
    rec = cache.get(tp.key)
    cache.put(tp.key, {**rec, "chunk_l": "eight"})
    tp3 = TT.tune_partition(tm, 4, **kw)       # quarantined: a miss
    assert not tp3.cached and calls["operand"] == 24
    assert cache.get(tp.key)["chunk_l"] == tp3.chunk_l


def test_threads_agree_and_hit_on_the_second_call(monkeypatch, tmp_path):
    """Four ``ThreadComm`` ranks with real (CPU) timings: one pick for
    all, rank 0 alone measures the chunk sweep, every rank times every
    candidate, and a second call hits on every rank."""
    calls = _counting(monkeypatch)
    tm = _MATS["samg"]()
    cache = TT.TuneCache(tmp_path / "c.json")
    comms = ThreadComm.create(4, "cpu")

    def body(c):
        return TT.tune_partition(tm, 4, b_r=B_R, comm=c, cache=cache,
                                 iters=2, device="cpu")

    first = run_ranks(comms, body)
    assert len({_picks(t) for t in first}) == 1
    assert calls == {"operand": 6, "dist": 4 * 15}
    assert all(not t.cached for t in first)
    assert first[0].grid in (None, (1, 4), (2, 2))
    again = run_ranks(comms, body)
    assert all(t.cached for t in again)
    assert {_picks(t) for t in again} == {_picks(first[0])}
    assert calls == {"operand": 6, "dist": 60}


def test_tune_partition_checks_the_rank_count():
    c = ThreadComm.create(2, "cpu")[0]
    with pytest.raises(ValueError, match="ranks"):
        TT.tune_partition(_MATS["poisson"](), 4, comm=c, device="cpu")


def test_dist_tune_is_no_longer_a_roadmap_item():
    from repro_torch._todo import ROADMAP_ITEMS
    assert "dist_tune" not in ROADMAP_ITEMS
    assert not any("1.20" in v for v in ROADMAP_ITEMS.values())


# ------------------------------------------- the shared sweep partition
@pytest.mark.parametrize("grid", [None, (2, 2), (1, 4)],
                         ids=["1d", "2x2", "1x4"])
def test_shared_partition_equals_per_candidate_build(grid):
    """The sweep builds one partition per (grid, halo_w) with stages and
    times every halo and mode on it; the reference builds each
    candidate's own (stages only for ``"pipeline"``).  Everything
    ``measure_dist_candidate`` reads and reports is the same, and every
    non-pipeline product is the same bit for bit."""
    tm = _MATS["samg"]()
    shared = TD.partition_csr(tm, 4, b_r=B_R, chunk_l=16, rem_chunk_l=8,
                              grid=grid, build_stages=True)
    own = TD.partition_csr(tm, 4, b_r=B_R, chunk_l=16, rem_chunk_l=8,
                           grid=grid, build_stages=False)
    for f in ("loc_val", "loc_col", "loc_block_start", "rem_val", "rem_col",
              "rem_block_start", "inv_perm", "send_idx", "recv_idx",
              "seg_pos", "red_send_pos", "red_recv_idx"):
        np.testing.assert_array_equal(getattr(shared, f), getattr(own, f))
    for f in ("halo_w", "red_w", "halo_lens", "red_lens", "n_loc",
              "chunk_l", "rem_chunk_l", "grid", "n_global_pad"):
        assert getattr(shared, f) == getattr(own, f), f
    for halo in TD.HALOS:
        assert shared.comm_msgs_per_device(halo) == \
            own.comm_msgs_per_device(halo)
        assert shared.comm_bytes_per_device(4, halo=halo) == \
            own.comm_bytes_per_device(4, halo=halo)
    x = np.random.default_rng(1).standard_normal(
        shared.n_global_pad).astype(np.float32)
    from repro_torch.core.operator import DistOperator

    def y_of(plan, mode, halo):
        def body(c):
            op = DistOperator(plan, c, mode=mode, halo=halo, device="cpu")
            return op.gather_vector(op.matvec(op.shard_vector(x)))
        return run_ranks(ThreadComm.create(4, "cpu"), body)[0]

    for mode in ("vector", "naive", "overlap"):
        for halo in TD.HALOS:
            assert torch.equal(y_of(shared, mode, halo),
                               y_of(own, mode, halo)), (mode, halo)


# ------------------------------------------------ dist_operator(tune=)
def _truth(tm, x):
    a = sp.csr_matrix((tm.data, tm.indices, tm.indptr), shape=tm.shape)
    return a @ x.astype(np.float64)


def _close(y, truth, tol=TOL):
    y = np.asarray(y, np.float64)[: truth.shape[0]]
    err = np.abs(y - truth).max() / max(np.abs(truth).max(), 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("tune,auto", [("auto", True), ("auto", False),
                                       ("force", True)])
def test_dist_operator_tuned_matches_untuned(tune, auto, monkeypatch,
                                             tmp_path):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    tm = _MATS["samg"]()
    x = np.random.default_rng(3).standard_normal(tm.n_rows).astype(
        np.float32)
    y_ = np.random.default_rng(4).standard_normal(tm.n_rows).astype(
        np.float32)
    kw = dict(grid="auto", halo="auto", mode="auto") if auto else {}

    def body(c):
        op = dist_operator(tm, c, tune=tune, b_r=B_R, device="cpu", **kw)
        plain = dist_operator(tm, c, b_r=B_R, device="cpu",
                              grid=op.dist.grid, halo=op.halo,
                              mode=op.mode)
        out = [op.gather_vector(o.matvec(op.shard_vector(x)))
               for o in (op, plain)]
        out.append(op.gather_vector(op.rmatvec(op.shard_vector(y_))))
        return op, out

    res = run_ranks(ThreadComm.create(4, "cpu"), body)
    ops_ = [r[0] for r in res]
    op = ops_[0]
    assert op.dist.chunk_l in (8, 16, 32)
    assert op.dist.rem_chunk_l_eff in (8, 16, 32)
    assert op.t_dist.chunk_l in (8, 16, 32)
    assert len({(o.mode, o.halo, o.dist.grid) for o in ops_}) == 1
    assert all(o.dist is op.dist for o in ops_)      # one shared plan
    if auto:
        assert op.mode in ("vector", "overlap", "pipeline")
        assert op.dist.grid in (None, (1, 4), (2, 2))
    else:
        assert (op.mode, op.halo, op.dist.grid) == ("overlap", "gathered",
                                                    None)
    truth = _truth(tm, x)
    y_tuned, y_plain, z = res[0][1]
    _close(y_tuned.numpy(), truth)
    _close(y_tuned.numpy(), y_plain.numpy().astype(np.float64)[:tm.n_rows])
    a = sp.csr_matrix((tm.data, tm.indices, tm.indptr), shape=tm.shape)
    _close(z.numpy(), a.T @ y_.astype(np.float64))


def test_tuned_values_enter_the_shared_plan(monkeypatch, tmp_path):
    """Two tunings that pick different tile heights give two plans, each
    built with its own: the tuned values are part of the plan's key."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    tm = _MATS["poisson"]()
    comms = ThreadComm.create(2, "cpu")
    plans = []
    for best in (16, 32):
        monkeypatch.setattr(TA, "_measure_operand",
                            lambda *a, best=best, **kw:
                            1e-3 / (1.0 + (a[4] == best)))
        plans.append(run_ranks(comms, lambda c: dist_operator(
            tm, c, tune="force", b_r=B_R, transpose=None,
            device="cpu").dist))
    assert plans[0][0] is plans[0][1] and plans[1][0] is plans[1][1]
    assert (plans[0][0].chunk_l, plans[1][0].chunk_l) == (16, 32)
    assert plans[0][0].rem_chunk_l_eff == 16
    assert plans[1][0].rem_chunk_l_eff == 32


# -------------------------------------------- four gloo processes
_GLOO_TUNE = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, tmp, run = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{tmp}/store{run}", world),
        rank=rank, world_size=world)
    import repro_torch
    from repro_torch.core import matrices as TM
    import importlib
    from repro_torch.tune import measure as TME
    TA = importlib.import_module("repro_torch.tune.autotune")
    calls = {"operand": 0, "dist": 0}
    op0, d0 = TA._measure_operand, TME.measure_dist_candidate
    def operand(*a, **kw):
        calls["operand"] += 1
        return op0(*a, **kw)
    def dcand(*a, **kw):
        calls["dist"] += 1
        return d0(*a, **kw)
    TA._measure_operand, TME.measure_dist_candidate = operand, dcand
    m = TM.samg(scale=0.002)
    op = repro_torch.dist_operator(
        m, repro_torch.GroupComm(), tune="auto", grid="auto", halo="auto",
        mode="auto", b_r=32, device="cpu")
    x = np.random.default_rng(3).standard_normal(m.n_rows).astype(
        np.float32)
    y = op.gather_vector(op.matvec(op.shard_vector(x)))
    dist.destroy_process_group()
    json.dump({"pick": [op.mode, op.halo, op.dist.grid, op.dist.chunk_l,
                        op.dist.rem_chunk_l_eff, op.t_dist.chunk_l,
                        op.t_dist.rem_chunk_l_eff],
               "calls": calls, "y": y.numpy().tolist()},
              open(f"{tmp}/run{run}_rank{rank}.json", "w"))
""")


def _env(cache):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env["REPRO_TORCH_TUNE_CACHE"] = str(cache)
    env.pop("XLA_FLAGS", None)
    return env


def _gloo_run(tmp, run):
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_TUNE, str(r), "4", str(tmp), str(run)],
        env=_env(tmp / "cache.json"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads((tmp / f"run{run}_rank{r}.json").read_text())
            for r in range(4)]


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Two runs of four gloo processes on one cache file."""
    tmp = tmp_path_factory.mktemp("gloo_tune")
    return _gloo_run(tmp, 0), _gloo_run(tmp, 1)


def test_gloo_ranks_agree_on_one_pick(gloo_runs):
    first, _ = gloo_runs
    picks = {json.dumps(r["pick"]) for r in first}
    assert len(picks) == 1
    # rank 0 measured the chunk sweeps (A and A^T), every rank the comm
    # sweep of A (15 candidates)
    assert first[0]["calls"] == {"operand": 12, "dist": 15}
    assert all(r["calls"] == {"operand": 0, "dist": 15} for r in first[1:])
    tm = _MATS["samg"]()
    x = np.random.default_rng(3).standard_normal(tm.n_rows).astype(
        np.float32)
    _close(np.asarray(first[0]["y"]), _truth(tm, x))
    for r in first[1:]:
        assert r["y"] == first[0]["y"]


def test_gloo_second_run_measures_nothing(gloo_runs):
    first, second = gloo_runs
    assert all(r["calls"] == {"operand": 0, "dist": 0} for r in second)
    assert [r["pick"] for r in second] == [first[0]["pick"]] * 4
    assert [r["y"] for r in second] == [first[0]["y"]] * 4


def test_dist_scaling_reports_the_sweep_and_link_fit():
    """``dist_scaling.py`` rehearsed as four gloo processes: one pick on
    every rank (or the script fails), every candidate's row, and the
    link fit with its error before and after."""
    r = subprocess.run([sys.executable, str(ROOT / "dist_scaling.py"),
                        "--backend", "gloo", "--scale", "0.001",
                        "--timeout", "240"], env=_env(ROOT / "unused.json"),
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()]
    tune = next(ln for ln in lines if ln.get("phase") == "dist_scaling:tune")
    comm = [row for row in tune["rows"] if row["operand"] == "comm"]
    assert len(comm) == 15 and all(len(row["rank_s"]) == 4 for row in comm)
    assert tune["picks"]["halo"] in ("gathered", "full")
    fit = tune["link_fit"]
    assert fit["link_model_error_after"] <= fit["link_model_error_before"]
    assert set(tune["halo_picks"]) == {"1-D", "2x2"}


# ------------------------------------------------------------ the card
@pytest.mark.cuda
def test_threads_tune_on_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels import ref as TR
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    tm = TM.samg(scale=0.01)
    x = np.random.default_rng(3).standard_normal(tm.n_rows).astype(
        np.float32)
    TR.reset_calls()
    out = run_ranks(ThreadComm.create(4), lambda c: (lambda op: (
        (op.mode, op.halo, op.dist.grid, op.dist.chunk_l,
         op.dist.rem_chunk_l_eff),
        op.gather_vector(op.matvec(op.shard_vector(x))).cpu()))(
        dist_operator(tm, c, tune="auto", grid="auto", halo="auto",
                      mode="auto")))
    assert not any(f.calls for f in TR._COUNTED)      # kernels only
    assert len({o[0] for o in out}) == 1
    _close(out[0][1].numpy(), _truth(tm, x))
    again = run_ranks(ThreadComm.create(4),
                      lambda c: TT.tune_partition(tm, 4, comm=c))
    assert all(t.cached for t in again)
    assert again[0].key.split("/")[1].startswith("torch-cuda:")
    assert {(t.mode, t.halo, t.grid) for t in again} == \
        {(o[0][0], o[0][1], o[0][2]) for o in out}
