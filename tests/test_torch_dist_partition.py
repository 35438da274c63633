"""The port's host plan of the distributed layer against the reference's:
``repro_torch.core.dist_spmv.partition_csr`` builds, from the same CSR,
the same halo and reduction index sets, the same static fields and the
same per-rank local, remote and pipeline-stage pJDS streams as
``repro.core.dist_spmv.partition_csr`` -- bit for bit -- over 1-D and
2-D grids, an explicit ``halo_w``, ``sigma``, both index policies,
``rem_chunk_l`` and ``build_stages``.  Each rank's shard holds its own
rows of the stacked streams.  The perf model's link terms,
``predicted_dist_spmv_seconds`` and ``choose_halo`` agree within 1e-12
relative (the same formulas in float64; ``TPU_V5E`` passed to both).
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.core import dist_spmv as TD
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.core import perf_model as TPM

jnp = pytest.importorskip("jax.numpy")
from repro.core import dist_spmv as JD  # noqa: E402
from repro.core import formats as JF  # noqa: E402
from repro.core import perf_model as JPM  # noqa: E402


def _band(n=400, reach=5, seed=0):
    """A banded matrix: with 32-row blocks only neighbours couple."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(n):
        c = np.arange(max(0, r - reach), min(n, r + reach + 1))
        rows += [r] * len(c)
        cols += list(c)
    return TF.csr_from_coo(np.array(rows), np.array(cols),
                           rng.standard_normal(len(rows)), (n, n))


def _blockdiag(seed=0):
    rng = np.random.default_rng(seed)
    return TF.csr_from_dense(np.kron(np.eye(8), rng.standard_normal(
        (32, 32))))


def _nondivisible(seed=0):
    """323 = 17 x 19 rows, random band of reach 40 (the reference's
    2-D test matrix): every grid pads."""
    rng = np.random.default_rng(seed)
    n = 323
    rows, cols = [], []
    for r in range(n):
        cand = np.arange(max(0, r - 40), min(n, r + 40))
        sel = cand[rng.random(len(cand)) < 0.3]
        rows += [r] * len(sel)
        cols += list(sel)
    return TF.csr_from_coo(np.array(rows), np.array(cols),
                           rng.standard_normal(len(rows)), (n, n))


def _tiny():
    """40 rows over 8 ranks of 32: most ranks own only padding."""
    n = 40
    return TF.csr_from_dense(np.diag(np.full(n, 4.0))
                             + np.diag(np.full(n - 1, -1.0), 1)
                             + np.diag(np.full(n - 1, -1.0), -1))


MATS = {"poisson40": lambda: TM.poisson_2d(40, 40), "band": _band,
        "blockdiag": _blockdiag, "nondiv323": _nondivisible,
        "degenerate": _tiny}

_CACHE = {}


def _mats(name):
    if name not in _CACHE:
        tm = MATS[name]()
        _CACHE[name] = (tm, JF.CSRMatrix(tm.indptr, tm.indices, tm.data,
                                         tm.shape))
    return _CACHE[name]


_SHAPES = ([(p, None) for p in (2, 3, 4, 8)]
           + [(4, (2, 2)), (4, (1, 4)), (4, (4, 1)), (8, (2, 4))])
CASES = [pytest.param(name, p, g, {}, id=f"{name}-P{p}-"
                      f"{'1d' if g is None else f'{g[0]}x{g[1]}'}")
         for name in MATS for p, g in _SHAPES]
CASES += [
    pytest.param("poisson40", 4, None, {"halo_w": 2}, id="halo_w-wide"),
    pytest.param("nondiv323", 8, (4, 2), {"halo_w": 2}, id="halo_w-2d"),
    pytest.param("poisson40", 4, None, {"sigma": 64}, id="sigma64"),
    pytest.param("nondiv323", 4, (2, 2), {"sigma": 32}, id="sigma32-2d"),
    pytest.param("poisson40", 4, None, {"index_dtype": "int32"},
                 id="int32"),
    pytest.param("nondiv323", 8, (2, 4), {"index_dtype": np.int32},
                 id="int32-2d"),
    pytest.param("band", 4, None, {"rem_chunk_l": 16, "diag_align": 16},
                 id="rem_chunk_l"),
    pytest.param("poisson40", 4, None, {"build_stages": False},
                 id="no-stages"),
    pytest.param("poisson40", 4, None, {"chunk_l": 16}, id="chunk_l16"),
]

_STREAMS = ("loc", "rem")


def _both(name, p, grid, kw):
    tm, jm = _mats(name)
    kw = dict(b_r=32, grid=grid, **kw)
    return (TD.partition_csr(tm, p, **kw), JD.partition_csr(jm, p, **kw))


def _ref_row_block(stacked_rb, bs):
    """A rank's leading row_block entries, rebuilt from block_start."""
    return np.repeat(np.arange(len(bs) - 1), np.diff(bs))


@pytest.mark.parametrize("name,p,grid,kw", CASES)
def test_plan_is_bit_identical(name, p, grid, kw):
    td, jd = _both(name, p, grid, kw)
    # every index set and static field
    for f in ("inv_perm", "send_idx", "recv_idx", "seg_pos",
              "red_send_pos", "red_recv_idx"):
        np.testing.assert_array_equal(getattr(td, f),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    for f in ("n_dev", "n_loc", "n_blocks", "b_r", "chunk_l", "halo_w",
              "halo_lens", "n_rows", "sigma", "loc_max_chunks",
              "rem_max_chunks", "rem_chunk_l", "grid", "red_w", "red_lens",
              "stage_dists", "stage_max_chunks"):
        assert getattr(td, f) == getattr(jd, f), f
    assert (td.blk_rows, td.n_global_pad, td.ext_len, td.grid_eff,
            td.rem_chunk_l_eff) == (jd.blk_rows, jd.n_global_pad,
                                    jd.ext_len, jd.grid_eff,
                                    jd.rem_chunk_l_eff)
    # the stacked streams, padding included (zeros past each rank's own
    # rows on both sides), with the reference's dtypes
    for pre in _STREAMS + ("stage",):
        for suf in ("val", "col"):
            a, b = getattr(td, f"{pre}_{suf}"), np.asarray(
                getattr(jd, f"{pre}_{suf}"))
            assert a.dtype == b.dtype and a.shape == b.shape, (pre, suf)
            np.testing.assert_array_equal(a, b, err_msg=f"{pre}_{suf}")
    # each rank's block_start gives the reference's row_block on its own
    # rows, and nothing but zeros past them
    for pre in _STREAMS:
        bs_all = getattr(td, f"{pre}_block_start")
        for r in range(p):
            bs = bs_all[r]
            rb = np.asarray(getattr(jd, f"{pre}_row_block"))[r]
            np.testing.assert_array_equal(_ref_row_block(rb, bs),
                                          rb[:bs[-1]])
            assert not np.asarray(getattr(jd, f"{pre}_val"))[r, bs[-1]:].any()
    for r in range(p):
        for s in range(len(td.stage_dists)):
            bs = td.stage_block_start[r, s]
            rb = np.asarray(jd.stage_row_block)[r, s]
            np.testing.assert_array_equal(_ref_row_block(rb, bs),
                                          rb[:bs[-1]])
    # traffic counts
    for halo in ("gathered", "full"):
        for vb, k in ((4, 1), (8, 3)):
            assert td.comm_bytes_per_device(vb, k, halo) == \
                jd.comm_bytes_per_device(vb, k, halo)
        assert td.comm_msgs_per_device(halo) == jd.comm_msgs_per_device(halo)


@pytest.mark.parametrize("name,p,grid", [("nondiv323", 8, (2, 4)),
                                         ("degenerate", 8, None),
                                         ("poisson40", 4, None)])
def test_shard_holds_own_rows(name, p, grid):
    """A rank's operand carries its own diagonals (not the shared
    extent), equal to the leading rows of the stacked streams; its
    index sets are the plan's with the padding cut off."""
    td, _ = _both(name, p, grid, {})
    for r in range(p):
        sh = td.shard(r, "cpu")
        ops_ = (("loc", sh.loc), ("rem", sh.rem))
        ops_ += tuple((f"stage{s}", a) for s, a in enumerate(sh.stages))
        for label, a in ops_:
            if label.startswith("stage"):
                s = int(label[5:])
                val, col = td.stage_val[r, s], td.stage_col[r, s]
                bs = td.stage_block_start[r, s]
            else:
                val = getattr(td, f"{label}_val")[r]
                col = getattr(td, f"{label}_col")[r]
                bs = getattr(td, f"{label}_block_start")[r]
            n = int(bs[-1])
            np.testing.assert_array_equal(a.val.numpy(), val[:n])
            np.testing.assert_array_equal(a.col_idx.numpy(), col[:n])
            np.testing.assert_array_equal(a.block_start.numpy(), bs)
            assert a.max_col == int(col[:n].max(initial=0))
        for k, ln in enumerate(sh.links):
            d = TD.halo_distances(td.halo_w)[k]
            real = td.recv_idx[r, k][td.recv_idx[r, k] != td.ext_len]
            np.testing.assert_array_equal(
                ln.recv_idx.numpy(), real - (d + td.halo_w) * td.n_loc)
            peer = td.shard(ln.send_to, "cpu").links[k]
            assert peer.recv_from == r
            assert peer.recv_idx.numel() == ln.send_idx.numel()
        np.testing.assert_array_equal(sh.seg_pos.numpy(), td.seg_pos[r])


def test_halo_w_too_small_raises_in_both():
    tm, jm = _mats("poisson40")
    for mod, m in ((TD, tm), (JD, jm)):
        with pytest.raises(ValueError, match="too small"):
            mod.partition_csr(m, 8, b_r=32, halo_w=0)


def test_grid_shapes_and_rings():
    for n in (1, 4, 6, 8):
        assert TD.grid_shapes(n) == JD.grid_shapes(n)
        for gc in (g[1] for g in TD.grid_shapes(n)):
            for d in (-2, -1, 1, 2):
                assert TD._col_ring_pairs(n, gc, d) == \
                    JD._col_ring_pairs(n, gc, d)
                assert TD._row_ring_pairs(n, gc, d) == \
                    JD._row_ring_pairs(n, gc, d)
    for w in range(4):
        assert TD.halo_distances(w) == JD.halo_distances(w)
    assert TD.padded_global_size(323, 8, 32) == \
        JD.padded_global_size(323, 8, 32)


def test_split_loc_rem_matches():
    tm, jm = _mats("poisson40")
    n_loc = TD.padded_global_size(tm.n_rows, 4, 32) // 4
    for p in range(4):
        ts = TD._csr_row_slice(tm, p * n_loc, (p + 1) * n_loc, n_loc)
        js = JD._csr_row_slice(jm, p * n_loc, (p + 1) * n_loc, n_loc)
        for a, b in zip(TD._split_loc_rem(ts, p, n_loc, 4, 1),
                        JD._split_loc_rem(js, p, n_loc, 4, 1)):
            for f in ("indptr", "indices", "data"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_transpose_and_diagonal_match():
    tm, jm = _mats("nondiv323")
    a, b = TF.csr_transpose(tm), JF.csr_transpose(jm)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(TF.csr_diagonal(tm), JF.csr_diagonal(jm))


# ------------------------------------------------------------- perf model
_CALS = {
    "none": (None, None),
    "linked": (TPM.Calibration(bw_scale=0.7, overhead_s={"pjds": 3e-6},
                               link_bw_scale=0.4,
                               msg_overhead_s={"gathered": 2e-5,
                                               "full": 5e-6}),
               JPM.Calibration(bw_scale=0.7, overhead_s={"pjds": 3e-6},
                               link_bw_scale=0.4,
                               msg_overhead_s={"gathered": 2e-5,
                                               "full": 5e-6})),
}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("cal", list(_CALS))
@pytest.mark.parametrize("name,p,grid", [("poisson40", 4, None),
                                         ("band", 8, None),
                                         ("nondiv323", 8, (2, 4)),
                                         ("blockdiag", 4, None)])
def test_dist_model_matches(cal, name, p, grid):
    tcal, jcal = _CALS[cal]
    td, jd = _both(name, p, grid, {})
    spec_t, spec_j = TPM.TPU_V5E, JPM.TPU_V5E
    for halo in ("gathered", "full"):
        for mode in ("vector", "naive", "overlap", "pipeline"):
            for k in (1, 4):
                a = TPM.predicted_dist_spmv_seconds(
                    td, halo, mode, k=k, spec=spec_t, calibration=tcal)
                b = JPM.predicted_dist_spmv_seconds(
                    jd, halo, mode, k=k, spec=spec_j, calibration=jcal)
                assert _rel(a, b) <= 1e-12, (halo, mode, k, a, b)
    for mode in ("vector", "overlap"):
        assert TPM.choose_halo(td, mode, spec=spec_t, calibration=tcal) \
            == JPM.choose_halo(jd, mode, spec=spec_j, calibration=jcal)


@pytest.mark.parametrize("cal", list(_CALS))
def test_link_terms_match(cal):
    tcal, jcal = _CALS[cal]
    for elems, msgs, halo, k in ((0, 0, "gathered", 1),
                                 (1234, 6, "gathered", 1),
                                 (98765, 2, "full", 4)):
        a = TPM.t_link_gathered(elems, 50e9, 4, k, msgs=msgs, halo=halo,
                                calibration=tcal)
        b = JPM.t_link_gathered(elems, 50e9, 4, k, msgs=msgs, halo=halo,
                                calibration=jcal)
        assert _rel(a, b) <= 1e-12 or a == b == 0
    for n_nzr in (3.0, 7.1, 30.0):
        for alpha in (1 / n_nzr, 0.5, 1.0):
            for vb in (4, 8):
                assert _rel(TPM.code_balance(alpha, n_nzr, vb),
                            JPM.code_balance(alpha, n_nzr, vb)) <= 1e-12
                assert _rel(TPM.t_mvm(1e6, n_nzr, alpha, 819e9, vb),
                            JPM.t_mvm(1e6, n_nzr, alpha, 819e9, vb)) <= 1e-12
            assert _rel(TPM.n_nzr_upper_for_link_penalty(819e9, 50e9, alpha),
                        JPM.n_nzr_upper_for_link_penalty(819e9, 50e9,
                                                         alpha)) <= 1e-12
            assert _rel(TPM.n_nzr_lower_for_link_penalty(819e9, 50e9, alpha),
                        JPM.n_nzr_lower_for_link_penalty(819e9, 50e9,
                                                         alpha)) <= 1e-12
        assert TPM.alpha_range(n_nzr) == JPM.alpha_range(n_nzr)
    assert _rel(TPM.t_link(1e6, 50e9, 4), JPM.t_link(1e6, 50e9, 4)) <= 1e-12


def test_calibration_link_fields_default_and_check():
    """Existing calibrations keep working: the link fields default to no
    correction, and a non-positive link scale is refused, as in the
    reference."""
    c = TPM.Calibration(bw_scale=1.0)
    assert c.link_bw_scale == 1.0 and dict(c.msg_overhead_s) == {}
    assert [f.name for f in dataclasses.fields(TPM.Calibration)] == \
        [f.name for f in dataclasses.fields(JPM.Calibration)]
    with pytest.raises(ValueError, match="link_bw_scale"):
        TPM.Calibration(bw_scale=1.0, link_bw_scale=0.0)


def test_default_spec_is_h100():
    """The port prices the link at the H100's NVLink rate unless told
    otherwise."""
    td, _ = _both("band", 8, None, {})
    assert TPM.predicted_dist_spmv_seconds(td, calibration=None) == \
        TPM.predicted_dist_spmv_seconds(td, spec=TPM.H100, calibration=None)
    assert TPM.H100.ici_bw == 450e9
