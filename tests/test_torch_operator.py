"""The port's operator protocol against the reference's: ``operator(m,
device="cpu") @ x`` (and ``@ X`` for a block of right-hand sides)
equals ``repro``'s ``operator(m) @ x`` for every format, ``"auto"``
included; ``convert.py`` carries a reference ``as_device`` container
across to the same y; ``diagonal()`` equals the reference's bit for
bit, and the dispatch's ``x_tiles="auto"`` rule picks the reference's
format and fused eligibility past 8,388,608 columns; the entry points
refuse to run on the CPU unasked, and the options that used to raise
``NotImplementedError`` now run.

Tolerance: y within 1e-5 * max|y| -- the same stored values, f32
accumulation on both sides, a different summation order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.core import perf_model as TPM
from repro_torch.core.operator import DeviceOperator
from repro_torch.kernels import ops as TO


def _jax():
    """The reference modules, imported on use so the card test of this
    file runs where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import formats as F
    from repro.core import matrices as M
    from repro.core.operator import operator as joperator
    from repro.kernels import ops as jops
    return jnp, F, M, joperator, jops


def _close(y, y_ref, tol=1e-5):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    scale = max(np.abs(y_ref).max(), 1e-30)
    assert y.shape == y_ref.shape
    assert np.abs(y - y_ref).max() <= tol * scale


def _zipf_dense(n=160, seed=0):
    rng = np.random.default_rng(seed)
    rl = np.clip(rng.zipf(1.8, size=n), 1, n // 4)
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, rng.integers(0, n, size=rl[i])] = rng.standard_normal(rl[i])
    return a


_MATS = {
    "samg": lambda: TM.samg(scale=1e-4),
    "poisson": lambda: TM.poisson_2d(24, 24),
    "zipf160": lambda: TF.csr_from_dense(_zipf_dense()),
}


def _jax_matrix(F, tm):
    return F.CSRMatrix(tm.indptr, tm.indices, tm.data, tm.shape)


@pytest.mark.parametrize("policy", [
    pytest.param({}, id="f32+auto"),
    pytest.param({"dtype": "bfloat16", "index_dtype": "int16"},
                 id="bf16+int16"),
    pytest.param({"index_dtype": "int32", "b_r": 64, "chunk_l": 8},
                 id="f32+int32-b64")])
@pytest.mark.parametrize("fmt", ["pjds", "sell", "csr", "ellpack_r", "cmrs"])
@pytest.mark.parametrize("name", sorted(_MATS))
def test_operator_matches_reference(name, fmt, policy):
    jnp, F, _, joperator, _ = _jax()
    tm = _MATS[name]()
    x = np.random.default_rng(7).standard_normal(tm.n_cols).astype(
        np.float32)
    jpol = dict(policy)
    if jpol.get("dtype") == "bfloat16":
        jpol["dtype"] = jnp.bfloat16
    y_j = np.asarray(joperator(_jax_matrix(F, tm), fmt, **jpol)
                     @ jnp.asarray(x))
    op = repro_torch.operator(tm, fmt, device="cpu", **policy)
    assert isinstance(op, DeviceOperator) and op.fmt == fmt
    y_t = op @ torch.from_numpy(x)
    assert y_t.dtype == torch.float32
    _close(y_t.numpy(), y_j)
    _close((op @ x).numpy(), y_j)           # numpy x: host width rule


_K = {k: np.random.default_rng(20 + k).standard_normal((700, k)).astype(
    np.float32) for k in (1, 3, 8)}


@pytest.mark.parametrize("k", sorted(_K))
@pytest.mark.parametrize("fmt", ["pjds", "sell", "csr", "ellpack_r", "cmrs",
                                 "auto"])
@pytest.mark.parametrize("name", sorted(_MATS))
def test_operator_matmat_matches_reference(name, fmt, k):
    jnp, F, _, joperator, _ = _jax()
    tm = _MATS[name]()
    x = _K[k][: tm.n_cols]
    jop = joperator(_jax_matrix(F, tm), fmt)
    op = repro_torch.operator(tm, fmt, device="cpu")
    assert op.fmt == jop.dev.fmt
    y_j = np.asarray(jop @ jnp.asarray(x))
    y_t = op @ torch.from_numpy(x)
    assert tuple(y_t.shape) == (tm.n_rows, k)
    _close(y_t.numpy(), y_j)
    _close(op.matvec(torch.from_numpy(x)).numpy(), y_j)   # 2-D -> matmat


def _ref_spec(spec):
    # the reference priced with the same numbers as the port's spec
    from repro.core import perf_model as PM
    return PM.TPUSpec(**dataclasses.asdict(spec))


_AUTO_MATS = {
    "samg_0.01": lambda: TM.samg(scale=0.01),       # cmrs under the H100
    "poisson_64": lambda: TM.poisson_2d(64, 64),    # ellpack_r
    **_MATS,
}


@pytest.mark.parametrize("spec", [TPM.H100, TPM.TPU_V5E],
                         ids=["h100", "tpu_v5e"])
@pytest.mark.parametrize("mat", sorted(_AUTO_MATS))
def test_auto_format_and_product_match_reference(mat, spec):
    # operator(m) @ x with no format: the same pick as the reference's
    # select_format under the same spec, and the same y and Y
    jnp, F, _, joperator, jops = _jax()
    tm = _AUTO_MATS[mat]()
    jm = _jax_matrix(F, tm)
    pick = TO.select_format(tm, diag_align=16, spec=spec)
    assert pick == jops.select_format(jm, diag_align=16,
                                      spec=_ref_spec(spec))
    op = repro_torch.operator(tm, pick, device="cpu")
    jop = joperator(jm, pick)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(tm.n_cols).astype(np.float32)
    xk = rng.standard_normal((tm.n_cols, 3)).astype(np.float32)
    _close((op @ torch.from_numpy(x)).numpy(), np.asarray(jop @ jnp.asarray(x)))
    _close((op @ torch.from_numpy(xk)).numpy(),
           np.asarray(jop @ jnp.asarray(xk)))
    if spec is TPM.H100:                     # the port's default spec
        assert repro_torch.operator(tm, device="cpu").fmt == pick


def test_auto_runs_on_samg_and_poisson_without_raising():
    # the paper's two operators: CMRS and ELLPACK-R under the H100 spec
    for tm, fmt in ((TM.samg(scale=0.01), "cmrs"),
                    (TM.poisson_2d(512, 512), "ellpack_r")):
        op = repro_torch.operator(tm, device="cpu")
        assert op.fmt == fmt
        x = np.random.default_rng(6).standard_normal(tm.n_cols).astype(
            np.float32)
        y = (op @ torch.from_numpy(x)).numpy()
        a64 = _dense_matvec_f64(tm, x)
        _close(y, a64)


def _dense_matvec_f64(tm, x):
    rows = np.repeat(np.arange(tm.n_rows), np.diff(tm.indptr))
    y = np.zeros(tm.n_rows)
    np.add.at(y, rows, tm.data * x[tm.indices].astype(np.float64))
    return y


def test_dense_input_and_conversion_cache():
    a = _zipf_dense()
    op1 = repro_torch.operator(a, "sell", device="cpu")
    op2 = repro_torch.operator(a.copy(), "sell", device="cpu")
    assert op1.dev is op2.dev                # content-hashed, converted once
    _close((op1 @ _zipf_dense()[0]).numpy(),
           a.astype(np.float64) @ _zipf_dense()[0], tol=1e-4)


def test_explicit_x_tiles_changes_nothing():
    tm = _MATS["samg"]()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tm.n_cols).astype(np.float32))
    for fmt in ("pjds", "sell"):
        y1 = repro_torch.operator(tm, fmt, x_tiles=1, device="cpu") @ x
        y4 = repro_torch.operator(tm, fmt, x_tiles=4, device="cpu") @ x
        assert torch.equal(y1, y4)
    assert TO.as_device(tm, "sell", device="cpu").x_tiles == 1   # "auto"


@pytest.mark.parametrize("fmt", ["pjds", "sell", "csr", "ellpack_r", "cmrs"])
@pytest.mark.parametrize("bf16", [False, True])
def test_convert_carries_jax_containers_across(fmt, bf16):
    jnp, F, M, _, jops = _jax()
    m = M.samg(scale=2e-4, seed=3)
    sd = jops.as_device(m, fmt, b_r=32, chunk_l=8,
                        dtype=jnp.bfloat16 if bf16 else None)
    inner = sd.dev
    names = [f for f in ("val", "col_idx", "row_block", "inv_perm", "data",
                         "indices", "row_ids", "rowlen", "row_in_strip",
                         "strip_map") if hasattr(inner, f)]
    arrays = {f: np.asarray(getattr(inner, f)) for f in names}
    statics = {f: getattr(inner, f) for f in ("n_blocks", "b_r", "chunk_l",
                                              "sigma", "n_rows", "n_strips")
               if hasattr(inner, f)}
    port = convert.sparse_device(
        fmt, sd.shape, arrays, statics,
        inv_perm=None if sd.inv_perm is None else np.asarray(sd.inv_perm),
        x_tiles=sd.x_tiles, device="cpu")
    x = np.random.default_rng(2).standard_normal(m.n_cols).astype(np.float32)
    y_j = np.asarray(sd.matvec(jnp.asarray(x), backend="ref"))
    _close(port.matvec(torch.from_numpy(x)).numpy(), y_j)
    if fmt != "csr":
        # the port's own build of the same matrix stores the same bits
        own = TO.as_device(TF.CSRMatrix(m.indptr, m.indices, m.data,
                                        m.shape), fmt, b_r=32, chunk_l=8,
                           dtype=torch.bfloat16 if bf16 else None,
                           device="cpu").dev
        fields = {"ellpack_r": ("val", "col_idx", "rowlen"),
                  "cmrs": ("val", "col_idx", "row_in_strip", "strip_map",
                           "strip_start")}.get(
            fmt, ("val", "col_idx", "row_block", "block_start"))
        for f in fields:
            assert torch.equal(getattr(own, f), getattr(port.dev, f)), f


def test_entry_points_refuse_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = _MATS["samg"]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.operator(tm, "sell")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TO.as_device(tm, "pjds")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.solve(tm, np.ones(tm.n_rows), tune="off",
                          fallback="off")
    # the defaults tune: no device and no card raises before measuring
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.solve(tm, np.ones(tm.n_rows))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.operator(tm, tune="auto")


@pytest.mark.parametrize("call,item", [
    (lambda tm: repro_torch.operator(tm, "sell", reorder="rcm",
                                     device="cpu"), "RCM"),
    (lambda tm: repro_torch.operator(tm, "sell", transpose="device",
                                     device="cpu"), "transpose"),
    (lambda tm: repro_torch.operator(tm, "sell", device="cpu").T, "rmatvec"),
    (lambda tm: repro_torch.operator(tm, "pjds", device="cpu").rmatvec(
        torch.zeros(tm.n_rows)), "rmatvec"),
    (lambda tm: repro_torch.operator(tm, "sell", device="cpu")
     @ torch.zeros(tm.n_cols, requires_grad=True), "autograd"),
    (lambda tm: repro_torch.operator(tm, "cmrs", device="cpu")
     @ torch.zeros(tm.n_cols, 2, requires_grad=True), "autograd"),
])
def test_unported_options_raise_naming_their_roadmap_item(call, item):
    """These options raised ``NotImplementedError`` naming their ROADMAP
    item until the item was ported: now each runs on the CPU, and no
    option that still raises names it (``tests/test_torch_transpose.py``,
    ``test_torch_grad.py`` and ``test_torch_reorder.py`` hold them to the
    reference)."""
    from repro_torch._todo import ROADMAP_ITEMS
    out = call(_MATS["samg"]())
    assert out is not None
    assert not any(item.lower() in v.lower() for v in ROADMAP_ITEMS.values())


def test_bad_inputs_raise():
    tm = _MATS["samg"]()
    op = repro_torch.operator(tm, "sell", device="cpu")
    with pytest.raises(ValueError, match="entries"):
        op @ torch.zeros(tm.n_cols - 1)
    with pytest.raises(ValueError):
        repro_torch.operator(tm, "bogus", device="cpu")
    with pytest.raises(ValueError):
        TO.as_device(TO.as_device(tm, "sell", device="cpu"), "pjds")
    with pytest.raises(TypeError):
        repro_torch.operator([[1.0]], device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["pjds", "sell", "ellpack_r", "cmrs", "auto"])
def test_operator_on_card_matches_cpu(fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels import ref as TR
    tm = TM.samg(scale=3e-3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(tm.n_cols).astype(np.float32))
    xk = torch.from_numpy(rng.standard_normal((tm.n_cols, 5)).astype(
        np.float32))
    op_cpu = repro_torch.operator(tm, fmt, device="cpu")
    y_cpu, yk_cpu = op_cpu @ x, op_cpu @ xk
    op = repro_torch.operator(tm, fmt)
    assert op.device.type == "cuda" and op.fmt == op_cpu.fmt
    TR.reset_calls()
    _close((op @ x.cuda()).cpu().numpy(), y_cpu.numpy())
    _close((op @ xk.cuda()).cpu().numpy(), yk_cpu.numpy())
    assert not any(f.calls for f in TR._COUNTED)      # kernels only


# ---- diagonal() (the Jacobi preconditioner) -----------------------------
_DIAG_MATS = dict(_MATS, convection=lambda: TM.convection_poisson(
    17, 19, beta=0.4))


@pytest.mark.parametrize("fmt", ["pjds", "sell", "csr", "ellpack_r", "cmrs"])
@pytest.mark.parametrize("name", sorted(_DIAG_MATS))
def test_diagonal_matches_reference(name, fmt):
    # the same stored values, one diagonal entry per row (or none): the
    # port's diagonal equals the reference's bit for bit
    _, F, _, joperator, _ = _jax()
    tm = _DIAG_MATS[name]()
    d_ref = np.asarray(joperator(_jax_matrix(F, tm), format=fmt).diagonal())
    op = repro_torch.operator(tm, fmt, device="cpu")
    d = op.diagonal()
    assert d.shape == (tm.n_rows,) and d.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), d_ref)
    assert op.diagonal() is d                       # cached on the operator


def test_diagonal_sums_duplicate_entries_in_storage_order():
    # a row may store its diagonal more than once (CSR duplicates); the
    # port sums them without float atomics, in storage order, as the
    # reference's segment_sum does
    indptr = np.array([0, 3, 4, 6])
    indices = np.array([0, 0, 2, 1, 2, 2])
    data = np.array([1.5, 2.25, 7.0, 3.0, -1.0, 1e-8], np.float32)
    tm = TF.CSRMatrix(indptr, indices, data, (3, 3))
    d = repro_torch.operator(tm, "csr", device="cpu").diagonal()
    want = np.array([np.float32(1.5) + np.float32(2.25), 3.0,
                     np.float32(-1.0) + np.float32(1e-8)], np.float32)
    np.testing.assert_array_equal(d.numpy(), want)


def test_diagonal_needs_a_square_operator():
    tm = TF.csr_from_dense(np.ones((4, 6), np.float32))
    with pytest.raises(ValueError, match="square"):
        repro_torch.operator(tm, "csr", device="cpu").diagonal()
    with pytest.raises(NotImplementedError):
        repro_torch.core.operator.SparseOperator().diagonal()


def test_convection_poisson_matches_reference():
    _, F, M, _, _ = _jax()
    for nx, ny, beta in ((17, 19, 0.4), (8, 8, 0.5), (512, 4, -0.3)):
        tm, jm = TM.convection_poisson(nx, ny, beta=beta), \
            M.convection_poisson(nx, ny, beta=beta)
        for f in ("indptr", "indices", "data"):
            a, b = getattr(tm, f), np.asarray(getattr(jm, f))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert tm.shape == jm.shape


# ---- x_tiles="auto": the reference's rule --------------------------------
def test_choose_x_tiles_matches_reference():
    _, _, _, _, jops = _jax()
    for n, item in ((8_388_608, 4), (8_388_609, 4), (4_194_304, 8),
                    (4_194_305, 8), (1, 4), (33_554_433, 4)):
        assert TO.choose_x_tiles(n, item) == jops.choose_x_tiles(n, item)
    assert TO.choose_x_tiles(8_388_608, 4) == 1
    assert TO.choose_x_tiles(8_388_609, 4) == 2


def _wide(n_cols, seed=0):
    """512 rows of 3 entries over ``n_cols`` columns, float32 values: a
    short, wide matrix that is cheap to convert at any width."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(512), 3)
    cols = rng.integers(0, n_cols, size=rows.size)
    cols[:3] = n_cols - 1                         # the widest column used
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return TF.csr_from_coo(rows, cols, vals, (512, n_cols))


@pytest.mark.parametrize("n_cols,tiles", [(8_388_608, 1), (8_388_609, 2)])
def test_x_tiles_auto_picks_the_reference_format(n_cols, tiles):
    # past 8,388,608 float32 columns the reference tiles x in two, which
    # drops ELLPACK-R from the pick; the port now decides the same
    _, F, _, _, jops = _jax()
    tm = _wide(n_cols)
    assert tm.data.dtype == np.float32
    sd = TO.as_device(tm, device="cpu")
    sd_ref = jops.as_device(_jax_matrix(F, tm))
    assert sd.x_tiles == sd_ref.x_tiles == tiles
    assert sd.fmt == sd_ref.fmt
    assert (sd.fmt == "ellpack_r") == (tiles == 1)


@pytest.mark.parametrize("x_tiles", [1, 2])
def test_fused_eligibility_follows_x_tiles_as_in_the_reference(x_tiles):
    jnp, F, _, joperator, _ = _jax()
    from repro import api as japi
    from repro_torch import api as tapi
    tm = TM.poisson_2d(16, 16)
    b = np.ones(tm.n_rows, np.float32)
    op = repro_torch.operator(tm, "sell", x_tiles=x_tiles, device="cpu")
    op_ref = joperator(_jax_matrix(F, tm), format="sell", x_tiles=x_tiles)
    want = japi._fused_eligible(op_ref, "cg", None, jnp.asarray(b))
    assert want == (x_tiles == 1)
    for method in ("cg", "bicgstab"):
        assert tapi._fused_eligible(op, method, None, torch.from_numpy(b)) \
            == japi._fused_eligible(op_ref, method, None, jnp.asarray(b))
    res = repro_torch.solve(op, b, tune="off", fallback="off", tol=1e-5)
    assert res.info["strategy"] == ("fused" if want else "composed")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["pjds", "sell", "csr", "ellpack_r", "cmrs"])
def test_diagonal_on_card_is_exact_and_repeats(fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import scipy.sparse as sp
    tm = TM.samg(scale=3e-3)
    want = sp.csr_matrix((tm.data, tm.indices, tm.indptr),
                         shape=tm.shape).diagonal().astype(np.float32)
    d1 = repro_torch.operator(tm, fmt).diagonal()
    TO.clear_device_cache()
    d2 = repro_torch.operator(tm, fmt).diagonal()
    assert d1.device.type == "cuda"
    assert torch.equal(d1, d2)
    np.testing.assert_array_equal(d1.cpu().numpy(), want)
