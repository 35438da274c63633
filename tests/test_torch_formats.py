"""The port's host copies (formats, matrices, perf model, select_format)
against the reference package: same host arrays bit for bit, same
dispatch decisions under the same spec, and a package that imports
neither JAX nor ``repro``.

Tolerances: none -- every comparison here is exact (host numpy code,
the port's copy runs the same arithmetic; the vectorised pJDS, ELLPACK-R
and CMRS fills write the same values into the same slots).
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import formats as F
from repro.core import matrices as M
from repro.core import perf_model as PM
from repro.kernels import ops as JO

from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.core import perf_model as TPM
from repro_torch.kernels import ops as TO

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _zipf(n=160, seed=0):
    rng = np.random.default_rng(seed)
    rl = np.clip(rng.zipf(1.8, size=n), 1, n // 4)
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, rng.integers(0, n, size=rl[i])] = rng.standard_normal(rl[i])
    return a


def _as_port(m):
    return TF.CSRMatrix(m.indptr, m.indices, m.data, m.shape)


_MATRICES = {
    "samg": lambda: M.samg(scale=1e-4),
    "poisson": lambda: M.poisson_2d(24, 24),
    "zipf160": lambda: F.csr_from_dense(_zipf()),
    "power_law": lambda: M.power_law(700, seed=3),
}


@pytest.mark.parametrize("name", ["samg_1e-4", "samg_3e-4", "poisson_24",
                                  "poisson_7x9"])
def test_generators_are_bit_identical(name):
    ref, port = {
        "samg_1e-4": (lambda: M.samg(scale=1e-4), lambda: TM.samg(scale=1e-4)),
        "samg_3e-4": (lambda: M.samg(scale=3e-4, seed=5),
                      lambda: TM.samg(scale=3e-4, seed=5)),
        "poisson_24": (lambda: M.poisson_2d(24, 24),
                       lambda: TM.poisson_2d(24, 24)),
        "poisson_7x9": (lambda: M.poisson_2d(7, 9),
                        lambda: TM.poisson_2d(7, 9)),
    }[name]
    a, b = ref(), port()
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _assert_pjds_equal(p, q):
    for f in ("val", "col_idx", "block_start", "block_len", "rowlen", "perm",
              "inv_perm"):
        x, y = getattr(p, f), getattr(q, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (p.shape, p.b_r, p.n_rows_pad, p.permuted_cols) == \
        (q.shape, q.b_r, q.n_rows_pad, q.permuted_cols)


@pytest.mark.parametrize("name", sorted(_MATRICES))
@pytest.mark.parametrize("b_r,diag_align", [(32, 8), (128, 16)])
@pytest.mark.parametrize("permuted_cols", [False, True])
@pytest.mark.parametrize("index_dtype", ["auto", np.int32])
def test_pjds_arrays_bit_identical(name, b_r, diag_align, permuted_cols,
                                   index_dtype):
    # the port's vectorised fill must write exactly the reference loop's
    # arrays
    m = _MATRICES[name]()
    p = F.csr_to_pjds(m, b_r=b_r, diag_align=diag_align,
                      permuted_cols=permuted_cols, index_dtype=index_dtype)
    q = TF.csr_to_pjds(_as_port(m), b_r=b_r, diag_align=diag_align,
                       permuted_cols=permuted_cols, index_dtype=index_dtype)
    _assert_pjds_equal(p, q)


@pytest.mark.parametrize("name", sorted(_MATRICES))
@pytest.mark.parametrize("sigma_mult", [1, 4, 1000])
def test_sell_arrays_bit_identical(name, sigma_mult):
    m = _MATRICES[name]()
    b_r = 32
    s = F.csr_to_sell(m, c=b_r, sigma=sigma_mult * b_r, diag_align=16,
                      permuted_cols=False)
    t = TF.csr_to_sell(_as_port(m), c=b_r, sigma=sigma_mult * b_r,
                       diag_align=16, permuted_cols=False)
    assert s.sigma == t.sigma
    _assert_pjds_equal(s.pjds, t.pjds)


@pytest.mark.parametrize("name", sorted(_MATRICES))
@pytest.mark.parametrize("b_r,diag_align", [(32, 8), (128, 16)])
@pytest.mark.parametrize("index_dtype", ["auto", np.int32])
def test_ell_arrays_bit_identical(name, b_r, diag_align, index_dtype):
    m = _MATRICES[name]()
    e = F.csr_to_ell(m, row_align=b_r, diag_align=diag_align,
                     index_dtype=index_dtype)
    t = TF.csr_to_ell(_as_port(m), row_align=b_r, diag_align=diag_align,
                      index_dtype=index_dtype)
    for f in ("val", "col_idx", "rowlen"):
        x, y = getattr(e, f), getattr(t, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (e.shape, e.n_rows_pad, e.max_nzr) == \
        (t.shape, t.n_rows_pad, t.max_nzr)
    np.testing.assert_array_equal(TF.ell_to_dense(t), F.ell_to_dense(e))


@pytest.mark.parametrize("name", sorted(_MATRICES))
@pytest.mark.parametrize("b_r,diag_align", [(32, 8), (128, 16)])
@pytest.mark.parametrize("index_dtype", ["auto", np.int32])
def test_cmrs_arrays_bit_identical(name, b_r, diag_align, index_dtype):
    m = _MATRICES[name]()
    c = F.csr_to_cmrs(m, b_r=b_r, diag_align=diag_align,
                      index_dtype=index_dtype)
    t = TF.csr_to_cmrs(_as_port(m), b_r=b_r, diag_align=diag_align,
                       index_dtype=index_dtype)
    for f in ("val", "col_idx", "row_in_strip", "strip_start", "strip_len",
              "strip_nnz"):
        x, y = getattr(c, f), getattr(t, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (c.shape, c.b_r, c.n_rows_pad, c.total_su) == \
        (t.shape, t.b_r, t.n_rows_pad, t.total_su)
    np.testing.assert_array_equal(TF.cmrs_to_dense(t), F.cmrs_to_dense(c))


@pytest.mark.parametrize("name", sorted(_MATRICES))
def test_footprints_and_data_reduction_match(name):
    m = _MATRICES[name]()
    tm = _as_port(m)
    builds = {
        "csr": (m, tm),
        "ellpack_r": (F.csr_to_ell(m, row_align=32),
                      TF.csr_to_ell(tm, row_align=32)),
        "pjds": (F.csr_to_pjds(m, b_r=32), TF.csr_to_pjds(tm, b_r=32)),
        "sell": (F.csr_to_sell(m, c=32, permuted_cols=False),
                 TF.csr_to_sell(tm, c=32, permuted_cols=False)),
        "cmrs": (F.csr_to_cmrs(m, b_r=32), TF.csr_to_cmrs(tm, b_r=32)),
    }
    for fmt, (ref, port) in builds.items():
        assert TF.storage_elements(port) == F.storage_elements(ref), fmt
        assert TF.format_nbytes(port) == F.format_nbytes(ref), fmt
        assert TF.format_nbytes(port, 2, 2) == F.format_nbytes(ref, 2, 2)
    for b_r in (32, 128):
        assert TF.data_reduction_vs_ellpack(tm, b_r) == \
            F.data_reduction_vs_ellpack(m, b_r)


@pytest.mark.parametrize("name", sorted(_MATRICES))
@pytest.mark.parametrize("b_r,diag_align", [(32, 1), (32, 8), (64, 16),
                                            (128, 16)])
@pytest.mark.parametrize("sigma_mult", [1, 8, None])     # None: sigma >= n
def test_derived_lengths_match_host_lengths(name, b_r, diag_align,
                                            sigma_mult):
    # K2's per-warp and K6's per-strip walk lengths, derived on the
    # device from the stored arrays alone, are the host's row lengths
    # (no test matrix stores an explicit 0 at column 0)
    tm = _as_port(_MATRICES[name]())
    sigma = 1 << 20 if sigma_mult is None else sigma_mult * b_r
    s = TF.csr_to_sell(tm, c=b_r, sigma=sigma, diag_align=diag_align,
                       permuted_cols=False)
    d = TO.to_device_sell(s, chunk_l=diag_align, device="cpu")
    assert d.warp_len.dtype == torch.int32
    np.testing.assert_array_equal(d.warp_len.numpy(),
                                  s.pjds.rowlen.reshape(-1, 32).max(axis=1))
    assert int(d.warp_len.max()) <= int(s.pjds.block_len.max())
    c = TF.csr_to_cmrs(tm, b_r=b_r, diag_align=diag_align)
    dc = TO.to_device_cmrs(c, device="cpu")
    assert dc.strip_nnz.dtype == torch.int32
    np.testing.assert_array_equal(dc.strip_nnz.numpy(), c.strip_nnz)


@pytest.mark.parametrize("fmt", ["sell", "cmrs", "pjds"])
@pytest.mark.parametrize("bf16", [False, True])
def test_derived_lengths_of_carried_containers_match(fmt, bf16):
    # a reference container carried across by convert.sparse_device gets
    # the same lengths as the port's own as_device build
    import jax.numpy as jnp
    from repro_torch import convert
    m = M.samg(scale=2e-4, seed=3)
    sd = JO.as_device(m, fmt, b_r=32, chunk_l=8,
                      dtype=jnp.bfloat16 if bf16 else None)
    inner = sd.dev
    arrays = {f: np.asarray(getattr(inner, f))
              for f in ("val", "col_idx", "row_block", "inv_perm",
                        "row_in_strip", "strip_map") if hasattr(inner, f)}
    statics = {f: getattr(inner, f) for f in ("n_blocks", "b_r", "chunk_l",
                                              "sigma", "n_strips")
               if hasattr(inner, f)}
    port = convert.sparse_device(
        fmt, sd.shape, arrays, statics,
        inv_perm=None if sd.inv_perm is None else np.asarray(sd.inv_perm),
        x_tiles=sd.x_tiles, device="cpu")
    own = TO.as_device(_as_port(m), fmt, b_r=32, chunk_l=8,
                       dtype=torch.bfloat16 if bf16 else None, device="cpu")
    field = "strip_nnz" if fmt == "cmrs" else "warp_len"
    assert torch.equal(getattr(own.dev, field), getattr(port.dev, field))
    assert int(getattr(own.dev, field).sum()) > 0


def test_padding_audit_catches_a_corrupt_slot():
    q = TF.csr_to_pjds(_as_port(M.samg(scale=1e-4)), b_r=32)
    TF.assert_padding_invariant(q)
    pad = np.argwhere(q.val == 0)[0]
    q.val[tuple(pad)] = 1.0
    with pytest.raises(AssertionError):
        TF.assert_padding_invariant(q)


@pytest.mark.parametrize("fmt", ["ellpack_r", "cmrs"])
def test_padding_audit_catches_a_corrupt_slot_ell_cmrs(fmt):
    tm = _as_port(M.samg(scale=1e-4))
    q = TF.csr_to_ell(tm, row_align=32) if fmt == "ellpack_r" \
        else TF.csr_to_cmrs(tm, b_r=32)
    TF.assert_padding_invariant(q)
    pad = tuple(np.argwhere(q.val == 0)[-1])
    q.col_idx[pad] = 3
    with pytest.raises(AssertionError):
        TF.assert_padding_invariant(q)
    if fmt == "cmrs":
        q.col_idx[pad] = TF.PAD_COL
        q.row_in_strip[pad] = 1
        with pytest.raises(AssertionError, match="row_in_strip"):
            TF.assert_padding_invariant(q)


@pytest.mark.parametrize("span,expect", [(2 ** 15, np.int16),
                                         (2 ** 15 + 1, np.int32)])
def test_index_dtype_resolution(span, expect):
    assert TF.resolve_index_dtype("auto", span) == \
        F.resolve_index_dtype("auto", span) == np.dtype(expect)
    with pytest.raises(ValueError):
        TF.resolve_index_dtype(np.int16, 2 ** 15 + 1)


@pytest.mark.parametrize("name", sorted(_MATRICES))
@pytest.mark.parametrize("fmt", ["csr", "ellpack_r", "pjds", "sell", "cmrs"])
def test_storage_estimates_match(name, fmt):
    rl = _MATRICES[name]().row_lengths()
    assert TF.estimate_storage_elements(rl, fmt, 32, 8) == \
        F.estimate_storage_elements(rl, fmt, 32, 8)


@pytest.mark.parametrize("name", sorted(_MATRICES) + ["uniform"])
@pytest.mark.parametrize("policy", [dict(),
                                    dict(value_dtype="bfloat16"),
                                    dict(index_dtype=np.int32),
                                    dict(x_tiles=4)])
def test_select_format_same_decision_under_tpu_spec(name, policy):
    if name == "uniform":      # constant rows: the ELLPACK-R shortcut
        m = M.poisson_2d(40, 40)
    else:
        m = _MATRICES[name]()
    jpol = dict(policy)
    if jpol.get("value_dtype") == "bfloat16":
        import jax.numpy as jnp
        jpol["value_dtype"] = jnp.bfloat16
    for b_r in (32, 128):
        assert TO.select_format(_as_port(m), b_r=b_r, spec=TPM.TPU_V5E,
                                **policy) == \
            JO.select_format(m, b_r=b_r, spec=PM.TPU_V5E, **jpol)


@pytest.mark.parametrize("name", sorted(_MATRICES) + ["uniform"])
@pytest.mark.parametrize("policy", [dict(), dict(value_dtype="bfloat16"),
                                    dict(index_dtype=np.int32)])
def test_select_format_same_decision_under_h100_spec(name, policy):
    # the reference priced with the port's H100 numbers decides the same
    m = M.poisson_2d(40, 40) if name == "uniform" else _MATRICES[name]()
    jspec = PM.TPUSpec(**dataclasses.asdict(TPM.H100))
    jpol = dict(policy)
    if jpol.get("value_dtype") == "bfloat16":
        import jax.numpy as jnp
        jpol["value_dtype"] = jnp.bfloat16
    for b_r, da in ((32, 8), (128, 16)):
        assert TO.select_format(_as_port(m), b_r=b_r, diag_align=da,
                                **policy) == \
            JO.select_format(m, b_r=b_r, diag_align=da, spec=jspec, **jpol)


def test_auto_picks_cmrs_on_samg_and_ellpack_r_on_poisson():
    # the paper's two operators under the port's default (H100) spec, at
    # the diag_align 16 that as_device uses with chunk_l 16
    for scale in (0.01, 0.03):
        assert TO.select_format(TM.samg(scale=scale), diag_align=16) == "cmrs"
    assert TO.select_format(TM.poisson_2d(64, 64), diag_align=16) == \
        "ellpack_r"


def test_perf_model_pricing_matches():
    args = (123_456, 10_000, 7.3)
    for kw in (dict(), dict(perm_bytes=1e5, value_bytes=2, index_bytes=2),
               dict(x_tiles=4, n_row_blocks=80, fmt="sell")):
        assert TPM.predicted_spmv_seconds(*args, spec=TPM.TPU_V5E, **kw) == \
            PM.predicted_spmv_seconds(*args, spec=PM.TPU_V5E, **kw)
    assert TPM.solver_iteration_bytes(1000, 100, 7.0, strategy="fused") == \
        PM.solver_iteration_bytes(1000, 100, 7.0, strategy="fused")
    assert TPM.cmrs_reduce_seconds(10_000, 128, TPM.TPU_V5E) == \
        PM.cmrs_reduce_seconds(10_000, 128, PM.TPU_V5E)


def test_calibration_hook_moves_the_price():
    base = TPM.predicted_spmv_seconds(1000, 100, 7.0, fmt="sell")
    TPM.set_calibration(TPM.Calibration(bw_scale=0.5,
                                        overhead_s={"sell": 1e-6}))
    try:
        assert TPM.predicted_spmv_seconds(1000, 100, 7.0, fmt="sell") == \
            pytest.approx(2 * base + 1e-6)
    finally:
        TPM.clear_calibration()


def test_h100_spec_is_the_port_default():
    h = TPM.H100
    assert (h.hbm_bw, h.peak_flops, h.hbm_bytes) == (3.35e12, 989e12,
                                                     80 * 10 ** 9)
    import inspect
    assert inspect.signature(TO.select_format).parameters["spec"].default \
        is h
    assert inspect.signature(
        TPM.predicted_spmv_seconds).parameters["spec"].default is h


def test_validate_csr_matches_reference():
    m = M.poisson_2d(6, 6)
    bad = F.CSRMatrix(m.indptr, m.indices.copy(), m.data.copy(), m.shape)
    bad.data[3] = np.nan
    bad.indices[5] = 99
    _, rep = F.validate_csr(bad, repair=True)
    tbad = _as_port(bad)
    with pytest.raises(TF.CSRValidationError):
        TF.validate_csr(tbad)
    fixed, trep = TF.validate_csr(tbad, repair=True)
    assert trep.issues == rep.issues and trep.repaired
    ref_fixed, _ = F.validate_csr(bad, repair=True)
    np.testing.assert_array_equal(fixed.indices, ref_fixed.indices)
    np.testing.assert_array_equal(fixed.data, ref_fixed.data)


# ---------------------------------------------------------------- isolation
def _port_files():
    pkg = ROOT / "src" / "repro_torch"
    return sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "kernel_ab.py",
                                        ROOT / "dist_scaling.py",
                                        ROOT / "dist_train.py",
                                        ROOT / "dist_serve.py",
                                        ROOT / "experiments" /
                                        "parity_rows.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {name}"


def test_port_runs_without_jax_or_repro_in_sys_modules():
    code = (
        "import sys, numpy as np, torch\n"
        "import repro_torch\n"
        "from repro_torch.core import matrices as TM\n"
        "m = TM.samg(scale=1e-4)\n"
        "b = np.ones(m.n_rows, np.float32)\n"
        "res = repro_torch.solve(m, b, tune='off', fallback='off',"
        " device='cpu')\n"
        "y = repro_torch.operator(m, 'pjds', device='cpu') @ b\n"
        "assert res.status == 'converged', res.status\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('isolated-ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "isolated-ok" in out.stdout
