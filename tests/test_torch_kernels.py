"""K1-K6: the port's plain versions against the JAX package's Pallas
kernels (interpret mode) and jnp refs, the backend rules around them,
and -- on a CUDA card -- the hand-written kernels against the plain
versions.

The JAX modules are imported inside the tests (``_jax``), so the card
tests of this file also run on a machine without JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: y within 1e-5 * max|y| -- both sides read the same stored
values (bit-identical, bf16 included) and accumulate in f32, only the
summation order differs, over <= 40 terms per row.  A dot within
1e-5 * ||a|| ||b|| -- relative to its operands' norms, since a dot
near zero has no meaningful relative error.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.kernels import _backend as TB
from repro_torch.kernels import fused_iter as TFI
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels.cmrs_spmv import cmrs_matvec_kernel_call
from repro_torch.kernels.ellr_spmv import ell_matvec_kernel_call
from repro_torch.kernels.pjds_spmm import pjds_matmat_kernel_call
from repro_torch.kernels.pjds_spmv import pjds_matvec_kernel_call
from repro_torch.kernels.sell_spmv import (sell_matvec_kernel_call,
                                           slab_fits, window_blocks)

N = 160           # not a multiple of 32 -> padded tail blocks
B_R = 32
_SEED = 0


def _zipf():
    rng = np.random.default_rng(_SEED)
    rl = np.clip(rng.zipf(1.8, size=N), 1, N // 4)     # skewed rows
    a = np.zeros((N, N), np.float32)
    for i in range(N):
        a[i, rng.integers(0, N, size=rl[i])] = rng.standard_normal(rl[i])
    return a


_A = _zipf()
_TM = TF.csr_from_dense(_A)
_X = np.random.default_rng(_SEED + 1).standard_normal(N).astype(np.float32)

# (id, jax value dtype name, torch value dtype, index dtype)
_POLICIES = [pytest.param(None, None, np.int32, id="f32+int32"),
             pytest.param("bfloat16", torch.bfloat16, np.int16,
                          id="bf16+int16")]


def _jax():
    """The reference modules, imported on use (see module docstring)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import formats as F
    from repro.kernels import fused_iter, ops
    return jnp, F, ops, fused_iter


def _jdtype(jnp, name):
    return None if name is None else getattr(jnp, name)


def _close(y, y_ref, tol=1e-5):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    scale = max(np.abs(y_ref).max(), 1e-30)
    assert np.abs(y - y_ref).max() <= tol * scale


def _dots_close(d, d_ref, norms, tol=1e-5):
    d, d_ref = np.asarray(d, np.float64), np.asarray(d_ref, np.float64)
    assert np.all(np.abs(d - d_ref) <= tol * np.asarray(norms))


def _same_bits(t: torch.Tensor, a) -> None:
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("jdt,tdt,idt", _POLICIES)
@pytest.mark.parametrize("chunk_l", [8, 16])
@pytest.mark.parametrize("x_tiles", [1, 2])
@pytest.mark.parametrize("fmt", ["pjds", "sell"])
def test_plain_versions_match_jax_kernels(fmt, x_tiles, chunk_l, jdt, tdt,
                                          idt):
    jnp, F, jops, _ = _jax()
    kw = dict(b_r=B_R, diag_align=chunk_l, chunk_l=chunk_l, index_dtype=idt,
              x_tiles=x_tiles)
    sd_j = jops.as_device(F.csr_from_dense(_A), fmt,
                          dtype=_jdtype(jnp, jdt), **kw)
    x = jnp.asarray(_X)
    y_kernel = np.asarray(sd_j.matvec(x, backend="kernel"))   # interpret
    y_ref = np.asarray(sd_j.matvec(x, backend="ref"))
    sd_t = TO.as_device(_TM, fmt, dtype=tdt, device="cpu", **kw)
    _same_bits(sd_t.dev.val, sd_j.dev.val)
    _same_bits(sd_t.dev.col_idx, sd_j.dev.col_idx)
    y_t = sd_t.matvec(torch.from_numpy(_X)).numpy()
    _close(y_t, y_kernel)
    _close(y_t, y_ref)


@pytest.mark.parametrize("sigma", [B_R, 4 * B_R, N + B_R])
def test_sell_sigma_axis(sigma):
    jnp, F, jops, _ = _jax()
    kw = dict(b_r=B_R, diag_align=8, chunk_l=8, sigma=sigma)
    sd_j = jops.as_device(F.csr_from_dense(_A), "sell", **kw)
    y_kernel = np.asarray(sd_j.matvec(jnp.asarray(_X), backend="kernel"))
    sd_t = TO.as_device(_TM, "sell", device="cpu", **kw)
    _close(sd_t.matvec(torch.from_numpy(_X)).numpy(), y_kernel)
    _close(sd_t.matvec(torch.from_numpy(_X)).numpy(),
           _A.astype(np.float64) @ _X, tol=1e-4)


@pytest.mark.parametrize("jdt,tdt,idt", _POLICIES)
@pytest.mark.parametrize("chunk_l", [8, 16])
def test_ell_plain_matches_jax_kernel(chunk_l, jdt, tdt, idt):
    jnp, F, jops, _ = _jax()
    kw = dict(b_r=B_R, diag_align=chunk_l, chunk_l=chunk_l, index_dtype=idt)
    sd_j = jops.as_device(F.csr_from_dense(_A), "ellpack_r",
                          dtype=_jdtype(jnp, jdt), **kw)
    x = jnp.asarray(_X)
    y_kernel = np.asarray(sd_j.matvec(x, backend="kernel"))   # interpret
    y_ref = np.asarray(sd_j.matvec(x, backend="ref"))
    sd_t = TO.as_device(_TM, "ellpack_r", dtype=tdt, device="cpu", **kw)
    for f in ("val", "col_idx", "rowlen"):
        _same_bits(getattr(sd_t.dev, f), getattr(sd_j.dev, f))
    y_t = sd_t.matvec(torch.from_numpy(_X)).numpy()
    _close(y_t, y_kernel)
    _close(y_t, y_ref)


@pytest.mark.parametrize("jdt,tdt,idt", _POLICIES)
@pytest.mark.parametrize("chunk_l", [8, 16])
@pytest.mark.parametrize("x_tiles", [1, 2])
def test_cmrs_plain_matches_jax_kernel(x_tiles, chunk_l, jdt, tdt, idt):
    jnp, F, jops, _ = _jax()
    kw = dict(b_r=B_R, diag_align=chunk_l, chunk_l=chunk_l, index_dtype=idt,
              x_tiles=x_tiles)
    sd_j = jops.as_device(F.csr_from_dense(_A), "cmrs",
                          dtype=_jdtype(jnp, jdt), **kw)
    x = jnp.asarray(_X)
    y_kernel = np.asarray(sd_j.matvec(x, backend="kernel"))   # interpret
    y_ref = np.asarray(sd_j.matvec(x, backend="ref"))
    sd_t = TO.as_device(_TM, "cmrs", dtype=tdt, device="cpu", **kw)
    for f in ("val", "col_idx", "row_in_strip", "strip_map"):
        _same_bits(getattr(sd_t.dev, f), getattr(sd_j.dev, f))
    y_t = sd_t.matvec(torch.from_numpy(_X)).numpy()
    _close(y_t, y_kernel)
    _close(y_t, y_ref)


_XK = {k: np.random.default_rng(10 + k).standard_normal((N, k)).astype(
    np.float32) for k in (0, 1, 3, 8)}


@pytest.mark.parametrize("jdt,tdt,idt", _POLICIES)
@pytest.mark.parametrize("k", sorted(_XK))
@pytest.mark.parametrize("fmt", ["pjds", "sell"])
def test_pjds_matmat_plain_matches_jax_kernel(fmt, k, jdt, tdt, idt):
    # K5's function in the permuted (storage) basis, and through the
    # operand's matmat in the original basis
    jnp, F, jops, _ = _jax()
    kw = dict(b_r=B_R, diag_align=16, chunk_l=16, index_dtype=idt)
    sd_j = jops.as_device(F.csr_from_dense(_A), fmt,
                          dtype=_jdtype(jnp, jdt), **kw)
    xk = jnp.asarray(_XK[k])
    d = sd_j.dev
    pj = jops.PJDSDevice(val=d.val, col_idx=d.col_idx,
                         chunk_map=d.chunk_map, row_block=d.row_block,
                         n_blocks=d.n_blocks, b_r=d.b_r, chunk_l=d.chunk_l,
                         max_chunks=d.max_chunks)
    yp_kernel = np.asarray(jops.pjds_matmat(pj, xk, backend="kernel"))
    yp_ref = np.asarray(jops.pjds_matmat(pj, xk, backend="ref"))
    sd_t = TO.as_device(_TM, fmt, dtype=tdt, device="cpu", **kw)
    yp_t = TO.pjds_matmat(sd_t.dev, torch.from_numpy(_XK[k])).numpy()
    assert yp_t.shape == (sd_t.dev.n_rows_pad, k)
    if k == 0:
        assert yp_kernel.shape == yp_t.shape
        return
    _close(yp_t, yp_kernel)
    _close(yp_t, yp_ref)
    y_j = np.asarray(sd_j.matmat(xk, backend="kernel"))
    y_t = sd_t.matmat(torch.from_numpy(_XK[k])).numpy()
    _close(y_t, y_j)


@pytest.mark.parametrize("fmt", ["ellpack_r", "cmrs", "csr"])
@pytest.mark.parametrize("k", [1, 3])
def test_matmat_of_unblocked_formats_matches_reference(fmt, k):
    # the reference has no multi-RHS kernel for these: plain 2-D refs
    jnp, F, jops, _ = _jax()
    kw = dict(b_r=B_R, diag_align=8, chunk_l=8)
    y_j = np.asarray(jops.as_device(F.csr_from_dense(_A), fmt, **kw)
                     .matmat(jnp.asarray(_XK[k])))
    sd_t = TO.as_device(_TM, fmt, device="cpu", **kw)
    y_t = sd_t.matmat(torch.from_numpy(_XK[k])).numpy()
    assert y_t.shape == y_j.shape == (N, k)
    _close(y_t, y_j)
    assert sd_t.matmat(torch.from_numpy(_XK[0])).shape == (N, 0)


def test_ell_masks_padding_where_the_pallas_kernel_leaks_nan():
    # The Pallas K4 computes every padded slot below its row tile's
    # longest row, so a NaN in x[0] (the padding column) leaks into
    # short rows; its own plain version masks by rowlen and does not.
    # The port's plain version and K4 follow the masked ref, which is
    # what the reference runs on the CPU.
    jnp, F, jops, _ = _jax()
    x = _X.copy()
    x[0] = np.nan
    kw = dict(b_r=B_R, diag_align=8, chunk_l=8)
    sd_j = jops.as_device(F.csr_from_dense(_A), "ellpack_r", **kw)
    y_kernel = np.asarray(sd_j.matvec(jnp.asarray(x), backend="kernel"))
    y_ref = np.asarray(sd_j.matvec(jnp.asarray(x), backend="ref"))
    y_t = TO.as_device(_TM, "ellpack_r", device="cpu", **kw).matvec(
        torch.from_numpy(x)).numpy()
    reads_col0 = _A[:, 0] != 0
    np.testing.assert_array_equal(np.isnan(y_t), np.isnan(y_ref))
    np.testing.assert_array_equal(np.isnan(y_t), reads_col0)
    assert np.isnan(y_kernel).sum() > reads_col0.sum()      # the leak


def test_cmrs_nan_in_x0_poisons_like_the_reference():
    # Padding slots route 0 * x[0] into row 0 of their strip, in the
    # reference's plain version and in the port's.  (The Pallas K6 goes
    # further: its one-hot routing matmul multiplies the NaN product by
    # 0 for every other row of the strip, so the whole strip turns NaN.)
    jnp, F, jops, _ = _jax()
    x = _X.copy()
    x[0] = np.nan
    kw = dict(b_r=B_R, diag_align=8, chunk_l=8)
    sd_j = jops.as_device(F.csr_from_dense(_A), "cmrs", **kw)
    y_j = np.asarray(sd_j.matvec(jnp.asarray(x), backend="ref"))
    y_t = TO.as_device(_TM, "cmrs", device="cpu", **kw).matvec(
        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(y_t), np.isnan(y_j))
    strip_row0 = np.arange(N) % B_R == 0
    assert np.isnan(y_t[strip_row0]).all()
    assert np.isnan(y_t).sum() > (_A[:, 0] != 0).sum()
    y_kernel = np.asarray(sd_j.matvec(jnp.asarray(x), backend="kernel"))
    assert np.isnan(y_kernel).all()


def _carriers(n_pad, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        v = np.zeros(n_pad, np.float32)
        v[:N] = rng.standard_normal(N)
        out.append(v)
    return out


@pytest.mark.parametrize("jdt,tdt,idt", _POLICIES)
@pytest.mark.parametrize("sigma", [B_R, 4 * B_R, N + B_R])
def test_fused_plain_matches_jax_kernel(sigma, jdt, tdt, idt):
    jnp, F, jops, jfused = _jax()
    kw = dict(b_r=B_R, diag_align=16, chunk_l=16, sigma=sigma,
              index_dtype=idt)
    sd_j = jops.as_device(F.csr_from_dense(_A), "sell",
                          dtype=_jdtype(jnp, jdt), **kw)
    v, w1, w2 = _carriers(sd_j.dev.n_rows_pad, seed=sigma)
    jv = [jnp.asarray(a) for a in (v, w1, w2)]
    out_k = jfused.fused_matvec_dots(sd_j.dev, *jv, backend="kernel",
                                     interpret=True)
    out_r = jfused.fused_matvec_dots(sd_j.dev, *jv, backend="ref")
    sd_t = TO.as_device(_TM, "sell", dtype=tdt, device="cpu", **kw)
    y_t, dots_t = TFI.fused_matvec_dots(
        sd_t.dev, *(torch.from_numpy(a) for a in (v, w1, w2)))
    y_t = y_t.numpy()
    ny = np.linalg.norm(y_t)
    norms = [ny * np.linalg.norm(w1), ny * np.linalg.norm(w2), ny * ny,
             np.linalg.norm(w2) ** 2,
             np.linalg.norm(w1) * np.linalg.norm(w2)]
    for out in (out_k, out_r):
        _close(y_t, np.asarray(out[0]))
        _dots_close(dots_t.numpy(), [float(d) for d in out[1:]], norms)


def test_nan_in_x0_poisons_padded_rows_like_the_reference():
    jnp, F, jops, _ = _jax()
    x = _X.copy()
    x[0] = np.nan
    for fmt in ("pjds", "sell"):
        sd_j = jops.as_device(F.csr_from_dense(_A), fmt, b_r=B_R)
        y_j = np.asarray(sd_j.matvec(jnp.asarray(x), backend="ref"))
        sd_t = TO.as_device(_TM, fmt, b_r=B_R, device="cpu")
        y_t = sd_t.matvec(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(np.isnan(y_t), np.isnan(y_j))
        assert np.isnan(y_t).sum() > 1      # padding, not just column 0


def test_window_blocks_matches_reference():
    from repro.kernels.sell_spmv import window_blocks as jwb
    for sigma in (1, 16, 32, 48, 96, 128, 1024, 4096, 10 ** 6):
        for b_r in (32, 64, 128):
            for n_blocks in (1, 3, 8, 100):
                assert window_blocks(sigma, b_r, n_blocks) == \
                    jwb(sigma, b_r, n_blocks)


@pytest.mark.parametrize("w_b,b_r,fits", [(8, 128, True), (96, 128, True),
                                          (97, 128, False), (240, 128, False)])
def test_slab_path_choice(w_b, b_r, fits):
    # the shared-memory slab holds w_b * b_r f32: 48 KB or the
    # device-memory unpermute path
    assert slab_fits(w_b, b_r) is fits


def test_pad_x_to_tiles_matches_reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels._backend import pad_x_to_tiles as jpad
    for n, t in ((10, 1), (10, 3), (12, 4), (7, 8)):
        x = np.arange(n, dtype=np.float32)
        xt, lt = TB.pad_x_to_tiles(torch.from_numpy(x), t)
        xj, lj = jpad(jnp.asarray(x), t)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        assert lt == lj


def test_acc_dtype_rule():
    f32, bf16 = torch.float32, torch.bfloat16
    assert TB.acc_dtype(bf16, f32) == f32
    assert TB.acc_dtype(bf16, bf16) == f32
    assert TB.acc_dtype(torch.float16) == f32
    assert TB.acc_dtype(f32, f32) == f32
    assert TB.acc_dtype(f32, torch.float64) == torch.float64


def test_host_tensor_width_rule_and_bf16_bits():
    ml = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(3)
    a = rng.standard_normal(50_000) * np.exp(rng.uniform(-30, 30, 50_000))
    # f64 values exactly halfway between two bf16 after rounding to f32
    a[:4] = [1.0 + 2 ** -8 + 2 ** -30, 1.0 + 2 ** -8, -(1.0 + 3 * 2 ** -8),
             1.0 + 2 ** -8 - 2 ** -30]
    t = TB.host_tensor(a, "cpu", torch.bfloat16)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.astype(ml.bfloat16).view(np.int16))
    assert TB.host_tensor(a, "cpu").dtype == torch.float32
    assert TB.host_tensor(np.arange(3), "cpu").dtype == torch.int32
    assert TB.host_tensor(np.arange(3, dtype=np.int16), "cpu").dtype == \
        torch.int16


def test_value_dtype_resolution():
    assert TB.value_dtype(None) is None
    assert TB.value_dtype("bfloat16") == torch.bfloat16
    assert TB.value_dtype(np.float32) == torch.float32
    assert TB.value_dtype(torch.bfloat16) == torch.bfloat16
    for bad in (np.float64, torch.float16, "int8"):
        with pytest.raises(ValueError):
            TB.value_dtype(bad)


def test_backend_rule_on_cpu():
    x = torch.zeros(4)
    assert TB.resolve_backend(x) == "ref"
    assert TB.resolve_backend(x, "ref") == "ref"
    with pytest.raises(ValueError):
        TB.resolve_backend(x, "kernel")       # no interpret mode
    with pytest.raises(ValueError):
        TB.resolve_backend(x, "pallas")


def test_cpu_wrappers_take_the_plain_version_and_count_it():
    sd = TO.as_device(_TM, "sell", b_r=B_R, device="cpu")
    d = sd.dev
    TR.reset_calls()
    launches = sell_matvec_kernel_call.launches
    TO.sell_matvec(d, torch.from_numpy(_X))
    TFI.fused_matvec_dots(d, *(torch.zeros(d.n_rows_pad) for _ in range(3)))
    assert TR.sell_matvec_ref.calls == 1
    assert TR.fused_matvec_dots_ref.calls == 1
    assert sell_matvec_kernel_call.launches == launches


def test_kernel_wrappers_refuse_cpu_tensors():
    d = TO.as_device(_TM, "pjds", b_r=B_R, device="cpu").dev
    x = torch.from_numpy(_X)
    with pytest.raises(ValueError, match="CUDA"):
        pjds_matvec_kernel_call(d.val, d.col_idx, d.block_start, d.warp_len,
                                x, n_blocks=d.n_blocks, max_col=d.max_col)
    with pytest.raises(ValueError, match="CUDA"):
        pjds_matmat_kernel_call(d.val, d.col_idx, d.block_start, d.warp_len,
                                x[:, None], n_blocks=d.n_blocks,
                                max_col=d.max_col)
    e = TO.as_device(_TM, "ellpack_r", b_r=B_R, device="cpu").dev
    with pytest.raises(ValueError, match="CUDA"):
        ell_matvec_kernel_call(e.val, e.col_idx, e.rowlen, x,
                               max_col=e.max_col)
    c = TO.as_device(_TM, "cmrs", b_r=B_R, device="cpu").dev
    with pytest.raises(ValueError, match="CUDA"):
        cmrs_matvec_kernel_call(c.val, c.col_idx, c.row_in_strip,
                                c.strip_start, c.strip_nnz, x,
                                n_strips=c.n_strips, max_col=c.max_col)
    s = TO.as_device(_TM, "sell", b_r=B_R, device="cpu").dev
    with pytest.raises(ValueError, match="CUDA"):
        sell_matvec_kernel_call(s.val, s.col_idx, s.block_start, s.inv_perm,
                                s.warp_len, x, n_blocks=s.n_blocks,
                                sigma=s.sigma, max_col=s.max_col)
    v = torch.zeros(s.n_rows_pad)
    with pytest.raises(ValueError, match="CUDA"):
        TFI.fused_spmv_dots_kernel_call(
            s.val, s.col_idx, s.block_start, s.inv_perm, s.warp_len, v, v, v,
            n_blocks=s.n_blocks, sigma=s.sigma, max_col=s.max_col)


def test_cpu_wrappers_of_k4_k5_k6_take_the_plain_version():
    x = torch.from_numpy(_X)
    TR.reset_calls()
    before = (ell_matvec_kernel_call.launches,
              cmrs_matvec_kernel_call.launches,
              pjds_matmat_kernel_call.launches)
    TO.ell_matvec(TO.as_device(_TM, "ellpack_r", b_r=B_R, device="cpu").dev,
                  x)
    TO.cmrs_matvec(TO.as_device(_TM, "cmrs", b_r=B_R, device="cpu").dev, x)
    TO.pjds_matmat(TO.as_device(_TM, "pjds", b_r=B_R, device="cpu").dev,
                   x[:, None])
    assert (TR.ell_matvec_ref.calls, TR.cmrs_matvec_ref.calls,
            TR.pjds_matmat_ref.calls) == (1, 1, 1)
    assert (ell_matvec_kernel_call.launches,
            cmrs_matvec_kernel_call.launches,
            pjds_matmat_kernel_call.launches) == before


def test_to_device_rejects_unaligned_chunks():
    p = TF.csr_to_pjds(_TM, b_r=B_R, diag_align=8, permuted_cols=False)
    with pytest.raises(ValueError, match="chunk_l"):
        TO.to_device_pjds(p, chunk_l=16, device="cpu")


def test_to_device_cmrs_takes_strips_of_any_length():
    # K6 walks a strip one tile row at a time: no tile-multiple rule
    c = TF.csr_to_cmrs(_TM, b_r=B_R, diag_align=1)
    assert np.any(c.strip_len % 8)
    d = TO.to_device_cmrs(c, device="cpu")
    y = TO.cmrs_matvec(d, torch.from_numpy(_X)).numpy()[:N]
    _close(y, _A.astype(np.float64) @ _X)


@pytest.mark.parametrize("fmt", ["pjds", "sell"])
def test_k5_row_map_inverts_the_unpermute(fmt):
    # On the card K5 stores stored row p at original row out_row[p]; that
    # scatter must give what the plain path's index_select gives.
    sd = TO.as_device(_TM, fmt, b_r=B_R, device="cpu")
    rows = sd.row_map()
    unperm = sd.stored_rows()
    assert rows.dtype == torch.int32 and rows.shape == (sd.dev.n_rows_pad,)
    assert torch.equal(rows[unperm.long()], torch.arange(N, dtype=torch.int32))
    assert int((rows < 0).sum()) == sd.dev.n_rows_pad - N
    xk = torch.from_numpy(_XK[3])
    y_p = TO.pjds_matmat(sd.dev, xk)
    keep = rows >= 0
    y = torch.empty((N, 3))
    y[rows[keep].long()] = y_p[keep]
    assert torch.equal(y, sd.matmat(xk))
    assert sd.row_map() is rows                         # built once


def test_to_device_rejects_operands_the_kernels_would_overrun():
    # K4 trusts rowlen <= max_nzr and K6 row ids < b_r (shared memory)
    e = TF.csr_to_ell(_TM, row_align=B_R)
    e.rowlen[3] = e.max_nzr + 1
    with pytest.raises(ValueError, match="rowlen"):
        TO.to_device_ell(e, device="cpu")
    c = TF.csr_to_cmrs(_TM, b_r=B_R)
    c.row_in_strip[0, 0] = B_R
    with pytest.raises(ValueError, match="row_in_strip"):
        TO.to_device_cmrs(c, device="cpu")


def _trailing_zero_matrix():
    """64 x 64, b_r 32: row 3 (the longest of its warp) ends in a stored
    explicit 0 at column 0, as does row 32, the only non-empty row of
    strip 1."""
    rows = {3: ([5, 9, 0], [1.0, 2.0, 0.0]), 7: ([1, 2], [0.5, -1.0]),
            32: ([4, 0], [1.5, 0.0])}
    indptr, indices, data = [0], [], []
    for i in range(64):
        c, v = rows.get(i, ([i], [1.0 + i]) if i < 32 else ([], []))
        indices += c
        data += v
        indptr.append(len(indices))
    return TF.CSRMatrix(np.array(indptr, np.int64),
                        np.array(indices, np.int32),
                        np.array(data, np.float64), (64, 64))


def test_trailing_explicit_zero_at_column_0_shortens_the_walk():
    # Such a slot looks like padding, so the derived length stops before
    # it; its product is the 0 * x[0] the kernels add for skipped
    # padding, and the plain versions (which walk every slot) give the
    # reference's y.
    jnp, F, jops, _ = _jax()
    m = _trailing_zero_matrix()
    x = np.random.default_rng(7).standard_normal(64).astype(np.float32)
    m_j = F.CSRMatrix(m.indptr, m.indices, m.data, m.shape)
    for fmt in ("sell", "cmrs"):
        sd = TO.as_device(m, fmt, b_r=32, diag_align=8, chunk_l=8,
                          device="cpu")
        if fmt == "sell":
            host = TF.csr_to_sell(m, c=32, sigma=sd.dev.sigma, diag_align=8,
                                  permuted_cols=False)
            full = host.pjds.rowlen.reshape(-1, 32).max(axis=1)
            got = sd.dev.warp_len.numpy()
        else:
            host = TF.csr_to_cmrs(m, b_r=32, diag_align=8)
            full, got = host.strip_nnz, sd.dev.strip_nnz.numpy()
        # exactly one length is one shorter: the warp / strip whose last
        # real slot is that explicit zero (for CMRS only strip 1, whose
        # zero sits in its row 0; strip 0's sits in row 3)
        assert np.count_nonzero(got != full) == 1
        assert np.all(full - got == (full != got))
        y_ref = np.asarray(jops.as_device(m_j, fmt, b_r=32, diag_align=8,
                                          chunk_l=8).matvec(
            jnp.asarray(x), backend="ref"))
        y_t = sd.matvec(torch.from_numpy(x)).numpy()
        _close(y_t, y_ref)
        _close(y_t, _dense(m) @ x.astype(np.float64), tol=1e-6)


def _dense(m):
    a = np.zeros(m.shape)
    rows = np.repeat(np.arange(m.n_rows), np.diff(m.indptr))
    np.add.at(a, (rows, m.indices), m.data)
    return a


def _strips_matrix():
    """384 x 384 in strips of 128: strip 0 empty, strip 1 exactly 128
    non-zeros (two in each of its first 64 rows), strip 2 ordinary."""
    rng = np.random.default_rng(11)
    a = np.zeros((384, 384))
    for i in range(128, 192):
        a[i, rng.choice(384, 2, replace=False)] = rng.standard_normal(2)
    for i in range(256, 384):
        a[i, rng.choice(384, 1 + i % 5, replace=False)] = rng.standard_normal(
            1 + i % 5)
    return a


@pytest.mark.parametrize("diag_align", [1, 16])
def test_empty_and_exact_128_strips_derive_0_and_128(diag_align):
    a = _strips_matrix()
    m = TF.csr_from_dense(a)
    c = TF.csr_to_cmrs(m, b_r=128, diag_align=diag_align)
    d = TO.to_device_cmrs(c, device="cpu")
    assert d.strip_nnz.tolist()[:2] == [0, 128]
    np.testing.assert_array_equal(d.strip_nnz.numpy(), c.strip_nnz)
    assert d.strip_nnz.dtype == torch.int32
    stored = TO.stored_strip_nnz(d.strip_start, 128)
    np.testing.assert_array_equal(stored.numpy(), c.strip_len * 128)
    x = np.random.default_rng(12).standard_normal(384).astype(np.float32)
    _close(TO.cmrs_matvec(d, torch.from_numpy(x)).numpy(),
           a @ x.astype(np.float64), tol=1e-6)


def _edge_matrix(n=203):
    """n x n, not a multiple of 32 rows: row 5 holds 60 non-zeros (the
    only long row, so one block carries one long row), every third row
    from 40 on is empty, and the last 70 rows are empty."""
    rng = np.random.default_rng(21)
    a = np.zeros((n, n))
    a[5, rng.choice(n, 60, replace=False)] = rng.standard_normal(60)
    for i in range(n - 70):
        if i == 5 or (i >= 40 and i % 3 == 0):
            continue
        k = 1 + i % 4
        a[i, rng.choice(n, k, replace=False)] = rng.standard_normal(k)
    return TF.csr_from_dense(a)


def _np_warp_len(p) -> np.ndarray:
    """Walk lengths recounted in numpy from the host pJDS arrays: per
    block and 32 lanes, the 1-based last diagonal holding a slot that is
    not exactly padding."""
    real = (p.val != 0) | (p.col_idx != TF.PAD_COL)
    out = []
    for b in range(p.n_blocks):
        blk = real[p.block_start[b]:p.block_start[b + 1]]
        for w in range(p.b_r // 32):
            hit = np.flatnonzero(blk[:, 32 * w:32 * w + 32].any(axis=1))
            out.append(int(hit[-1]) + 1 if hit.size else 0)
    return np.array(out, np.int32)


@pytest.mark.parametrize("name", ["samg", "poisson", "edge"])
@pytest.mark.parametrize("b_r,diag_align", [(32, 1), (32, 8), (64, 16),
                                            (128, 16)])
def test_pjds_warp_len_matches_a_numpy_recount(name, b_r, diag_align):
    # K1's per-warp walk lengths, derived on the device from the stored
    # arrays, are a numpy recount of the host arrays; pJDS sorts rows
    # globally, so each is the length of the warp's first row
    m = {"samg": lambda: TM.samg(scale=1e-4),
         "poisson": lambda: TM.poisson_2d(24, 24),
         "edge": _edge_matrix}[name]()
    p = TF.csr_to_pjds(m, b_r=b_r, diag_align=diag_align,
                       permuted_cols=False)
    d = TO.to_device_pjds(p, chunk_l=diag_align, device="cpu")
    assert d.warp_len.dtype == torch.int32
    assert d.warp_len.shape == (p.n_rows_pad // 32,)
    np.testing.assert_array_equal(d.warp_len.numpy(), _np_warp_len(p))
    np.testing.assert_array_equal(d.warp_len.numpy(), p.rowlen[::32])
    stored = TO.stored_warp_len(d.block_start, b_r)
    assert torch.all(d.warp_len <= stored)
    if name == "edge":
        # the block of the one long row walks 60 of its diagonals in its
        # first warp; the empty rows' warps walk none
        assert int(d.warp_len[0]) == 60
        assert int(stored[0]) == -(-60 // diag_align) * diag_align
        assert int((d.warp_len == 0).sum()) >= 70 // 32
        if b_r > 32:
            assert int(d.warp_len[1]) < 60


def _np_matmat_walk(p, val, lengths, X):
    """Y = A X over the host pJDS arrays ``p`` (values ``val``) in numpy
    float32, one diagonal at a time in K5's order: lane r of block b
    walks min(lengths[its warp], stored) diagonals and, if that stops
    short of the block's stored length, adds 0 * X[0, :] once."""
    w = p.b_r // 32
    Y = np.zeros((p.n_rows_pad, X.shape[1]), np.float32)
    for b in range(p.n_blocks):
        j0, j1 = p.block_start[b], p.block_start[b + 1]
        n = np.minimum(np.repeat(lengths[b * w:(b + 1) * w], 32), j1 - j0)
        acc = np.zeros((p.b_r, X.shape[1]), np.float32)
        for j in range(j1 - j0):
            term = val[j0 + j][:, None] * X[p.col_idx[j0 + j]]
            acc = np.where((j < n)[:, None], acc + term, acc)
        short = (n < j1 - j0)[:, None]
        acc = np.where(short, acc + np.float32(0) * X[0][None, :], acc)
        Y[b * p.b_r:(b + 1) * p.b_r] = acc
    return Y


@pytest.mark.parametrize("poison", [None, float("nan"), float("inf")])
@pytest.mark.parametrize("k", [1, 3, 4, 8, 12])
def test_skipped_padding_keeps_every_columns_bits(k, poison):
    # K5's rule, per column of a block of right-hand sides: walking each
    # warp's derived length and adding 0 * X[0, c] once gives the bits of
    # the full walk; a NaN or Inf in X[0, c] poisons column c -- of the
    # same rows as the full walk and the plain version -- and no other
    m = _edge_matrix()
    p = TF.csr_to_pjds(m, b_r=64, diag_align=16, permuted_cols=False)
    d = TO.to_device_pjds(p, chunk_l=16, device="cpu")
    val = p.val.astype(np.float32)
    derived = d.warp_len.numpy()
    full = TO.stored_warp_len(d.block_start, p.b_r).numpy()
    assert derived.sum() < full.sum()                     # skips padding
    X = np.random.default_rng(16).standard_normal((m.n_rows, k)).astype(
        np.float32)
    c = k // 2
    if poison is not None:
        X[0, c] = poison
    with np.errstate(invalid="ignore"):
        y_full = _np_matmat_walk(p, val, full, X)
        y_der = _np_matmat_walk(p, val, derived, X)
    bad = np.isnan(y_der)
    np.testing.assert_array_equal(bad, np.isnan(y_full))
    np.testing.assert_array_equal(y_der[~bad].view(np.int32),
                                  y_full[~bad].view(np.int32))
    want = torch.isnan(TR.pjds_matmat_ref(d.val, d.col_idx, d.row_block,
                                          torch.from_numpy(X),
                                          d.n_blocks)).numpy()
    np.testing.assert_array_equal(bad, want)
    if poison is None:
        assert not bad.any()
    else:
        assert bad[:, c].any()
        assert not np.delete(bad, c, axis=1).any()
    keep = [q for q in range(k) if poison is None or q != c]
    if keep:                                # the finite columns are A X
        _close(y_der[p.inv_perm[: m.n_rows]][:, keep],
               _dense(m) @ X[:, keep].astype(np.float64))

# ------------------------------------------------------------- on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


_CARD_CASES = [
    pytest.param(0.003, None, id="samg-10k-sigma1024"),
    pytest.param(0.003, 128, id="samg-10k-sigma128"),
    pytest.param(0.005, 1 << 16, id="samg-17k-sigma>n-device-memory"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,idt", [(None, "int32"),
                                     (torch.bfloat16, "int16"),
                                     (None, "int16")])
@pytest.mark.parametrize("scale,sigma", _CARD_CASES)
def test_kernels_match_plain_versions_on_card(scale, sigma, tdt, idt):
    _need_cuda()
    m = TM.samg(scale=scale)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        m.n_rows).astype(np.float32)).cuda()
    p = TO.as_device(m, "pjds", dtype=tdt, index_dtype=idt).dev
    s = TO.as_device(m, "sell", sigma=sigma, dtype=tdt, index_dtype=idt).dev
    assert str(s.col_idx.dtype) == f"torch.{idt}"
    before = (pjds_matvec_kernel_call.launches,
              sell_matvec_kernel_call.launches)
    _close(TO.pjds_matvec(p, x).cpu(),
           TR.pjds_matvec_ref(p.val, p.col_idx, p.row_block, x,
                              p.n_blocks).cpu())
    _close(TO.sell_matvec(s, x).cpu(),
           TR.sell_matvec_ref(s.val, s.col_idx, s.row_block, s.inv_perm, x,
                              s.n_blocks).cpu())
    assert (pjds_matvec_kernel_call.launches,
            sell_matvec_kernel_call.launches) == (before[0] + 1,
                                                  before[1] + 1)
    n_pad = s.n_rows_pad
    v = [torch.zeros(n_pad, device="cuda") for _ in range(3)]
    for i, t in enumerate(v):
        t[: m.n_rows] = x * (i + 1) - i
    y_k, d_k = TFI.fused_matvec_dots(s, *v)
    y_r, d_r = TR.fused_matvec_dots_ref(s.val, s.col_idx, s.row_block,
                                        s.inv_perm, *v, s.n_blocks)
    _close(y_k.cpu(), y_r.cpu())
    ny = float(y_r.norm())
    n1, n2 = float(v[1].norm()), float(v[2].norm())
    _dots_close(d_k.cpu().numpy(), d_r.cpu().numpy(),
                [ny * n1, ny * n2, ny * ny, n2 * n2, n1 * n2])
    uses_slab = slab_fits(window_blocks(s.sigma, s.b_r, s.n_blocks), s.b_r)
    assert uses_slab == (sigma != 1 << 16)


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1, 4, 8, 32])
@pytest.mark.parametrize("b_r", [32, 64, 128])
def test_k2_k3_every_window_the_tuner_builds_on_card(b_r, factor):
    # The tuner's SELL space (sigma = factor * b_r) on a 10k-row matrix:
    # few, wide windows, where the window CTA once asked for w_b * b_r
    # threads (up to 4096) and K2 failed to launch.
    _need_cuda()
    m = TM.samg(scale=0.003)
    s = TO.as_device(m, "sell", b_r=b_r, sigma=factor * b_r, chunk_l=8,
                     diag_align=8).dev
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        m.n_rows).astype(np.float32)).cuda()
    _close(TO.sell_matvec(s, x).cpu(),
           TR.sell_matvec_ref(s.val, s.col_idx, s.row_block, s.inv_perm, x,
                              s.n_blocks).cpu())
    v = [torch.zeros(s.n_rows_pad, device="cuda") for _ in range(3)]
    for i, t in enumerate(v):
        t[: m.n_rows] = x * (i + 1) - i
    y_k, d_k = TFI.fused_matvec_dots(s, *v)
    y_r, d_r = TR.fused_matvec_dots_ref(s.val, s.col_idx, s.row_block,
                                        s.inv_perm, *v, s.n_blocks)
    _close(y_k.cpu(), y_r.cpu())
    ny = float(y_r.norm())
    n1, n2 = float(v[1].norm()), float(v[2].norm())
    _dots_close(d_k.cpu().numpy(), d_r.cpu().numpy(),
                [ny * n1, ny * n2, ny * ny, n2 * n2, n1 * n2])


@pytest.mark.cuda
def test_kernel_wrappers_validate_operands_on_card():
    _need_cuda()
    d = TO.as_device(TM.samg(scale=1e-3), "pjds").dev
    x = torch.zeros(d.max_col, device="cuda")          # one entry short
    with pytest.raises(ValueError, match="column"):
        pjds_matvec_kernel_call(d.val, d.col_idx, d.block_start, d.warp_len,
                                x, n_blocks=d.n_blocks, max_col=d.max_col)
    x = torch.zeros(d.max_col + 1, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        pjds_matvec_kernel_call(d.val, d.col_idx, d.block_start, d.warp_len,
                                x, n_blocks=d.n_blocks, max_col=d.max_col)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,idt", [(None, "int32"),
                                     (torch.bfloat16, "int16"),
                                     (None, "int16")])
@pytest.mark.parametrize("scale", [0.003, 0.009])   # both fit int16 indices
def test_k4_k5_k6_match_plain_versions_on_card(scale, tdt, idt):
    _need_cuda()
    m = TM.samg(scale=scale)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(m.n_rows).astype(
        np.float32)).cuda()
    e = TO.as_device(m, "ellpack_r", dtype=tdt, index_dtype=idt).dev
    c = TO.as_device(m, "cmrs", dtype=tdt, index_dtype=idt).dev
    p = TO.as_device(m, "pjds", dtype=tdt, index_dtype=idt).dev
    assert str(c.col_idx.dtype) == f"torch.{idt}"
    before = (ell_matvec_kernel_call.launches,
              cmrs_matvec_kernel_call.launches,
              pjds_matmat_kernel_call.launches)
    _close(TO.ell_matvec(e, x).cpu(),
           TR.ell_matvec_ref(e.val, e.col_idx, e.rowlen, x).cpu())
    y6 = TO.cmrs_matvec(c, x)
    _close(y6.cpu(), TR.cmrs_matvec_ref(c.val, c.col_idx, c.row_in_strip,
                                        c.strip_map, x, c.n_strips).cpu())
    assert torch.equal(y6, TO.cmrs_matvec(c, x))          # deterministic
    for k in (1, 3, 8, 12):
        xk = torch.from_numpy(rng.standard_normal((m.n_rows, k)).astype(
            np.float32)).cuda()
        _close(TO.pjds_matmat(p, xk).cpu(),
               TR.pjds_matmat_ref(p.val, p.col_idx, p.row_block, xk,
                                  p.n_blocks).cpu())
    assert TO.pjds_matmat(p, x[:, None][:, :0]).shape == (p.n_rows_pad, 0)
    assert (ell_matvec_kernel_call.launches,
            cmrs_matvec_kernel_call.launches,
            pjds_matmat_kernel_call.launches) == (before[0] + 1,
                                                  before[1] + 2,
                                                  before[2] + 4)


@pytest.mark.cuda
def test_k5_reads_strided_and_misaligned_x_correctly_on_card():
    _need_cuda()
    m = TM.samg(scale=3e-3)
    p = TO.as_device(m, "pjds").dev
    n = m.n_rows
    big = torch.from_numpy(np.random.default_rng(3).standard_normal(
        8 * n + 1).astype(np.float32)).cuda()
    strided = big[: 4 * n].view(n, 4)[:, ::2]          # (n, 2), stride 4
    offset = big[1: 4 * n + 1].view(n, 4)              # 4-byte offset
    offset8 = big[1:].view(n, 8)                       # k = 8, no float4
    for xk in (strided, offset, offset8):
        _close(TO.pjds_matmat(p, xk).cpu(),
               TR.pjds_matmat_ref(p.val, p.col_idx, p.row_block, xk,
                                  p.n_blocks).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["pjds", "sell"])
def test_k5_row_map_matches_plain_unpermute_on_card(fmt):
    _need_cuda()
    m = TM.samg(scale=3e-3)
    sd = TO.as_device(m, fmt)
    d, rows, unperm = sd.dev, sd.row_map(), sd.stored_rows()
    rng = np.random.default_rng(5)
    for k in (1, 3, 8, 12):
        xk = torch.from_numpy(rng.standard_normal((m.n_rows, k)).astype(
            np.float32)).cuda()
        y = pjds_matmat_kernel_call(d.val, d.col_idx, d.block_start,
                                    d.warp_len, xk, n_blocks=d.n_blocks,
                                    max_col=d.max_col, out_row=rows,
                                    n_out=m.n_rows)
        y_r = TR.pjds_matmat_ref(d.val, d.col_idx, d.row_block, xk,
                                 d.n_blocks).index_select(0, unperm)
        assert y.shape == (m.n_rows, k)
        _close(y.cpu(), y_r.cpu())
        assert torch.equal(y, sd.matmat(xk))


def _k2_k6_runs(m, tdt=None, idt="auto", b_r=128, diag_align=8,
                chunk_l=16):
    """(label, kernel(lengths, x), derived lengths, full lengths,
    plain(x)) for K6 and for K2 on both unpermute paths."""
    kw = dict(dtype=tdt, index_dtype=idt, b_r=b_r, diag_align=diag_align,
              chunk_l=chunk_l)
    c = TO.as_device(m, "cmrs", **kw).dev
    runs = [("cmrs", c,
             lambda n, v, c=c: cmrs_matvec_kernel_call(
                 c.val, c.col_idx, c.row_in_strip, c.strip_start, n, v,
                 n_strips=c.n_strips, max_col=c.max_col),
             c.strip_nnz, TO.stored_strip_nnz(c.strip_start, c.b_r),
             lambda v, c=c: TR.cmrs_matvec_ref(
                 c.val, c.col_idx, c.row_in_strip, c.strip_map, v,
                 c.n_strips))]
    for sigma in (None, 1 << 16):        # slab and device-memory paths
        s = TO.as_device(m, "sell", sigma=sigma, **kw).dev
        runs.append((
            f"sell sigma={s.sigma}", s,
            lambda n, v, s=s: sell_matvec_kernel_call(
                s.val, s.col_idx, s.block_start, s.inv_perm, n, v,
                n_blocks=s.n_blocks, sigma=s.sigma, max_col=s.max_col),
            s.warp_len, TO.stored_warp_len(s.block_start, s.b_r),
            lambda v, s=s: TR.sell_matvec_ref(
                s.val, s.col_idx, s.row_block, s.inv_perm, v, s.n_blocks)))
    return runs


def _check_k2_k6(runs, x):
    for label, d, kern, derived, full, plain in runs:
        y = kern(derived, x)
        _close(y.cpu(), plain(x).cpu())
        assert torch.equal(y, kern(derived, x)), label      # bit-repeatable
        assert torch.equal(y, kern(full, x)), label         # same bits
        for bad in (float("nan"), float("inf")):
            xb = x.clone()
            xb[0] = bad
            want = torch.isnan(plain(xb))
            assert bool(want.any()), label
            for n in (derived, full):
                assert torch.equal(torch.isnan(kern(n, xb)), want), label


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,idt", [(None, "int32"),
                                     (torch.bfloat16, "int16"),
                                     (None, "int16")])
@pytest.mark.parametrize("scale", [0.004, 0.006, 0.009])
def test_k2_k6_length_aware_walks_on_card(scale, tdt, idt):
    # 13.6k-30.6k rows: int16 indices fit, and sigma > n outgrows the
    # 48 KB slab, so K2's device-memory path runs too
    _need_cuda()
    m = TM.samg(scale=scale)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        m.n_rows).astype(np.float32)).cuda()
    runs = _k2_k6_runs(m, tdt, idt)
    for _, d, *_ in runs:
        assert str(d.col_idx.dtype) == f"torch.{idt}"
    assert [slab_fits(window_blocks(d.sigma, d.b_r, d.n_blocks), d.b_r)
            for _, d, *_ in runs[1:]] == [True, False]
    _check_k2_k6(runs, x)


@pytest.mark.cuda
@pytest.mark.parametrize("which,b_r,diag_align", [("strips", 128, 1),
                                                  ("strips", 128, 16),
                                                  ("trailing_zero", 32, 8)])
def test_k2_k6_edge_matrices_on_card(which, b_r, diag_align):
    # an empty strip (128 empty rows), a strip of exactly 128 non-zeros
    # (one whole tile row at diag_align 1), and rows ending in a stored
    # explicit 0 at column 0
    _need_cuda()
    if which == "strips":
        a = _strips_matrix()
        m = TF.csr_from_dense(a)
    else:
        m = _trailing_zero_matrix()
        a = _dense(m)
    runs = _k2_k6_runs(m, b_r=b_r, diag_align=diag_align,
                       chunk_l=diag_align)
    if which == "strips":
        assert runs[0][3].tolist()[:2] == [0, 128]
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        m.n_rows).astype(np.float32)).cuda()
    _check_k2_k6(runs, x)
    y64 = a @ x.cpu().double().numpy()
    for _, _, kern, derived, *_ in runs:
        _close(kern(derived, x).cpu()[: m.n_rows], y64)


@pytest.mark.cuda
def test_k2_k6_wrappers_validate_lengths_on_card():
    _need_cuda()
    m = TM.samg(scale=1e-3)
    x = torch.zeros(m.n_rows, device="cuda")
    for _, d, kern, derived, *_ in _k2_k6_runs(m):
        with pytest.raises(ValueError):
            kern(derived[:-1], x)                           # shape
        with pytest.raises(ValueError):
            kern(derived.cpu(), x)                          # device
        with pytest.raises(ValueError):
            kern(torch.stack([derived, derived], 1)[:, 0], x)   # strides
        with pytest.raises(TypeError):
            kern(derived.float(), x)                        # dtype


def _k1_runs(m, tdt=None, idt="auto", b_r=128, diag_align=8, chunk_l=16):
    """[(label, operand, kernel(lengths, x), derived lengths, full
    lengths, plain(x))] for K1, in the shape of ``_k2_k6_runs``."""
    p = TO.as_device(m, "pjds", dtype=tdt, index_dtype=idt, b_r=b_r,
                     diag_align=diag_align, chunk_l=chunk_l).dev
    return [("pjds", p,
             lambda n, v, p=p: pjds_matvec_kernel_call(
                 p.val, p.col_idx, p.block_start, n, v, n_blocks=p.n_blocks,
                 max_col=p.max_col),
             p.warp_len, TO.stored_warp_len(p.block_start, p.b_r),
             lambda v, p=p: TR.pjds_matvec_ref(p.val, p.col_idx, p.row_block,
                                               v, p.n_blocks))]


_ALL_POLICIES = [(None, "int32"), (torch.bfloat16, "int16"),
                 (None, "int16"), (torch.bfloat16, "int32")]


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,idt", _ALL_POLICIES)
@pytest.mark.parametrize("scale", [0.004, 0.009])
def test_k1_length_aware_walk_on_card(scale, tdt, idt):
    # K1 walking its derived per-warp lengths gives the bits of K1
    # walking every stored diagonal, and NaN / Inf in x[0] poisons the
    # same rows either way
    _need_cuda()
    m = TM.samg(scale=scale)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        m.n_rows).astype(np.float32)).cuda()
    runs = _k1_runs(m, tdt, idt)
    d = runs[0][1]
    assert str(d.col_idx.dtype) == f"torch.{idt}"
    assert d.val.dtype == (tdt or torch.float32)
    assert int(d.warp_len.sum()) < int(runs[0][4].sum())   # skips padding
    _check_k2_k6(runs, x)


@pytest.mark.cuda
@pytest.mark.parametrize("which,b_r,diag_align", [("edge", 32, 8),
                                                  ("edge", 64, 16),
                                                  ("strips", 128, 1),
                                                  ("trailing_zero", 32, 8)])
def test_k1_edge_matrices_on_card(which, b_r, diag_align):
    # empty rows, a block holding one long row, n not a multiple of b_r,
    # and rows ending in a stored explicit 0 at column 0
    _need_cuda()
    m = {"edge": _edge_matrix, "trailing_zero": _trailing_zero_matrix,
         "strips": lambda: TF.csr_from_dense(_strips_matrix())}[which]()
    runs = _k1_runs(m, b_r=b_r, diag_align=diag_align, chunk_l=diag_align)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        m.n_rows).astype(np.float32)).cuda()
    _check_k2_k6(runs, x)
    sd = TO.as_device(m, "pjds", b_r=b_r, diag_align=diag_align,
                      chunk_l=diag_align)
    _close(sd.matvec(x).cpu(), _dense(m) @ x.cpu().double().numpy())


@pytest.mark.cuda
def test_k1_wrapper_validates_lengths_on_card():
    _need_cuda()
    m = TM.samg(scale=1e-3)
    x = torch.zeros(m.n_rows, device="cuda")
    _, _, kern, derived, *_ = _k1_runs(m)[0]
    with pytest.raises(ValueError):
        kern(derived[:-1], x)                               # shape
    with pytest.raises(ValueError):
        kern(derived.cpu(), x)                              # device
    with pytest.raises(ValueError):
        kern(torch.stack([derived, derived], 1)[:, 0], x)   # strides
    with pytest.raises(TypeError):
        kern(derived.float(), x)                            # dtype


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,idt", _ALL_POLICIES)
@pytest.mark.parametrize("which", ["samg", "edge"])
def test_k4_matches_plain_and_keeps_nan_out_of_short_rows_on_card(which,
                                                                   tdt, idt):
    # K4 against its plain version, also with n_pad not a multiple of 32
    # (row_align 1), and a NaN in x[0] reaches only the rows that store
    # column 0: K4 reads no slot past rowlen
    _need_cuda()
    m = TM.samg(scale=0.004) if which == "samg" else _edge_matrix()
    e = TF.csr_to_ell(m, row_align=1 if which == "edge" else 128,
                      index_dtype=idt)
    d = TO.to_device_ell(e, dtype=tdt, device="cuda")
    assert str(d.col_idx.dtype) == f"torch.{idt}"
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        m.n_rows).astype(np.float32)).cuda()
    run = lambda v: ell_matvec_kernel_call(d.val, d.col_idx, d.rowlen, v,
                                           max_col=d.max_col)
    y = run(x)
    _close(y.cpu(), TR.ell_matvec_ref(d.val, d.col_idx, d.rowlen, x).cpu())
    assert torch.equal(y, run(x))                           # deterministic
    reads_col0 = torch.from_numpy(_dense(m)[:, 0] != 0)
    for bad in (float("nan"), float("inf")):
        xb = x.clone()
        xb[0] = bad
        got = ~torch.isfinite(run(xb)).cpu()[: m.n_rows]
        want = ~torch.isfinite(TR.ell_matvec_ref(
            d.val, d.col_idx, d.rowlen, xb)).cpu()[: m.n_rows]
        assert torch.equal(got, want)
        assert torch.equal(got, reads_col0)


def _k3_k5_operands(m, tdt=None, idt="auto", sigma=None, fmt="sell",
                    row_map=False):
    """K3 and K5 on one operand of ``m``: (operand, k3(lengths, x, w1, w2),
    k5(lengths, X), plain K5(X)); K5 with the operator's row map when
    ``row_map``, in the permuted basis otherwise."""
    sd = TO.as_device(m, fmt, sigma=sigma, dtype=tdt, index_dtype=idt)
    d = sd.dev
    rows = sd.row_map() if row_map else None

    def k3(n, v, w1, w2):
        return TFI.fused_spmv_dots_kernel_call(
            d.val, d.col_idx, d.block_start, d.inv_perm, n, v, w1, w2,
            n_blocks=d.n_blocks, sigma=d.sigma, max_col=d.max_col)

    def k5(n, xk):
        return pjds_matmat_kernel_call(
            d.val, d.col_idx, d.block_start, n, xk, n_blocks=d.n_blocks,
            max_col=d.max_col, out_row=rows, n_out=m.n_rows)

    def plain5(xk):
        y = TR.pjds_matmat_ref(d.val, d.col_idx, d.row_block, xk,
                               d.n_blocks)
        return y.index_select(0, sd.stored_rows()) if row_map else y

    return d, k3, k5, plain5


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,idt", _ALL_POLICIES)
@pytest.mark.parametrize("sigma", [None, 1 << 16])
def test_k3_y_is_k2_y_and_keeps_the_full_walks_bits_on_card(sigma, tdt,
                                                           idt):
    # K3 runs K2's window walk (or, for sigma > n, K2's device-memory
    # walk): its y is K2's y bit for bit; walking every stored diagonal
    # changes no bit of y or of the dots; NaN / Inf in x[0] poisons the
    # rows K2's and the plain version's poisons
    _need_cuda()
    m = TM.samg(scale=0.006)
    d, k3, _, _ = _k3_k5_operands(m, tdt, idt, sigma)
    assert str(d.col_idx.dtype) == f"torch.{idt}"
    assert slab_fits(window_blocks(d.sigma, d.b_r, d.n_blocks),
                     d.b_r) == (sigma is None)
    rng = np.random.default_rng(17)
    v = [torch.zeros(d.n_rows_pad, device="cuda") for _ in range(3)]
    for t in v:
        t[: m.n_rows] = torch.from_numpy(rng.standard_normal(
            m.n_rows).astype(np.float32))
    x, w1, w2 = v
    full = TO.stored_warp_len(d.block_start, d.b_r)
    assert int(d.warp_len.sum()) < int(full.sum())        # skips padding

    def k2(n, xv):
        return sell_matvec_kernel_call(d.val, d.col_idx, d.block_start,
                                       d.inv_perm, n, xv, n_blocks=d.n_blocks,
                                       sigma=d.sigma, max_col=d.max_col)

    y, dots = k3(d.warp_len, x, w1, w2)
    assert torch.equal(y, k2(d.warp_len, x))
    for n in (d.warp_len, full):                  # repeatable, same bits
        y_n, dots_n = k3(n, x, w1, w2)
        assert torch.equal(y, y_n) and torch.equal(dots, dots_n)
    y_r, d_r = TR.fused_matvec_dots_ref(d.val, d.col_idx, d.row_block,
                                        d.inv_perm, x, w1, w2, d.n_blocks)
    _close(y.cpu(), y_r.cpu())
    ny, n1, n2 = float(y_r.norm()), float(w1.norm()), float(w2.norm())
    _dots_close(dots.cpu().numpy(), d_r.cpu().numpy(),
                [ny * n1, ny * n2, ny * ny, n2 * n2, n1 * n2])
    for bad in (float("nan"), float("inf")):
        xb = x.clone()
        xb[0] = bad
        want = torch.isnan(TR.sell_matvec_ref(d.val, d.col_idx, d.row_block,
                                              d.inv_perm, xb, d.n_blocks))
        assert bool(want.any())
        assert torch.equal(torch.isnan(k2(d.warp_len, xb)), want)
        for n in (d.warp_len, full):
            assert torch.equal(torch.isnan(k3(n, xb, w1, w2)[0]), want)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,idt", _ALL_POLICIES)
@pytest.mark.parametrize("fmt,row_map", [("sell", False), ("sell", True),
                                         ("pjds", True)])
def test_k5_length_aware_walk_on_card(fmt, row_map, tdt, idt):
    # K5 walking its derived per-warp lengths gives the bits of K5
    # walking every stored diagonal, for every column count and both
    # stores, and a NaN / Inf in X[0, c] poisons the entries of column c
    # that the plain version's poisons, and no other column
    _need_cuda()
    m = TM.samg(scale=0.006)
    d, _, k5, plain = _k3_k5_operands(m, tdt, idt, fmt=fmt, row_map=row_map)
    assert str(d.col_idx.dtype) == f"torch.{idt}"
    assert d.val.dtype == (tdt or torch.float32)
    full = TO.stored_warp_len(d.block_start, d.b_r)
    assert int(d.warp_len.sum()) < int(full.sum())        # skips padding
    rng = np.random.default_rng(18)
    for k in (1, 3, 4, 6, 8, 12):       # 6: k > 4 without 16-byte loads
        xk = torch.from_numpy(rng.standard_normal((m.n_rows, k)).astype(
            np.float32)).cuda()
        y = k5(d.warp_len, xk)
        assert y.shape == (m.n_rows if row_map else d.n_rows_pad, k)
        _close(y.cpu(), plain(xk).cpu())
        assert torch.equal(y, k5(d.warp_len, xk))           # repeatable
        assert torch.equal(y, k5(full, xk))                 # same bits
        c = k // 2
        for bad in (float("nan"), float("inf")):
            xb = xk.clone()
            xb[0, c] = bad
            want = torch.isnan(plain(xb))
            assert bool(want[:, c].any())
            assert not bool(torch.cat([want[:, :c], want[:, c + 1:]],
                                      1).any())
            for n in (d.warp_len, full):
                assert torch.equal(torch.isnan(k5(n, xb)), want)


@pytest.mark.cuda
def test_k3_k5_wrappers_validate_lengths_on_card():
    _need_cuda()
    m = TM.samg(scale=1e-3)
    d, k3, k5, _ = _k3_k5_operands(m, row_map=True)
    v = torch.zeros(d.n_rows_pad, device="cuda")
    xk = torch.zeros((m.n_rows, 4), device="cuda")
    runs = [lambda n: k3(n, v, v, v), lambda n: k5(n, xk)]
    derived = d.warp_len
    for run in runs:
        with pytest.raises(ValueError):
            run(derived[:-1])                               # shape
        with pytest.raises(ValueError):
            run(derived.cpu())                              # device
        with pytest.raises(ValueError):
            run(torch.stack([derived, derived], 1)[:, 0])   # strides
        with pytest.raises(TypeError):
            run(derived.float())                            # dtype


# ----------------------------------------- K5's split walk (FFN weights)
def _ffn_operand(tdt, idt, b_r=128):
    """A pruned FFN weight (2048 inputs, 1536 outputs, density 0.1,
    Gaussian from seed 29) as ``SparseLinear`` stores it on the card:
    48 warps of ~210 diagonals, which ``split_plan`` splits."""
    from repro_torch.sparse.sparse_ffn import SparseLinear
    w = np.random.default_rng(29).standard_normal((2048, 1536)).astype(
        np.float32)
    sl = SparseLinear.from_dense(w, 0.1, b_r=b_r, dtype=tdt,
                                 index_dtype=idt, device="cuda")
    assert str(sl.a.col_idx.dtype) == f"torch.{idt}"
    return sl


def _k5_call(sl, xk, row_map, plan=None):
    d, sd = sl.a, sl.op.dev
    return pjds_matmat_kernel_call(
        d.val, d.col_idx, d.block_start, d.warp_len, xk,
        n_blocks=d.n_blocks, max_col=d.max_col,
        out_row=sd.row_map() if row_map else None,
        n_out=sl.op.shape[0] if row_map else 0, plan=plan)


def _k5_plain(sl, xk, row_map):
    d, sd = sl.a, sl.op.dev
    y = TR.pjds_matmat_ref(d.val, d.col_idx, d.row_block, xk, d.n_blocks)
    return y.index_select(0, sd.stored_rows()) if row_map else y


@pytest.mark.cuda
@pytest.mark.parametrize("row_map", [False, True])
@pytest.mark.parametrize("tdt,idt", [(None, "int32"), (None, "int16"),
                                     (torch.bfloat16, "int32"),
                                     (torch.bfloat16, "int16")])
def test_k5_split_walk_matches_plain_version_on_card(tdt, idt, row_map):
    from repro_torch.kernels import pjds_spmm as K5
    _need_cuda()
    sl = _ffn_operand(tdt, idt)
    d = sl.a
    rng = np.random.default_rng(31)
    for k in (1, 3, 4, 8, 12, 128):
        plan = K5.plan_for(d.val, d.n_blocks)
        assert plan.walk == "split" and plan.slices >= 2
        xk = torch.from_numpy(rng.standard_normal(
            (d.max_col + 1, k)).astype(np.float32)).cuda()
        before = (pjds_matmat_kernel_call.launches,
                  pjds_matmat_kernel_call.split_launches)
        y = _k5_call(sl, xk, row_map)
        assert (pjds_matmat_kernel_call.launches,
                pjds_matmat_kernel_call.split_launches) == (
                    before[0] + 1, before[1] + 1)
        _close(y.cpu(), _k5_plain(sl, xk, row_map).cpu())
        assert torch.equal(y, _k5_call(sl, xk, row_map))   # deterministic
    if row_map:        # the operator's own product takes the same walk
        xk = torch.from_numpy(rng.standard_normal(
            (sl.op.shape[1], 4)).astype(np.float32)).cuda()
        assert torch.equal(sl.op.matmat(xk), _k5_call(sl, xk, True))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_k5_split_walk_poisons_like_the_plain_version_on_card(bad):
    _need_cuda()
    sl = _ffn_operand(None, "int32")
    d = sl.a
    k, c = 8, 5
    xk = torch.from_numpy(np.random.default_rng(37).standard_normal(
        (d.max_col + 1, k)).astype(np.float32)).cuda()
    xk[0, c] = bad
    for row_map in (False, True):
        y, want = _k5_call(sl, xk, row_map), _k5_plain(sl, xk, row_map)
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(test(y), test(want))
        fin = torch.isfinite(y)
        assert not bool(fin[:, c].all())
        assert bool(torch.cat([fin[:, :c], fin[:, c + 1:]], 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b_r", [32, 128])
def test_k5_lane_and_split_plans_agree_on_one_operand_on_card(b_r):
    # either walk on the same operand: both within Y_TOL of the plain
    # version, the split walk at the plan's S and at others
    from repro_torch.kernels import pjds_spmm as K5
    _need_cuda()
    sl = _ffn_operand(None, "int16", b_r=b_r)
    d = sl.a
    rng = np.random.default_rng(41)
    for k in (4, 12):
        xk = torch.from_numpy(rng.standard_normal(
            (d.max_col + 1, k)).astype(np.float32)).cuda()
        want = _k5_plain(sl, xk, True).cpu()
        own = K5.plan_for(d.val, d.n_blocks)
        plans = [K5.LANE, own] + [K5.K5Plan("split", slices=s)
                                  for s in (1, 3, 16)]
        lane = split = 0
        for plan in plans:
            before = pjds_matmat_kernel_call.split_launches
            _close(_k5_call(sl, xk, True, plan).cpu(), want)
            split += pjds_matmat_kernel_call.split_launches - before
            lane += plan.walk == "lane"
        assert (lane, split) == (1, len(plans) - 1)
