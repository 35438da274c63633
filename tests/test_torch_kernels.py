"""K1-K3: the port's plain versions against the JAX package's Pallas
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
    with pytest.raises(ValueError, match="CUDA"):
        pjds_matvec_kernel_call(d.val, d.col_idx, d.block_start,
                                torch.from_numpy(_X), n_blocks=d.n_blocks,
                                max_col=d.max_col)


def test_to_device_rejects_unaligned_chunks():
    p = TF.csr_to_pjds(_TM, b_r=B_R, diag_align=8, permuted_cols=False)
    with pytest.raises(ValueError, match="chunk_l"):
        TO.to_device_pjds(p, chunk_l=16, device="cpu")


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
def test_kernel_wrappers_validate_operands_on_card():
    _need_cuda()
    d = TO.as_device(TM.samg(scale=1e-3), "pjds").dev
    x = torch.zeros(d.max_col, device="cuda")          # one entry short
    with pytest.raises(ValueError, match="column"):
        pjds_matvec_kernel_call(d.val, d.col_idx, d.block_start, x,
                                n_blocks=d.n_blocks, max_col=d.max_col)
    x = torch.zeros(d.max_col + 1, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        pjds_matvec_kernel_call(d.val, d.col_idx, d.block_start, x,
                                n_blocks=d.n_blocks, max_col=d.max_col)
