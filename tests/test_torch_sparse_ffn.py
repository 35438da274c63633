"""The port's sparse FFN (``repro_torch.sparse``) against the reference's
(``repro.sparse``) and the pruned dense product: the counterparts of
``tests/test_sparse_ffn.py``.

Same weights and inputs from numpy seeds on both sides, on the CPU.
Held: ``SparseLinear`` y within 1e-5 * max|y| of the pruned dense
product (float64) and of the reference's y; the ``format="auto"`` pick,
the density and the value-plus-index bytes equal; the value gradient
against dense autograd on the pruned weights within 1e-5 relative;
y bit for bit with and without the token pad.  Card tests (marked
``cuda``) run K5 and hold it to its plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import smoke
from repro_torch.models import ffn as TFF
from repro_torch.models.api import build_model
from repro_torch.sparse.sparse_ffn import (T_PAD, SparseLinear, prune,
                                          sparse_ffn_apply,
                                          sparsify_ffn_params)

Y_TOL = 1e-5


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.sparse import sparse_ffn as JS
    return jax, jnp, JS


def _close(got, want, tol=Y_TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _carried(jsl):
    """The port's SparseLinear of a reference one (same stored arrays)."""
    sd = jsl.op.dev
    d = sd.dev
    arrays = {f: np.asarray(getattr(d, f)) for f in vars(d)
              if hasattr(getattr(d, f), "shape")}
    statics = {f: getattr(d, f) for f in vars(d)
               if not hasattr(getattr(d, f), "shape")}
    return convert.sparse_linear(
        sd.fmt, sd.shape, arrays, statics, n_out=jsl.n_out,
        n_in_pad=jsl.n_in_pad, sigma=jsl.sigma, density=jsl.density,
        inv_perm=None if sd.inv_perm is None else np.asarray(sd.inv_perm),
        x_tiles=sd.x_tiles, device="cpu")


@pytest.mark.parametrize("fmt", ["auto", "sell", "pjds"])
@pytest.mark.parametrize("density", [0.05, 0.2, 0.5])
def test_sparse_linear_matches_pruned_dense_and_reference(density, fmt):
    jax, jnp, JS = _jax()
    w = _w((96, 160))
    x = _w((3, 5, 96), seed=1)
    sl = SparseLinear.from_dense(w, density, b_r=32, format=fmt,
                                 device="cpu")
    jsl = JS.SparseLinear.from_dense(w, density, b_r=32, format=fmt)
    y = sl(torch.from_numpy(x))
    assert y.shape == (3, 5, 160) and y.dtype == torch.float32
    _close(y.numpy(), x.astype(np.float64) @ prune(w, density), what="dense")
    y_ref = np.asarray(jsl(jnp.asarray(x), backend="ref"))
    _close(y.numpy(), y_ref, what="reference")
    # the reference's stored arrays, carried across, give the same y
    _close(_carried(jsl)(torch.from_numpy(x)).numpy(), y_ref,
           what="carried")
    assert (sl.fmt, sl.density, sl.n_out, sl.n_in_pad, sl.sigma) == \
        (jsl.fmt, jsl.density, jsl.n_out, jsl.n_in_pad, jsl.sigma)


@pytest.mark.parametrize("shape,density,sigma", [
    ((64, 96), 0.3, None), ((256, 512), 0.05, None), ((512, 300), 0.1, 64),
    ((100, 700), 0.7, 128), ((300, 64), 0.02, None)])
def test_auto_format_and_density_equal_reference(shape, density, sigma):
    _, _, JS = _jax()
    w = _w(shape, seed=shape[0])
    sl = SparseLinear.from_dense(w, density, b_r=32, sigma=sigma,
                                 device="cpu")
    jsl = JS.SparseLinear.from_dense(w, density, b_r=32, sigma=sigma)
    assert sl.fmt == jsl.fmt
    assert sl.density == jsl.density
    np.testing.assert_array_equal(sl.a.val.numpy(), np.asarray(jsl.a.val))
    np.testing.assert_array_equal(sl.a.col_idx.numpy(),
                                  np.asarray(jsl.a.col_idx))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("density", [0.05, 0.5])
def test_memory_summary_counts_what_the_port_stores(density, dtype):
    """The value-plus-index bytes are the reference's; the rest is the
    port's own metadata (the reference counts the TPU's chunk_map)."""
    jax, jnp, JS = _jax()
    w = _w((256, 512))
    sl = SparseLinear.from_dense(w, density, b_r=32, dtype=dtype,
                                 device="cpu")
    jsl = JS.SparseLinear.from_dense(
        w, density, b_r=32, dtype=None if dtype is None else jnp.bfloat16)
    ms, jms = sl.memory_summary(), jsl.memory_summary()
    a = jsl.a
    assert ms["value_index_bytes"] == int(a.val.size) * (
        a.val.dtype.itemsize + a.col_idx.dtype.itemsize)
    assert ms["dense_bytes"] == jms["dense_bytes"]
    sd = sl.op.dev
    meta = [sl.a.row_block, sl.a.block_start, sl.a.warp_len, sd.row_map()]
    meta.append(sl.a.inv_perm if sl.fmt == "sell" else sd.inv_perm)
    assert ms["metadata_bytes"] == sum(t.numel() * t.element_size()
                                       for t in meta)
    assert ms["pjds_bytes"] == ms["value_index_bytes"] + ms["metadata_bytes"]
    assert ms["ratio_vs_dense"] == ms["pjds_bytes"] / ms["dense_bytes"]


def test_memory_summary_shrinks_with_density():
    w = _w((256, 512))
    hi = SparseLinear.from_dense(w, 0.5, b_r=32, device="cpu")
    lo = SparseLinear.from_dense(w, 0.05, b_r=32, device="cpu")
    assert lo.memory_summary()["pjds_bytes"] < hi.memory_summary()[
        "pjds_bytes"]
    # at 5% density the stored footprint beats dense bf16
    assert lo.memory_summary()["ratio_vs_dense"] < 0.5


def test_padding_overhead_small_at_scale():
    """Paper: blocked padding stays small on rows of varying length."""
    sl = SparseLinear.from_dense(_w((512, 1024)), 0.1, b_r=32, device="cpu")
    assert sl.memory_summary()["padding_overhead"] < 0.10


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 7, 9])
def test_token_pad_keeps_every_bit(t):
    """T pads to a multiple of T_PAD (K5's 16-byte loads), not 128: y is
    the unpadded product's, bit for bit."""
    sl = SparseLinear.from_dense(_w((96, 160)), 0.2, b_r=32, device="cpu")
    x = torch.from_numpy(_w((t, 96), seed=t))
    y = sl(x)
    direct = sl.op.matmat(x.T.contiguous()).T
    assert torch.equal(y, direct)


def test_sparse_ffn_full_block_matches_dense_and_reference():
    """Density 1 keeps every weight: the sparse FFN is the dense one, and
    ``ffn_apply`` dispatches to it."""
    jax, jnp, JS = _jax()
    from repro import configs
    from repro.models import ffn as JFF
    cfg = smoke("qwen2.5-14b")
    jp, _ = JFF.ffn_init(jax.random.PRNGKey(0), configs.smoke("qwen2.5-14b"),
                         jnp.float32)
    tp = convert.param_tree(jax.device_get(jp), torch.device("cpu"))
    x = _w((2, 4, cfg.d_model), seed=3)
    dense = TFF.ffn_apply(tp, cfg, torch.from_numpy(x))
    _close(dense.numpy(), JFF.ffn_apply(jp, cfg, jnp.asarray(x)),
           what="dense ffn")
    sp = sparsify_ffn_params(tp, density=1.0, device="cpu")
    assert all(isinstance(m, SparseLinear) for m in sp.values())
    y = TFF.ffn_apply(sp, cfg, torch.from_numpy(x))
    _close(y.numpy(), dense.numpy(), what="sparse ffn")
    _close(sparse_ffn_apply(sp, cfg, torch.from_numpy(x)).numpy(),
           y.numpy(), 0.0, "sparse_ffn_apply")
    jsp = JS.sparsify_ffn_params(jp, density=1.0)
    _close(y.numpy(), JFF.ffn_apply(jsp, cfg, jnp.asarray(x)),
           what="reference sparse ffn")


@pytest.mark.parametrize("density", [0.1, 0.4])
def test_pruned_ffn_matches_dense_pruned(density):
    """At density < 1, the sparse FFN is the dense FFN over the pruned
    weights (gelu, ungated: starcoder2's)."""
    cfg = smoke("starcoder2-15b")
    p = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(4))["dec"][0]["mlp"]
    sp = sparsify_ffn_params(p, density, device="cpu")
    pruned = {k: {"w": torch.from_numpy(prune(v["w"].numpy(), density))}
              for k, v in p.items()}
    x = torch.from_numpy(_w((3, cfg.d_model), seed=5))
    _close(TFF.ffn_apply(sp, cfg, x).numpy(),
           TFF.ffn_apply(pruned, cfg, x).numpy(), what="pruned ffn")


@pytest.mark.parametrize("fmt", ["sell", "pjds"])
def test_value_gradient_matches_dense_autograd(fmt):
    """d<g, y>/d(values) through ``with_values``, against autograd on the
    dense pruned weight: for any direction dv over the stored slots,
    <grad, dv> == <dL/dW, D(dv)>, D(dv) the dense matrix the slots hold
    (padding slots included, as the product reads them)."""
    w = _w((64, 96))
    sl = SparseLinear.from_dense(w, 0.3, b_r=32, format=fmt, device="cpu")
    x = torch.from_numpy(_w((5, 64), seed=1))
    g = torch.from_numpy(_w((5, 96), seed=2))
    v = sl.values.clone().requires_grad_()
    (grad_v,) = torch.autograd.grad((sl.with_values(v)(x) * g).sum(), v)

    wp = torch.from_numpy(prune(w, 0.3)).requires_grad_()
    (grad_w,) = torch.autograd.grad(((x @ wp) * g).sum(), wp)
    rng = np.random.default_rng(3)
    for _ in range(3):
        dv = torch.from_numpy(rng.standard_normal(v.shape).astype(
            np.float32))
        d_dense = sl.with_values(dv)(torch.eye(64))
        lhs = float((grad_v.double() * dv.double()).sum())
        rhs = float((grad_w.double() * d_dense.double()).sum())
        assert abs(lhs - rhs) <= Y_TOL * max(abs(rhs), 1.0), (lhs, rhs)
    # and the pruned weights themselves: their gradient is x^T g there
    mask = torch.from_numpy(prune(w, 0.3) != 0)
    assert torch.allclose(grad_w[mask], (x.T @ g)[mask])


@pytest.mark.parametrize("seed", range(6))
def test_sparse_linear_property(seed):
    rng = np.random.default_rng(seed)
    density = float(rng.uniform(0.05, 0.9))
    w = rng.standard_normal((64, 96)).astype(np.float32)
    sl = SparseLinear.from_dense(w, density, b_r=32, device="cpu")
    x = rng.standard_normal((4, 64)).astype(np.float32)
    _close(sl(torch.from_numpy(x)).numpy(),
           x.astype(np.float64) @ prune(w, density), what=f"seed {seed}")


def test_entry_points_refuse_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparseLinear.from_dense(_w((32, 64)), 0.5, b_r=32)


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 6, 128])
def test_sparse_linear_on_card(t):
    """K5 behind ``SparseLinear`` on the card: launched, no plain call,
    within Y_TOL of the CPU plain version on the same stored arrays, and
    bit for bit with and without the token pad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.pjds_spmm import pjds_matmat_kernel_call as k5
    w = _w((512, 1024))
    x = _w((t, 512), seed=t)
    for fmt in ("sell", "pjds"):
        card = SparseLinear.from_dense(w, 0.1, format=fmt)
        host = SparseLinear.from_dense(w, 0.1, format=fmt, device="cpu")
        xc = torch.from_numpy(x).cuda()
        k5.launches = 0
        R.reset_calls()
        y = card(xc)
        torch.cuda.synchronize()
        assert k5.launches == 1
        assert not any(f.calls for f in R._COUNTED)
        _close(y.cpu().numpy(), host(torch.from_numpy(x)).numpy(),
               what=f"{fmt} card vs plain")
        assert torch.equal(y, card.op.matmat(xc.T.contiguous()).T)
        bf = card(xc.bfloat16())
        assert bf.dtype == torch.bfloat16


@pytest.mark.cuda
def test_sparse_ffn_on_card_matches_dense_pruned():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    cfg = smoke("qwen2.5-14b")
    p = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    mlp = p["dec"][0]["mlp"]
    sp = sparsify_ffn_params(mlp, 0.3)
    pruned = {k: {"w": torch.from_numpy(prune(
        v["w"].cpu().numpy(), 0.3)).cuda()} for k, v in mlp.items()}
    x = torch.from_numpy(_w((4, cfg.d_model))).cuda()
    _close(TFF.ffn_apply(sp, cfg, x).cpu().numpy(),
           TFF.ffn_apply(pruned, cfg, x).cpu().numpy(), 1e-4, "card ffn")
