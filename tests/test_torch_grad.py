"""Gradients through the port's operator against ``jax.grad`` /
``jax.jvp`` of the reference's: the x-gradient of ``<w, A x>`` (A^T w,
through the transposes), the gradient with respect to the stored values
(``op.with_values(v) @ x``), element by element over the whole value
array, padding slots included, for every format, 1-D and block x, with
a preprocessing permutation and with ``transpose="device"``; the
gradients of the transposed product; forward mode through
``torch.func.jvp``; and the distributed operator's x-gradient on four
ranks as threads.

The port's operands are carried across from the reference's
(``convert.sparse_device``), so both hold the same value array.
Tolerances: gradients within 1e-5 * max|g| element by element (f32, the
same stored values, the same gathers); the linearity identity
``<dL/dv, u> = L(u)`` within 1e-3 relative, as the reference's test
holds it; tangents within 1e-5 * max|t|.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.core.dist_comm import ThreadComm, run_ranks
from repro_torch.core.operator import DeviceOperator, dist_operator

FORMATS = ["csr", "ellpack_r", "sell", "pjds", "cmrs"]


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import formats as F
    from repro.core.operator import operator as joperator
    return jax, jnp, F, joperator


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(initial=0.0), 1e-30)
    assert np.abs(a - b).max(initial=0.0) <= tol * scale


def _matrix(F, seed=0, n=180):
    """A square matrix with skewed rows (padding in every format), an
    empty row and an empty column."""
    rng = np.random.default_rng(seed)
    rl = np.clip(rng.zipf(1.7, size=n), 1, n // 5)
    a = np.zeros((n, n), np.float32)
    for i in range(1, n):
        a[i, rng.integers(0, n, size=rl[i])] = rng.standard_normal(rl[i])
    a[:, 5] = 0.0
    return F.csr_from_dense(a)


def _carried(jsd):
    """The port's operand of the reference's ``SparseDevice`` (the same
    stored arrays)."""
    d = jsd.dev
    arrays = {f: np.asarray(getattr(d, f)) for f in vars(d)
              if hasattr(getattr(d, f), "shape")}
    statics = {f: getattr(d, f) for f in vars(d)
               if not hasattr(getattr(d, f), "shape")}
    pre = {}
    if getattr(jsd, "pre_perm", None) is not None:
        pre = dict(pre_perm=np.asarray(jsd.pre_perm),
                   pre_inv=np.asarray(jsd.pre_inv))
    return convert.sparse_device(
        jsd.fmt, jsd.shape, arrays, statics,
        inv_perm=None if jsd.inv_perm is None else np.asarray(jsd.inv_perm),
        x_tiles=jsd.x_tiles, device="cpu", **pre)


def _pair(fmt, **kw):
    jax, jnp, F, joperator = _jax()
    jo = joperator(_matrix(F), fmt, b_r=32, **kw)
    return DeviceOperator(_carried(jo.dev)), jo


def _vecs(n, k=None, seed=1):
    rng = np.random.default_rng(seed)
    shape = (n,) if k is None else (n, k)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("fmt", FORMATS)
def test_grads_match_jax_grad(fmt, k):
    jax, jnp, _, _ = _jax()
    op, jo = _pair(fmt)
    assert np.array_equal(op.values.numpy(), np.asarray(jo.values))
    x, w = _vecs(op.shape[0], k)
    v = op.values.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    loss = (torch.from_numpy(w) * (op.with_values(v) @ xt)).sum()
    gv, gx = torch.autograd.grad(loss, (v, xt))

    def jloss(vv, xx):
        return jnp.sum(jnp.asarray(w) * (jo.with_values(vv) @ xx))

    jgv, jgx = jax.grad(jloss, argnums=(0, 1))(jo.values, jnp.asarray(x))
    assert gv.shape == v.shape and gv.dtype == v.dtype
    _close(gx.numpy(), np.asarray(jgx))
    _close(gv.numpy(), np.asarray(jgv))
    # the x-gradient is A^T w, through the same transpose
    _close(gx.numpy(), op.rmatmat(torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("fmt", FORMATS)
def test_transposed_product_grads_match_jax_grad(fmt):
    jax, jnp, _, _ = _jax()
    op, jo = _pair(fmt)
    y, w = _vecs(op.shape[0], seed=2)
    v = op.values.clone().requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    loss = (torch.from_numpy(w) * (op.with_values(v).T @ yt)).sum()
    gv, gy = torch.autograd.grad(loss, (v, yt))
    jgv, jgy = jax.grad(
        lambda vv, yy: jnp.sum(jnp.asarray(w) * (jo.with_values(vv).T @ yy)),
        argnums=(0, 1))(jo.values, jnp.asarray(y))
    _close(gy.numpy(), np.asarray(jgy))
    _close(gv.numpy(), np.asarray(jgv))


@pytest.mark.parametrize("fmt", ["sell", "pjds", "cmrs", "ellpack_r"])
def test_value_gradient_of_padding_slots(fmt):
    """A padded slot of a real row holds column 0, so its value gradient
    is ``w[row] * x[0]`` (the reference's rule), not 0; with x[0] == 0
    every padded slot's gradient vanishes."""
    jax, jnp, _, _ = _jax()
    op, jo = _pair(fmt)
    x, w = _vecs(op.shape[0], seed=3)
    for x0 in (x[0], 0.0):
        x[0] = x0
        v = op.values.clone().requires_grad_()
        (gv,) = torch.autograd.grad(
            (torch.from_numpy(w) * (op.with_values(v) @ torch.from_numpy(
                x))).sum(), v)
        jgv = jax.grad(lambda vv: jnp.vdot(
            jnp.asarray(w), jo.with_values(vv) @ jnp.asarray(x)))(jo.values)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(jgv))


def test_linearity_identity():
    """L(v) = <w, A(v) x> is linear in v, so <dL/dv, u> = L(u)."""
    op, _ = _pair("sell")
    x, w = _vecs(op.shape[0], seed=4)
    v = op.values.clone().requires_grad_()
    (gv,) = torch.autograd.grad(
        (torch.from_numpy(w) * (op.with_values(v) @ torch.from_numpy(
            x))).sum(), v)
    u = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(v.shape)).astype(np.float32))
    want = float((torch.from_numpy(w) * (op.with_values(u) @ torch.from_numpy(
        x))).sum())
    got = float((gv * u).sum())
    assert abs(got - want) <= 1e-3 * max(abs(want), 1.0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_jvp_matches_jax_jvp(fmt):
    jax, jnp, _, _ = _jax()
    op, jo = _pair(fmt)
    x, dx = _vecs(op.shape[0], seed=6)
    dv = np.random.default_rng(7).standard_normal(
        tuple(op.values.shape)).astype(np.float32)
    y, t = torch.func.jvp(lambda vv, xx: op.with_values(vv) @ xx,
                          (op.values, torch.from_numpy(x)),
                          (torch.from_numpy(dv), torch.from_numpy(dx)))
    jy, jt = jax.jvp(lambda vv, xx: jo.with_values(vv) @ xx,
                     (jo.values, jnp.asarray(x)),
                     (jnp.asarray(dv), jnp.asarray(dx)))
    _close(y.numpy(), np.asarray(jy))
    _close(t.numpy(), np.asarray(jt))
    # x alone: the tangent is A x'
    _, tx = torch.func.jvp(lambda xx: op @ xx, (torch.from_numpy(x),),
                           (torch.from_numpy(dx),))
    _close(tx.numpy(), (op @ torch.from_numpy(dx)).numpy())


def test_grads_with_reorder_and_transpose_device():
    """A preprocessing permutation (the stored values are B's) and a
    transposed operand (``t_dev`` serves the x-gradient) give the
    reference's gradients."""
    jax, jnp, F, joperator = _jax()
    for kw in (dict(reorder="rcm"), dict(transpose="device")):
        jo = joperator(_matrix(F), "sell", b_r=32, **kw)
        tm = _matrix(TF)
        op = repro_torch.operator(tm, "sell", b_r=32, device="cpu", **kw)
        if "reorder" in kw:
            assert op.dev.pre_perm is not None
            op = DeviceOperator(_carried(jo.dev))
        else:
            assert op.t_dev is not None
        x, w = _vecs(op.shape[0], seed=8)
        xt = torch.from_numpy(x).requires_grad_()
        v = op.values.clone().requires_grad_()
        loss = (torch.from_numpy(w) * (op.with_values(v) @ xt)).sum()
        gv, gx = torch.autograd.grad(loss, (v, xt))
        jgv, jgx = jax.grad(lambda vv, xx: jnp.vdot(
            jnp.asarray(w), jo.with_values(vv) @ xx), argnums=(0, 1))(
            jo.values, jnp.asarray(x))
        _close(gx.numpy(), np.asarray(jgx))
        if "reorder" in kw:
            _close(gv.numpy(), np.asarray(jgv))
        # through t_dev: the x-gradient of op @ x is t_dev's product
        (gx2,) = torch.autograd.grad(
            (torch.from_numpy(w) * (op @ xt)).sum(), xt)
        _close(gx2.numpy(), np.asarray(jgx))


def test_second_order_through_the_operator():
    """d/dx of <A^T A x, x>/2 is A^T A x; the backward runs the
    products again, so a gradient of a gradient works."""
    tm = _matrix(TF)
    op = repro_torch.operator(tm, "pjds", b_r=32, device="cpu")
    x = torch.from_numpy(_vecs(tm.n_rows, seed=9)[0]).requires_grad_()
    (g,) = torch.autograd.grad(0.5 * ((op @ x) ** 2).sum(), x,
                               create_graph=True)
    _close(g.detach().numpy(), (op.T @ (op @ x.detach())).numpy())
    (h,) = torch.autograd.grad(g.sum(), x)
    _close(h.numpy(), (op.T @ (op @ torch.ones_like(x))).numpy())


def test_no_grad_keeps_the_plain_path():
    op, _ = _pair("sell")
    x = torch.ones(op.shape[0], requires_grad=True)
    with torch.no_grad():
        y = op @ x
    assert y.grad_fn is None
    assert (op @ x).grad_fn is not None


@pytest.mark.parametrize("fmt", ["sell", "pjds", "cmrs", "ellpack_r"])
def test_kernels_never_see_a_functorch_wrapper(fmt, monkeypatch):
    """On the card a kernel reads ``data_ptr()``, which a ``torch.func``
    wrapper does not have.  With the kernel path taken on the CPU (the
    wrappers swapped for their plain versions, which check every tensor
    argument), ``torch.func.jvp`` and ``torch.autograd.grad`` hand the
    kernels plain tensors only, and give the plain path's results."""
    from repro_torch.kernels import ops as TO
    from repro_torch.kernels import ref as TR

    def plain(fn):
        def call(*args, **kw):
            for t in list(args) + list(kw.values()):
                if isinstance(t, torch.Tensor):
                    assert not torch._C._functorch.is_functorch_wrapped_tensor(
                        t), "a kernel was handed a functorch wrapper"
            return fn(*args, **kw)
        return call

    def rb(bs, nb):
        return torch.repeat_interleave(torch.arange(nb, dtype=torch.int32),
                                       (bs[1:] - bs[:-1]).long())

    monkeypatch.setattr(TO, "pjds_matvec_kernel_call", plain(
        lambda val, col, bs, wl, x, *, n_blocks, max_col:
        TR.pjds_matvec_ref(val, col, rb(bs, n_blocks), x, n_blocks)))
    monkeypatch.setattr(TO, "sell_matvec_kernel_call", plain(
        lambda val, col, bs, inv, wl, x, *, n_blocks, sigma, max_col:
        TR.sell_matvec_ref(val, col, rb(bs, n_blocks), inv, x, n_blocks)))
    monkeypatch.setattr(TO, "ell_matvec_kernel_call", plain(
        lambda val, col, rowlen, x, *, max_col:
        TR.ell_matvec_ref(val, col, rowlen, x)))
    monkeypatch.setattr(TO, "cmrs_matvec_kernel_call", plain(
        lambda val, col, ris, ss, snnz, x, *, n_strips, max_col:
        TR.cmrs_matvec_ref(val, col, ris, rb(ss, n_strips), x, n_strips)))

    def k7(val, slot, colptr, y, *, width, n_rows, rows=None, plan=None,
           longest=None):
        p = slot.long()
        r = rows.long() if rows is not None else p % width
        ok = (r >= 0) & (r < n_rows)           # y reads 0 past its rows
        cols = torch.repeat_interleave(torch.arange(colptr.numel() - 1),
                                       (colptr[1:] - colptr[:-1]).long())
        z = torch.zeros(colptr.numel() - 1)
        return z.index_add_(0, cols, val.reshape(-1)[p]
                            * torch.where(ok, y[torch.where(ok, r, 0)], 0))

    monkeypatch.setattr(TO, "transpose_matvec_kernel_call", plain(k7))
    op, _ = _pair(fmt)
    x, dx = _vecs(op.shape[0], seed=12)
    dv = torch.from_numpy(np.random.default_rng(13).standard_normal(
        tuple(op.values.shape)).astype(np.float32))
    xt, dxt = torch.from_numpy(x), torch.from_numpy(dx)
    want = torch.func.jvp(lambda vv, xx: op.with_values(vv) @ xx,
                          (op.values, xt), (dv, dxt))
    monkeypatch.setattr(TO, "resolve_backend",
                        lambda t, backend="auto": "kernel")
    got = torch.func.jvp(lambda vv, xx: op.with_values(vv) @ xx,
                         (op.values, xt), (dv, dxt))
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy())
    v = op.values.clone().requires_grad_()
    xg = xt.clone().requires_grad_()
    gv, gx = torch.autograd.grad((op.with_values(v) @ xg).sum(), (v, xg))
    _close(gx.numpy(), (op.T @ torch.ones(op.shape[0])).numpy())


# ------------------------------------------------------- distributed
def _dist_case():
    return TM.samg(scale=1e-4)


@pytest.mark.parametrize("grid", [None, (2, 2)])
def test_dist_x_gradient_matches_single_device(grid):
    """Four ranks as threads: each rank's x-gradient of <w, A x> is its
    slice of A^T w, through the transpose partition; gathered it equals
    the single-device operator's x-gradient."""
    m = _dist_case()
    x, w = _vecs(m.n_rows, seed=10)
    op1 = repro_torch.operator(m, "sell", device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    (want,) = torch.autograd.grad((torch.from_numpy(w) * (op1 @ xt)).sum(),
                                  xt)
    comms = ThreadComm.create(4, "cpu")

    def body(c):
        op = dist_operator(m, c, grid=grid, b_r=32, device="cpu")
        xl = op.shard_vector(x).requires_grad_()
        wl = op.shard_vector(w)
        (g,) = torch.autograd.grad((wl * (op @ xl)).sum(), xl)
        assert torch.equal(g, op.rmatvec(wl))
        # and through the transposed product: A w
        yl = op.shard_vector(x).requires_grad_()
        (gt,) = torch.autograd.grad((wl * (op.T @ yl)).sum(), yl)
        return op.gather_vector(g), op.gather_vector(gt)

    outs = run_ranks(comms, body)
    for g, gt in outs:
        _close(g[: m.n_rows].numpy(), want.numpy())
        _close(gt[: m.n_rows].numpy(), (op1 @ torch.from_numpy(w)).numpy())


def test_dist_gradient_needs_the_transpose_partition():
    m = _dist_case()
    comms = ThreadComm.create(2, "cpu")

    def body(c):
        op = dist_operator(m, c, b_r=32, transpose=None, device="cpu")
        xl = op.shard_vector(np.ones(m.n_rows, np.float32))
        y = op @ xl                              # no gradient: runs
        with pytest.raises(ValueError, match="transpose"):
            op @ xl.requires_grad_()
        return y

    run_ranks(comms, body)


# ------------------------------------------------------------ the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["sell", "pjds", "cmrs", "ellpack_r"])
def test_grads_on_card(fmt):
    """On the card the x-gradient is K7's A^T w bit for bit, the value
    gradient equals the CPU's, and no plain version runs."""
    _need_cuda()
    from repro_torch.kernels import ref as TR
    from repro_torch.kernels.transpose_spmv import \
        transpose_matvec_kernel_call as k7
    m = TM.samg(scale=0.002)
    op = repro_torch.operator(m, fmt)
    cpu = repro_torch.operator(m, fmt, device="cpu")
    x, w = _vecs(m.n_rows, seed=11)
    wt = torch.from_numpy(w).cuda()
    xt = torch.from_numpy(x).cuda().requires_grad_()
    v = op.values.clone().requires_grad_()
    TR.reset_calls()
    k7.launches = 0
    gv, gx = torch.autograd.grad((wt * (op.with_values(v) @ xt)).sum(),
                                 (v, xt))
    assert k7.launches == 1
    assert not any(f.calls for f in TR._COUNTED)
    assert torch.equal(gx, op.with_values(v.detach()).T @ wt)
    vc = cpu.values.clone().requires_grad_()
    (gvc,) = torch.autograd.grad(
        (torch.from_numpy(w) * (cpu.with_values(vc) @ torch.from_numpy(
            x))).sum(), vc)
    _close(gv.cpu().numpy(), gvc.numpy())
