"""Transposes of the single-device operator against the reference's:
``op.T @ y``, ``op.rmatvec``, ``op.rmatmat``, ``operator(m,
transpose="device")`` and the plain scatter versions, for every format;
K7's slot index and walk (emulated in numpy from the index, as the CUDA
kernel walks it) against the plain versions; and, on a card, K7 itself.

Inputs come from numpy seeds and go to both packages.  Tolerance: z
within 1e-5 * max|z| (f32 accumulation on both sides, the same stored
values); on integer-valued data, and between the port's plain versions
and the reference's (both add in ascending slot order), exact.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.core.operator import TransposeOperator
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

FORMATS = ["csr", "ellpack_r", "sell", "pjds", "cmrs"]
BLOCKED = ["ellpack_r", "sell", "pjds", "cmrs"]


def _jax():
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import formats as F
    from repro.core.operator import operator as joperator
    from repro.kernels import ref as JR
    return jnp, F, joperator, JR


def _close(z, z_ref, tol=1e-5):
    z, z_ref = np.asarray(z, np.float64), np.asarray(z_ref, np.float64)
    assert z.shape == z_ref.shape
    scale = max(np.abs(z_ref).max(initial=0.0), 1e-30)
    assert np.abs(z - z_ref).max(initial=0.0) <= tol * scale


def _dense(rows, cols, seed, density=0.08, integer=False):
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((rows, cols)) < density,
                 rng.integers(-4, 5, (rows, cols)) if integer
                 else rng.standard_normal((rows, cols)), 0.0)
    a[0, :] = 0.0                     # an empty row
    a[:, 3] = 0.0                     # an empty column
    return a.astype(np.float32)


_MATS = {
    "samg": lambda F: F.csr_from_coo(*_coo(TM.samg(scale=1e-4))),
    "zipf": lambda F: F.csr_from_dense(_zipf()),
    "rect": lambda F: F.csr_from_dense(_dense(150, 210, 3)),
    "int": lambda F: F.csr_from_dense(_dense(300, 300, 4, 0.05, True)),
}


def _coo(m):
    rows = np.repeat(np.arange(m.n_rows), m.row_lengths())
    return rows, m.indices, m.data, m.shape


def _zipf(n=160, seed=0):
    rng = np.random.default_rng(seed)
    rl = np.clip(rng.zipf(1.8, size=n), 1, n // 4)
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, rng.integers(0, n, size=rl[i])] = rng.standard_normal(rl[i])
    return a


def _pair(name):
    _, F, _, _ = _jax()
    return _MATS[name](TF), _MATS[name](F)


def _build(tm, fmt, **kw):
    return repro_torch.operator(tm, fmt, b_r=32, device="cpu", **kw)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(_MATS))
def test_transpose_matches_reference(name, fmt):
    jnp, F, joperator, _ = _jax()
    tm, jm = _pair(name)
    op, jo = _build(tm, fmt), joperator(jm, fmt, b_r=32)
    rng = np.random.default_rng(7)
    y = rng.standard_normal(tm.shape[0]).astype(np.float32)
    Y = rng.standard_normal((tm.shape[0], 3)).astype(np.float32)
    if name == "int":
        y = np.rint(y * 2).astype(np.float32)
        Y = np.rint(Y * 2).astype(np.float32)
    z = op.T @ torch.from_numpy(y)
    zj = np.asarray(jo.T @ jnp.asarray(y))
    assert tuple(z.shape) == (tm.shape[1],)
    # the same stored values, added in the same ascending slot order
    np.testing.assert_array_equal(z.numpy(), zj)
    np.testing.assert_array_equal(
        op.rmatvec(torch.from_numpy(y)).numpy(), zj)
    Z = op.rmatmat(torch.from_numpy(Y))
    _close(Z.numpy(), np.asarray(jo.rmatmat(jnp.asarray(Y))))
    _close(Z.numpy(), np.asarray(jo.T @ jnp.asarray(Y)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_transpose_device_matches_reference(fmt):
    """``transpose="device"`` converts A^T with the same keywords; its
    forward product serves ``op.T``."""
    jnp, _, joperator, _ = _jax()
    tm, jm = _pair("rect")
    op = _build(tm, fmt, transpose="device")
    jo = joperator(jm, fmt, b_r=32, transpose="device")
    assert op.t_dev is not None and op.t_dev.shape == (210, 150)
    assert op.t_dev.fmt == jo.t_dev.fmt
    y = np.random.default_rng(8).standard_normal(150).astype(np.float32)
    _close((op.T @ torch.from_numpy(y)).numpy(),
           np.asarray(jo.T @ jnp.asarray(y)))
    Y = np.random.default_rng(9).standard_normal((150, 2)).astype(np.float32)
    _close(op.rmatmat(torch.from_numpy(Y)).numpy(),
           np.asarray(jo.rmatmat(jnp.asarray(Y))))
    # the forward product is unchanged by the second operand
    x = np.random.default_rng(10).standard_normal(210).astype(np.float32)
    _close((op @ torch.from_numpy(x)).numpy(),
           np.asarray(jo @ jnp.asarray(x)))


def test_transpose_device_needs_the_host_matrix():
    tm, _ = _pair("zipf")
    sd = TO.as_device(tm, "sell", b_r=32, device="cpu")
    with pytest.raises(ValueError, match="host matrix"):
        repro_torch.operator(sd, transpose="device")
    with pytest.raises(ValueError, match="transpose"):
        repro_torch.operator(tm, "sell", transpose="bogus", device="cpu")


def test_transpose_view_protocol():
    tm, _ = _pair("rect")
    op = _build(tm, "sell")
    t = op.T
    assert isinstance(t, TransposeOperator)
    assert t is op.T and t.T is op
    assert t.shape == (210, 150) and t.dtype == op.dtype
    assert t.device == op.device
    sq = _build(_pair("zipf")[0], "pjds")
    np.testing.assert_array_equal(sq.T.diagonal().numpy(),
                                  sq.diagonal().numpy())
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        150).astype(np.float32))
    assert torch.equal(t.matvec(y), op.rmatvec(y))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        210).astype(np.float32))
    assert torch.equal(t.rmatvec(x), op @ x)
    with pytest.raises(ValueError, match="entries"):
        op.rmatvec(torch.zeros(149))


@pytest.mark.parametrize("fmt", ["sell", "pjds", "cmrs"])
def test_bicgstab_dual_system_via_transpose_view(fmt):
    """The reference's dual-system test: ``repro_torch.solve(op.T, c)``
    solves A^T y = c through the transposes (composed BiCGStab), and
    agrees with the reference's solve on op.T."""
    jnp, F, joperator, _ = _jax()
    from repro.core import matrices as M
    from repro.core import solvers as S
    tm, jm = TM.convection_poisson(32, 32), M.convection_poisson(32, 32)
    a = np.zeros(tm.shape)
    rows = np.repeat(np.arange(tm.n_rows), tm.row_lengths())
    a[rows, tm.indices] = tm.data
    c = np.random.default_rng(0).standard_normal(tm.n_rows).astype(
        np.float32)
    op = repro_torch.operator(tm, fmt, b_r=32, device="cpu")
    res = repro_torch.solve(op.T, c, method="bicgstab", tol=1e-6,
                            maxiter=2000, fallback="off")
    assert res.status == "converged" and res.info["strategy"] == "composed"
    y = res.x.double().numpy()
    assert np.linalg.norm(a.T @ y - c) / np.linalg.norm(c) < 1e-5
    rj = S.bicgstab(joperator(jm, fmt, b_r=32).T, jnp.asarray(c),
                    maxiter=2000, tol=1e-6)
    assert abs(res.iters - int(rj.iters)) <= 2
    _close(res.x.numpy(), np.asarray(rj.x), tol=1e-4)


@pytest.mark.parametrize("k", [None, 2])
def test_plain_versions_match_reference_refs(k):
    """The four plain scatter versions on the reference's own device
    containers (carried across with ``convert``), bit for bit."""
    jnp, F, _, JR = _jax()
    from repro.kernels import ops as jops
    tm, jm = _pair("samg")
    rng = np.random.default_rng(11)
    for fmt in FORMATS:
        jsd = jops.as_device(jm, fmt, b_r=32)
        d = jsd.dev
        n_rows = d.val.shape[1] if fmt == "ellpack_r" else (
            d.n_strips * d.val.shape[1] if fmt == "cmrs" else
            d.n_blocks * d.val.shape[1] if fmt in ("sell", "pjds")
            else jm.n_rows)
        shape = (n_rows,) if k is None else (n_rows, k)
        y = rng.standard_normal(shape).astype(np.float32)
        yt, yj = torch.from_numpy(y), jnp.asarray(y)
        arr = lambda name: torch.from_numpy(np.asarray(getattr(d, name)))
        n = jm.shape[1]
        if fmt == "csr":
            got = TR.csr_rmatvec_ref(arr("data"), arr("indices"),
                                     arr("row_ids"), yt, n)
            want = JR.csr_rmatvec_ref(d.data, d.indices, d.row_ids, yj, n)
        elif fmt == "ellpack_r":
            got = TR.ell_rmatvec_ref(arr("val"), arr("col_idx"),
                                     arr("rowlen"), yt, n)
            want = JR.ell_rmatvec_ref(d.val, d.col_idx, d.rowlen, yj, n)
        elif fmt == "cmrs":
            got = TR.cmrs_rmatvec_ref(arr("val"), arr("col_idx"),
                                      arr("row_in_strip"), arr("strip_map"),
                                      yt, n)
            want = JR.cmrs_rmatvec_ref(d.val, d.col_idx, d.row_in_strip,
                                       d.strip_map, yj, n)
        else:
            got = TR.blocked_rmatvec_ref(arr("val"), arr("col_idx"),
                                         arr("row_block"), yt, n)
            want = JR.blocked_rmatvec_ref(d.val, d.col_idx, d.row_block, yj,
                                          n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=fmt)


# ------------------------------------------------- K7's index and walk
def _k7_emulate(sd, y):
    """K7's walk in numpy, from the slot index and the row formula of
    ``csrc/transpose_spmv.cu``: each column adds ``val[slot] *
    y[row(slot)]`` over its slots in index order, in float32."""
    d = sd.dev
    slot, colptr = (t.numpy() for t in sd.slot_index())
    val = d.val.float().numpy().reshape(-1)
    width = d.val.shape[1]
    if sd.fmt == "ellpack_r":
        base, ris = None, None
    elif sd.fmt == "cmrs":
        base, ris = d.strip_map.numpy(), d.row_in_strip.numpy().reshape(-1)
    else:
        base, ris = d.row_block.numpy(), None
    yk = y.reshape(y.shape[0], -1)
    z = np.zeros((colptr.shape[0] - 1, yk.shape[1]), np.float32)
    for c in range(z.shape[0]):
        acc = np.zeros(yk.shape[1], np.float32)
        for s in range(colptr[c], colptr[c + 1]):
            p = int(slot[s])
            r = (int(base[p // width]) * width if base is not None else 0) \
                + (int(ris[p]) if ris is not None else p % width)
            acc = (acc + np.float32(val[p]) * yk[r]).astype(np.float32)
        z[c] = acc
    return z.reshape((z.shape[0],) + y.shape[1:])


def _stored_y(sd, y):
    """y (original rows) in the basis the stored rows index: scattered
    to the sorted positions (pJDS / SELL) or padded."""
    yt = torch.from_numpy(y)
    if sd.fmt in ("sell", "pjds"):
        return sd._scatter_to_storage(yt, sd.dev.n_rows_pad).numpy()
    return sd._pad_rows(yt, sd.dev.n_rows_pad).numpy()


@pytest.mark.parametrize("fmt", BLOCKED)
@pytest.mark.parametrize("name", ["zipf", "rect", "int"])
def test_slot_index_walk_equals_plain_version(name, fmt):
    """The slot index covers exactly the slots that hold more than
    padding, sorted by column then position, and the walk K7 makes
    over it gives the plain version's z bit for bit."""
    tm, _ = _pair(name)
    sd = _build(tm, fmt).dev
    slot, colptr = sd.slot_index()
    assert slot.dtype == colptr.dtype == torch.int32
    assert colptr.shape == (tm.shape[1] + 1,) and int(colptr[0]) == 0
    assert int(colptr[-1]) == slot.numel() == tm.nnz
    cols = sd.dev.col_idx.reshape(-1).long()[slot.long()]
    counts = np.diff(colptr.numpy())
    np.testing.assert_array_equal(counts, np.bincount(
        tm.indices, minlength=tm.shape[1]))
    key = cols * slot.numel() * 64 + slot.long()
    assert bool((key[1:] > key[:-1]).all())          # column, then slot
    assert sd.slot_index() is sd.slot_index()          # built once
    rng = np.random.default_rng(12)
    for shape in ((tm.shape[0],), (tm.shape[0], 3)):
        y = rng.standard_normal(shape).astype(np.float32)
        want = sd.rmatmat(torch.from_numpy(y))
        got = _k7_emulate(sd, _stored_y(sd, y))
        np.testing.assert_array_equal(got, want.numpy())


def test_slot_index_of_an_empty_column_and_an_empty_matrix():
    a = np.zeros((64, 64), np.float32)
    a[5, 7] = 2.0
    a[9, 7] = -1.0
    sd = repro_torch.operator(TF.csr_from_dense(a), "pjds", b_r=32,
                              device="cpu").dev
    slot, colptr = sd.slot_index()
    assert slot.numel() == 2
    c = np.diff(colptr.numpy())
    assert c[7] == 2 and c.sum() == 2
    y = np.arange(64, dtype=np.float32)
    np.testing.assert_array_equal(_k7_emulate(sd, _stored_y(sd, y)),
                                  sd.rmatvec(torch.from_numpy(y)).numpy())
    with pytest.raises(ValueError, match="slot index"):
        repro_torch.operator(TF.csr_from_dense(a), "csr",
                             device="cpu").dev.slot_index()


def test_with_values_rebuilds_walks_and_slot_index():
    """A slot that was padding may hold a value after ``with_values``:
    the walk lengths and the slot index are derived again, so the
    product and the transpose read it, as the reference's do."""
    jnp, F, joperator, _ = _jax()
    tm, jm = _pair("zipf")
    for fmt in ("sell", "pjds", "cmrs"):
        op = _build(tm, fmt)
        jo = joperator(jm, fmt, b_r=32)
        v = np.random.default_rng(13).standard_normal(
            tuple(op.values.shape)).astype(np.float32)
        op2 = op.with_values(torch.from_numpy(v))
        jo2 = jo.with_values(jnp.asarray(v))
        x = np.random.default_rng(14).standard_normal(160).astype(np.float32)
        _close((op2 @ torch.from_numpy(x)).numpy(),
               np.asarray(jo2 @ jnp.asarray(x)))
        _close((op2.T @ torch.from_numpy(x)).numpy(),
               np.asarray(jo2.T @ jnp.asarray(x)))
        assert op2.dev.slot_index()[0].numel() > op.dev.slot_index()[0].numel()
        with pytest.raises(ValueError, match="values"):
            op.with_values(torch.zeros(3))


# ------------------------------------------------------------ the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K7 has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("fmt", BLOCKED)
def test_k7_matches_plain_version_on_card(fmt, dtype):
    """K7 against its plain version on the same card operand (the CPU
    copy of the plain version: both add in slot order, so bit for bit),
    1-D and k = 3, repeated bit for bit, with no plain call on the way."""
    _need_cuda()
    from repro_torch.kernels.transpose_spmv import \
        transpose_matvec_kernel_call as k7
    tm = TM.samg(scale=0.003)
    op = repro_torch.operator(tm, fmt, dtype=dtype)
    rng = np.random.default_rng(15)
    for shape in ((tm.n_rows,), (tm.n_rows, 3)):
        y = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
        TR.reset_calls()
        k7.launches = 0
        z = op.T @ y
        assert k7.launches == 1
        assert not any(f.calls for f in TR._COUNTED)
        assert torch.equal(z, op.T @ y)
        cpu = repro_torch.operator(tm, fmt, dtype=dtype, device="cpu")
        want = cpu.rmatmat(y.cpu())
        assert torch.equal(z.cpu(), want)


@pytest.mark.cuda
def test_k7_empty_column_matrix_on_card():
    _need_cuda()
    a = _dense(200, 260, 5)
    a[:, 100:140] = 0.0
    tm = TF.csr_from_dense(a)
    y = torch.from_numpy(np.random.default_rng(16).standard_normal(
        200).astype(np.float32))
    for fmt in BLOCKED:
        op = repro_torch.operator(tm, fmt, b_r=32)
        z = op.T @ y.cuda()
        assert bool((z[100:140] == 0).all()) and bool((z[3] == 0))
        want = repro_torch.operator(tm, fmt, b_r=32, device="cpu").T @ y
        assert torch.equal(z.cpu(), want)


@pytest.mark.cuda
def test_k7_refuses_bad_operands_on_card():
    _need_cuda()
    from repro_torch.kernels.transpose_spmv import \
        transpose_matvec_kernel_call as k7
    tm = TM.samg(scale=0.001)
    sd = repro_torch.operator(tm, "pjds").dev
    slot, colptr = sd.slot_index()
    y = torch.zeros(sd.dev.n_rows_pad, device="cuda")
    with pytest.raises(ValueError, match="y must be"):
        k7(sd.dev.val, slot, colptr, y[:-1], width=sd.dev.b_r,
           n_rows=sd.dev.n_rows_pad, base=sd.dev.row_block)
    with pytest.raises(ValueError, match="CUDA"):
        k7(sd.dev.val, slot, colptr, y.cpu(), width=sd.dev.b_r,
           n_rows=sd.dev.n_rows_pad, base=sd.dev.row_block)
    with pytest.raises(ValueError, match="int32"):
        k7(sd.dev.val, slot.long(), colptr, y, width=sd.dev.b_r,
           n_rows=sd.dev.n_rows_pad, base=sd.dev.row_block)
