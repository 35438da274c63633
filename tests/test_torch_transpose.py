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
from repro_torch.kernels import transpose_spmv as K7

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
def _k7_emulate(sd, y, slots=None, long_slots=None, rows=None, stage=None):
    """K7 in numpy, as ``csrc/transpose_spmv.cu`` runs it: the CTAs of
    the tile plan in turn, for each group of at most 8 right-hand sides.
    Staged (``stage``: by default ``K7.staged``'s choice), a tile whose
    slots fit the buffer of S slots x kg stages all its products there
    and adds each column's from there in slot order; walked, a tile of
    several columns is walked a column at a time, in rounds of U index
    entries (from a multiple of 4 for k > 1), the products ``val[slot] *
    y[row(slot)]`` of the column's own entries added in slot order in
    float32; a tile of one column longer than S streams through the
    buffer in chunks and is added in the same order.  ``long_slots``
    replaces ``K7.LONG_SLOTS`` in a walked plan.  The row is read from
    ``rows`` (one per slot of the index, original basis) or follows the layout
    (``row_block`` / ``strip_map`` and ``row_in_strip``: the stored
    basis, as the first K7 read it; ELLPACK-R's position), and y reads
    as 0 at a row outside its own, so y may be unpadded."""
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
    k = yk.shape[1]
    stage = K7.staged(k) if stage is None else stage
    S = slots or K7.tile_slots(k)
    keep = K7.LONG_SLOTS
    try:
        K7.LONG_SLOTS = keep if long_slots is None else long_slots
        plan = K7.tile_plan(torch.from_numpy(colptr),
                            S if stage else 0).numpy()
    finally:
        K7.LONG_SLOTS = keep
    p = slot.astype(np.int64)
    dd = p // width
    r = (base[dd].astype(np.int64) * width if base is not None else 0) \
        + (ris[p].astype(np.int64) if ris is not None else p - dd * width)
    if rows is not None:
        r = rows.numpy().astype(np.int64)
    ok = (r >= 0) & (r < yk.shape[0])
    yg = np.where(ok[:, None], yk[np.where(ok, r, 0)], np.float32(0))
    prod = (val[p][:, None] * yg).astype(np.float32)      # (nnz, k)

    def add(acc, rows):
        for row in rows:
            acc = (acc + row).astype(np.float32)
        return acc

    z = np.zeros((colptr.shape[0] - 1, k), np.float32)
    U = 8 if k == 1 else 4                   # kUnroll's rounds
    for j0 in range(0, k, K7.MAX_K_PER_CTA):
        kg = min(k - j0, K7.MAX_K_PER_CTA)
        buf = np.empty((S, kg), np.float32)
        zero = np.zeros(kg, np.float32)
        for c0, c1 in zip(plan[:-1], plan[1:]):
            s0, s1 = colptr[c0], colptr[c1]
            if c1 - c0 > 1 and (not stage or s1 - s0 > S):    # walked
                for c in range(c0, c1):      # rounds of U entries
                    a, b, acc = colptr[c], colptr[c + 1], zero
                    for s in range(a if k == 1 else a & ~3, b, U):
                        mine = [i for i in range(s, s + U) if a <= i < b]
                        acc = add(acc, prod[mine, j0:j0 + kg])
                    z[c, j0:j0 + kg] = acc
                continue
            if s1 - s0 <= S:                      # staged, summed by column
                buf[: s1 - s0] = prod[s0:s1, j0:j0 + kg]
                for c in range(c0, c1):
                    z[c, j0:j0 + kg] = add(
                        zero, buf[colptr[c] - s0:colptr[c + 1] - s0])
                continue
            acc = zero
            for cs in range(s0, s1, S):            # one column, in chunks
                ce = min(cs + S, s1)
                buf[: ce - cs] = prod[cs:ce, j0:j0 + kg]
                acc = add(acc, buf[: ce - cs])
            z[c0, j0:j0 + kg] = acc
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
    assert K7._is_padded(slot)                          # aligned int4s
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


def _plan_case(name):
    """colptr of a named case, and the long-column limits to cut it at."""
    if name == "empty_matrix":
        return torch.zeros(41, dtype=torch.int32), (0, 128)
    if name == "no_columns":
        return torch.zeros(1, dtype=torch.int32), (0, 128)
    if name == "empty_columns":
        counts = np.zeros(3000, np.int64)
        counts[::97] = 5
    elif name == "power_law":                 # the longest column >> S
        counts = np.clip(np.random.default_rng(3).zipf(1.5, 2000), 0, 5000)
    else:                                     # sAMG's columns
        sd = _build(_pair("samg")[0], "cmrs").dev
        return sd.slot_index()[1], (4, 16, 128)
    colptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return torch.from_numpy(colptr), (4, 16, 128)


@pytest.mark.parametrize("name", ["samg", "power_law", "empty_columns",
                                  "empty_matrix", "no_columns"])
def test_tile_plan_cuts_whole_columns(name, monkeypatch):
    """The walked plan: every column lies in exactly one tile; a column
    longer than ``LONG_SLOTS`` is a tile of its own; the other tiles
    hold at most ``TILE_COLS`` columns and start at a multiple of it or
    beside a long column."""
    colptr, limits = _plan_case(name)
    n_cols = colptr.numel() - 1
    lens = np.diff(colptr.long().numpy())
    for long_slots in limits:
        monkeypatch.setattr(K7, "LONG_SLOTS", long_slots)
        plan = K7.tile_plan(colptr)
        assert plan.dtype == torch.int32 and plan.dim() == 1
        t = plan.long().numpy()
        assert t[0] == 0 and t[-1] == n_cols
        assert (np.diff(t) > 0).all()              # whole, disjoint, all
        assert (np.diff(t) <= K7.TILE_COLS).all()
        long_ = lens > long_slots
        starts = set(t[:-1].tolist())
        for c in np.flatnonzero(long_):
            assert c in starts and c + 1 in set(t.tolist())
        for c in t[1:-1]:
            assert c % K7.TILE_COLS == 0 or long_[c] or long_[c - 1]
        if name == "power_law":
            assert long_.any() and lens.max() > K7.tile_slots(1)
    with pytest.raises(ValueError, match="plan buffer"):
        K7.tile_plan(colptr, -1)


@pytest.mark.parametrize("slots", [16, 256, 4096])
@pytest.mark.parametrize("name", ["samg", "power_law", "empty_columns",
                                  "empty_matrix", "no_columns"])
def test_staged_tile_plan_fits_the_buffer(name, slots):
    """The staged plan of buffer S: every column lies in exactly one
    tile; a tile of several columns holds at most S slots and at most
    ``STAGE_COLS`` columns; a column longer than S / 2 is a tile of its
    own (the power-law case has columns longer than S, which the kernel
    streams in chunks)."""
    colptr, _ = _plan_case(name)
    n_cols = colptr.numel() - 1
    cp = colptr.long().numpy()
    plan = K7.tile_plan(colptr, slots)
    assert plan.dtype == torch.int32 and plan.dim() == 1
    t = plan.long().numpy()
    assert t[0] == 0 and t[-1] == n_cols
    assert (np.diff(t) > 0).all()                  # whole, disjoint, all
    assert (np.diff(t) <= K7.STAGE_COLS).all()
    for c0, c1 in zip(t[:-1], t[1:]):
        if c1 - c0 > 1:
            assert cp[c1] - cp[c0] <= slots
    starts, ends = set(t[:-1].tolist()), set(t[1:].tolist())
    for c in np.flatnonzero(np.diff(cp) > slots // 2):
        assert c in starts and c + 1 in ends
    if name == "power_law":
        assert np.diff(cp).max() > slots
    with pytest.raises(ValueError, match="plan buffer"):
        K7.tile_plan(colptr, 1)


def test_tile_slots_fill_the_buffer():
    """The 16 KB buffer of a staged tile or a long column, in slots of
    kg float32 products."""
    assert [K7.tile_slots(k) for k in (1, 2, 4, 8, 32)] == \
        [4096, 2048, 1024, 512, 512]
    for k in (1, 3, 4, 8, 100):
        kg = min(k, K7.MAX_K_PER_CTA)
        assert K7.tile_slots(k) * kg * 4 <= K7.TILE_BYTES


def test_buffer_only_where_a_launch_stages():
    """A launch reserves the buffer where it stages: at k = 1, or where
    a column is longer than ``LONG_SLOTS``; a walk-only launch none.
    The operand reads its longest column once."""
    L = K7.LONG_SLOTS
    assert K7.buffer_slots(1, 0) == K7.tile_slots(1)
    assert K7.buffer_slots(4, L) == 0 and K7.buffer_slots(11, 3) == 0
    assert K7.buffer_slots(4, L + 1) == K7.tile_slots(4)
    tm, _ = _pair("zipf")
    sd = _build(tm, "cmrs").dev
    longest = int(np.bincount(tm.indices, minlength=tm.shape[1]).max())
    assert sd.longest_column() == longest and sd._longest == longest


def test_staged_at_one_right_hand_side():
    assert K7.staged(1)
    assert not K7.staged(2) and not K7.staged(4) and not K7.staged(11)


def _y_for(sd, rows, k, seed):
    rng = np.random.default_rng(seed)
    shape = (rows,) if k == 1 else (rows, k)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", BLOCKED)
def test_k7_tiled_emulation_equals_plain_version(fmt, dtype, k):
    """K7's tiles and chunks, as the kernel runs them on y as the
    operator holds it (its rows from ``slot_rows``; ELLPACK-R's the
    slots' positions), and on the padded (scattered) y of the layout's
    own rows, give the plain version's z bit for bit, staged and walked:
    with the default plans (staged tiles of 4096 slots; a thread per
    column), with staged tiles of 16 slots that the power-law columns
    stream through in chunks, and with a walked plan whose columns over
    4 slots are staged through a buffer of 16."""
    tm = TF.csr_from_dense(_zipf().T)                 # power-law columns
    sd = _build(tm, fmt, dtype=dtype).dev
    y = _y_for(sd, tm.shape[0], k, 21)
    want = sd.rmatmat(torch.from_numpy(y)).numpy()
    assert int(np.diff(sd.slot_index()[1].numpy()).max()) > 16
    for stage, slots, long_slots in ((True, None, None), (True, 16, None),
                                     (False, None, None), (False, 16, 4)):
        got = _k7_emulate(sd, y, slots=slots, long_slots=long_slots,
                          rows=sd.slot_rows(), stage=stage)
        np.testing.assert_array_equal(got, want)
        got = _k7_emulate(sd, _stored_y(sd, y), slots=slots,
                          long_slots=long_slots, stage=stage)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", BLOCKED)
def test_k7_emulation_in_groups_of_right_hand_sides(fmt):
    """k = 11: a group of 8 right-hand sides and a narrower one."""
    tm, _ = _pair("rect")
    sd = _build(tm, fmt).dev
    y = _y_for(sd, tm.shape[0], 11, 22)
    want = sd.rmatmat(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(
        _k7_emulate(sd, y, rows=sd.slot_rows()), want)


@pytest.mark.parametrize("fmt", BLOCKED)
def test_slot_rows_are_the_computed_rows(fmt):
    """``slot_rows`` holds, for every slot of the index, the row of y the
    layout gives it (original basis; -1 for a padded row), built once;
    ELLPACK-R keeps none (its row is the slot's position)."""
    tm, _ = _pair("zipf")
    sd = _build(tm, fmt).dev
    rows = sd.slot_rows()
    if fmt == "ellpack_r":
        assert rows is None
        return
    assert rows.dtype == torch.int32 and rows.shape == sd.slot_index()[0].shape
    assert sd.slot_rows() is rows and K7._is_padded(rows)
    d = sd.dev
    p = sd.slot_index()[0].long()
    if fmt == "cmrs":
        want = (d.strip_map.long()[p // d.b_r] * d.b_r
                + d.row_in_strip.reshape(-1).long()[p])
    else:
        want = sd.row_map().long()[d.row_block.long()[p // d.b_r] * d.b_r
                                   + p % d.b_r]
    want = torch.where((want >= 0) & (want < tm.shape[0]), want, -1)
    assert torch.equal(rows.long(), want)
    # every real slot of a real row of A maps to that row
    cols = d.col_idx.reshape(-1).long()[p]
    a = np.zeros(tm.shape, np.float32)
    r_np = rows.long().numpy()
    keep = r_np >= 0
    np.add.at(a, (r_np[keep], cols.numpy()[keep]),
              d.val.reshape(-1).float().numpy()[p.numpy()][keep])
    dense = np.zeros(tm.shape, np.float32)
    rr = np.repeat(np.arange(tm.n_rows), tm.row_lengths())
    dense[rr, tm.indices] = tm.data
    np.testing.assert_array_equal(a, dense)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("fmt", BLOCKED)
def test_k7_unpadded_y_gives_the_padded_z(fmt, k):
    """y in the operator's own basis (unpadded; pJDS / SELL unpermuted,
    through the slot rows) gives the z of the padded (scattered) y, bit
    for bit, also where y is 0 or -0."""
    tm, _ = _pair("int")
    sd = _build(tm, fmt).dev
    y = _y_for(sd, tm.shape[0], k, 23)
    y[::7] = 0.0
    y[1::7] = -0.0
    padded = _k7_emulate(sd, _stored_y(sd, y))
    np.testing.assert_array_equal(
        _k7_emulate(sd, y, rows=sd.slot_rows()), padded)
    np.testing.assert_array_equal(
        padded, sd.rmatmat(torch.from_numpy(y)).numpy())
    assert sd.tile_plan(k) is sd.tile_plan(k)            # kept


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


@pytest.mark.parametrize("fmt", BLOCKED)
def test_with_values_shares_the_index_of_the_same_mask(fmt):
    """New values on the same non-zeros (a training step) keep the
    padding mask: the new operand shares the slot index, rows and plans
    of the operand it came from (built once, by whichever transposes
    first), and its transpose reads the new values.  A value in a slot
    that was padding gives it its own index."""
    tm, _ = _pair("zipf")
    op = _build(tm, fmt)
    v = op.values.clone()
    v[op.values != 0] *= 2.0                 # exact: z doubles
    y = torch.from_numpy(_y_for(op.dev, tm.shape[0], 1, 26))
    op2 = op.with_values(v)
    sd, sd2 = op.dev, op2.dev
    slot, colptr = sd2.slot_index()                   # built on the base
    assert sd.slot_index() is sd2.slot_index()
    assert sd.slot_rows() is sd2.slot_rows()
    assert sd2.tile_plan(1) is sd.tile_plan(1)
    assert sd2._base is sd and op2.with_values(v).dev._base is sd
    np.testing.assert_array_equal(
        _k7_emulate(sd2, y.numpy(), rows=sd2.slot_rows()),
        sd2.rmatmat(y).numpy())
    np.testing.assert_array_equal(
        sd2.rmatmat(y).numpy(), (2.0 * sd.rmatmat(y)).numpy())
    if fmt == "ellpack_r":
        return                        # the mask is the row lengths alone
    w = op.values.clone()
    w[(op.values == 0) & (op.dev.dev.col_idx == TF.PAD_COL)] = 1.0
    sd3 = op.with_values(w).dev
    assert sd3.slot_index()[0].numel() > slot.numel()
    assert sd3.slot_index() is not sd.slot_index()


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
    rows = sd.slot_rows()
    y = torch.zeros(tm.n_rows, device="cuda")
    kw = dict(width=sd.dev.b_r, n_rows=tm.n_rows, rows=rows)
    with pytest.raises(ValueError, match="y must be"):
        k7(sd.dev.val, slot, colptr, y[:-1], **kw)
    with pytest.raises(ValueError, match="CUDA"):
        k7(sd.dev.val, slot, colptr, y.cpu(), **kw)
    with pytest.raises(ValueError, match="int32"):
        k7(sd.dev.val, slot.long(), colptr, y, **kw)
    with pytest.raises(ValueError, match="plan"):
        k7(sd.dev.val, slot, colptr, y, plan=sd.tile_plan().long(), **kw)
    with pytest.raises(ValueError, match="rows must be"):
        k7(sd.dev.val, slot, colptr, y, width=sd.dev.b_r, n_rows=tm.n_rows,
           rows=rows[:-1])
    with pytest.raises(ValueError, match="aligned"):
        k7(sd.dev.val, slot.clone(), colptr, y, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", BLOCKED)
def test_k7_long_columns_and_unpadded_y_on_card(fmt):
    """Columns longer than the buffer stream through it in chunks: at
    k = 1 staged tiles of 4096 slots, at k = 4 and 11 walked tiles whose
    columns over ``LONG_SLOTS`` are staged through 1024 and 512 slots;
    y is unpadded and unpermuted, its rows read from
    the index (ELLPACK-R: the slots' positions); k = 1, 4 and 11 (two
    groups of right-hand sides), all equal to the CPU plain version bit
    for bit, through the operator and through the wrapper."""
    _need_cuda()
    from repro_torch.kernels.transpose_spmv import \
        transpose_matvec_kernel_call as k7
    rng = np.random.default_rng(24)
    n_rows, n_cols = 12000, 3000
    lens = np.clip(rng.zipf(1.6, n_cols), 1, n_rows)
    lens[:4] = (n_rows, 5000, 1500, 200)
    cols = np.repeat(np.arange(n_cols), lens)
    rows = np.concatenate([rng.choice(n_rows, ln, replace=False)
                           for ln in lens])
    vals = rng.standard_normal(cols.size).astype(np.float32)
    tm = TF.csr_from_coo(rows, cols, vals, (n_rows, n_cols))
    op = repro_torch.operator(tm, fmt, b_r=32)
    cpu = repro_torch.operator(tm, fmt, b_r=32, device="cpu")
    sd = op.dev
    for k in (1, 4, 11):
        y = torch.from_numpy(_y_for(sd, n_rows, k, 25 + k))
        k7.launches = 0
        z = op.T @ y.cuda()
        assert k7.launches == 1
        assert torch.equal(z.cpu(), cpu.rmatmat(y))
        assert torch.equal(z, op.T @ y.cuda())
        # the kernel called directly, its tile plan built by the wrapper
        slot, colptr = sd.slot_index()
        d = sd.dev
        width = d.n_rows_pad if fmt == "ellpack_r" else d.b_r
        zp = k7(d.val, slot, colptr, y.cuda(), n_rows=n_rows, width=width,
                rows=sd.slot_rows())
        assert torch.equal(zp, z)
