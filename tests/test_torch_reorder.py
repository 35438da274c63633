"""RCM preprocessing and Matrix-Market I/O against the reference's.

* ``core/reorder.py``: ``rcm_permutation`` identical, ``permute_symmetric``
  arrays identical, ``bandwidth`` equal; ``preprocess``'s ``applied`` and
  ``reason`` identical under ``TPU_V5E`` at ``n_dev`` 1 and 8 (the
  reference's ``_banded(2048, 3, seed=5)`` cases) and its predicted
  times within 1e-12 relative; the port's H100 default and the
  distributed pricing without the per-product sandwich.
* ``core/io_mm.py``: read arrays and written text identical, through
  files and ``io.StringIO``, every field and symmetry, and the same
  errors.
* The reorder stage on both factories: ``operator(m, reorder="rcm")``
  gives ``operator(m)``'s products bit for bit on integer-valued data
  (any summation order is exact), and the reference's; the cache key
  separates reordered builds; a fused solve on a reordered SELL operand
  returns x in the original basis; ``dist_operator(..., reorder=...)``
  on four ranks as threads keeps y bit for bit, ships at least 10 x
  fewer halo bytes, and matches the reference's distributed operator
  on a 4-device mesh (gathered y exact, CG within 1e-5 relative).
"""
import io
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings, strategies as st

import repro_torch
from repro_torch.core import formats as TF
from repro_torch.core import io_mm as TIO
from repro_torch.core import matrices as TM
from repro_torch.core import perf_model as TPM
from repro_torch.core import reorder as TRO
from repro_torch.core.dist_comm import ThreadComm, run_ranks
from repro_torch.core.operator import dist_operator
from repro_torch.kernels import ops as TO

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ref():
    pytest.importorskip("jax")
    from repro.core import formats as F
    from repro.core import io_mm as IO
    from repro.core import perf_model as PM
    from repro.core import reorder as RO
    return F, IO, PM, RO


def _banded(F, permute, n, band, seed=None):
    """The reference test's symmetric band matrix with integer values,
    optionally shuffled by a seeded symmetric permutation."""
    i = np.arange(n, dtype=np.int64)
    offs = np.arange(-band, band + 1, dtype=np.int64)
    rows = np.repeat(i, len(offs))
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    data = ((lo * 31 + hi * 17) % 7 + 1).astype(np.float32)
    m = F.csr_from_coo(rows, cols, data, shape=(n, n))
    if seed is not None:
        m = permute(m, np.random.default_rng(seed).permutation(n))
    return m


def _pair(n, band, seed=None):
    F, _, _, RO = _ref()
    return (_banded(TF, TRO.permute_symmetric, n, band, seed),
            _banded(F, RO.permute_symmetric, n, band, seed))


def _same(a, b):
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


# ---------------------------------------------------------------- RCM
@settings(max_examples=10, deadline=None)
@given(n=st.integers(40, 300), band=st.integers(1, 5),
       seed=st.integers(0, 10_000))
def test_rcm_permutation_matches_reference(n, band, seed):
    _, _, _, RO = _ref()
    tm, jm = _pair(n, band, seed)
    assume(TRO.bandwidth(tm) > 4 * band)
    perm = TRO.rcm_permutation(tm)
    np.testing.assert_array_equal(perm, RO.rcm_permutation(jm))
    assert TRO.bandwidth(tm) == RO.bandwidth(jm)
    _same(TRO.permute_symmetric(tm, perm), RO.permute_symmetric(jm, perm))
    assert TRO.bandwidth(TRO.permute_symmetric(tm, perm)) <= 2 * band


@pytest.mark.parametrize("name", ["samg", "poisson", "zipf"])
def test_rcm_on_generated_matrices_matches_reference(name):
    F, _, _, RO = _ref()
    from repro.core import matrices as M
    tm, jm = {"samg": lambda: (TM.samg(scale=3e-4), M.samg(scale=3e-4)),
              "poisson": lambda: (TM.poisson_2d(20, 17),
                                  M.poisson_2d(20, 17)),
              "zipf": lambda: (TM.power_law(600), M.power_law(600))}[name]()
    perm = TRO.rcm_permutation(tm)
    np.testing.assert_array_equal(perm, RO.rcm_permutation(jm))
    _same(TRO.permute_symmetric(tm, perm), RO.permute_symmetric(jm, perm))


@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.parametrize("value_bytes", [4, None])
def test_preprocess_matches_reference_under_tpu_spec(n_dev, value_bytes):
    _, _, PM, RO = _ref()
    tm, jm = _pair(2048, 3, seed=5)
    for mode in ("auto", "rcm"):
        a = TRO.preprocess(tm, mode, n_dev=n_dev, value_bytes=value_bytes,
                           spec=TPM.TPU_V5E)
        b = RO.preprocess(jm, mode, n_dev=n_dev, value_bytes=value_bytes)
        assert (a.applied, a.reason) == (b.applied, b.reason)
        assert (a.bandwidth_before, a.bandwidth_after) == \
            (b.bandwidth_before, b.bandwidth_after)
        np.testing.assert_allclose(a.predicted_off_s, b.predicted_off_s,
                                   rtol=1e-12)
        np.testing.assert_allclose(a.predicted_on_s, b.predicted_on_s,
                                   rtol=1e-12)
        if a.applied:
            np.testing.assert_array_equal(a.perm, b.perm)
            np.testing.assert_array_equal(a.inv_perm, b.inv_perm)
            _same(a.matrix, b.matrix)
    # the reference's own decisions: declined on one device, applied at 8
    a = TRO.preprocess(tm, "auto", n_dev=n_dev, value_bytes=4,
                       spec=TPM.TPU_V5E)
    assert a.applied == (n_dev == 8)


def test_preprocess_h100_default_and_sandwich_pricing():
    """The port prices with the H100 by default; ``sandwich=False``
    drops exactly the per-product permute term."""
    tm, _ = _pair(2048, 3, seed=5)
    h = TRO.preprocess(tm, "auto", n_dev=8, value_bytes=4)
    h2 = TRO.preprocess(tm, "auto", n_dev=8, value_bytes=4,
                        spec=TPM.H100)
    assert (h.reason, h.predicted_on_s) == (h2.reason, h2.predicted_on_s)
    ns = TRO.preprocess(tm, "auto", n_dev=8, value_bytes=4, sandwich=False)
    assert ns.predicted_off_s == h.predicted_off_s
    term = 2 * TPM.perm_traffic_bytes(tm.n_rows, 4) / TPM.H100.hbm_bw
    np.testing.assert_allclose(h.predicted_on_s - ns.predicted_on_s, term,
                               rtol=1e-9)
    assert ns.applied and ns.bandwidth_after < ns.bandwidth_before


def test_preprocess_edge_cases():
    _, _, _, RO = _ref()
    tm, _ = _pair(128, 2, seed=3)
    pp = TRO.preprocess(tm, "off")
    assert not pp.applied and pp.matrix is tm and pp.reason == "off"
    with pytest.raises(ValueError, match="reorder"):
        TRO.preprocess(tm, "bogus")
    with pytest.raises(ValueError, match="reorder"):
        TO.as_device(tm, reorder="bogus", device="cpu")
    d = np.zeros((6, 9), np.float32)
    d[1, 2] = 1.0
    rect = TF.csr_from_dense(d)
    assert TRO.preprocess(rect, "auto").reason == "non_square"
    with pytest.raises(ValueError):
        TRO.preprocess(rect, "rcm")
    with pytest.raises(ValueError, match="square"):
        TRO.permute_symmetric(rect, np.arange(6))
    with pytest.raises(ValueError, match="perm"):
        TRO.permute_symmetric(tm, np.arange(5))
    empty = TF.csr_from_dense(np.zeros((5, 5), np.float32))
    assert TRO.preprocess(empty, "auto").reason == "empty"
    assert TRO.bandwidth(empty) == 0


# -------------------------------------------------------- Matrix Market
def _random_csr(F, seed, n=40, density=0.1, dtype=np.float64):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < density) * rng.standard_normal((n, n))
    r, c = np.nonzero(d)
    return F.csr_from_coo(r, c, d[r, c].astype(dtype), shape=(n, n))


def _sym(F, m, sign=1):
    d = np.zeros(m.shape)
    rows = np.repeat(np.arange(m.n_rows), m.row_lengths())
    d[rows, m.indices] = m.data
    d = np.tril(d, -1 if sign < 0 else 0)
    d = d + sign * np.tril(d, -1).T
    r, c = np.nonzero(d)
    return F.csr_from_coo(r, c, d[r, c].astype(m.data.dtype), shape=m.shape)


_MM_CASES = {
    "general-f64": lambda F: _random_csr(F, 0),
    "general-f32": lambda F: _random_csr(F, 1, dtype=np.float32),
    "symmetric": lambda F: _sym(F, _random_csr(F, 2)),
    "skew": lambda F: _sym(F, _random_csr(F, 3), sign=-1),
    "integer": lambda F: F.csr_from_coo(
        np.array([0, 1, 3]), np.array([2, 0, 3]),
        np.array([7, -3, 12], np.int64), shape=(4, 5)),
    "rect": lambda F: F.csr_from_dense(np.random.default_rng(4).standard_normal(
        (7, 11)) * (np.random.default_rng(5).random((7, 11)) < 0.3)),
}


@pytest.mark.parametrize("kw", [{}, {"field": "pattern"},
                                {"symmetry": "general"},
                                {"comment": "two\nlines"}])
@pytest.mark.parametrize("case", sorted(_MM_CASES))
def test_matrix_market_matches_reference(case, kw):
    F, IO, _, _ = _ref()
    tm, jm = _MM_CASES[case](TF), _MM_CASES[case](F)
    if kw.get("field") == "pattern" and case == "integer":
        pytest.skip("covered by the real cases")
    tb, jb = io.StringIO(), io.StringIO()
    TIO.save_mm(tb, tm, **kw)
    IO.save_mm(jb, jm, **kw)
    assert tb.getvalue() == jb.getvalue()
    for dtype in (np.float64, np.float32):
        tb.seek(0)
        jb.seek(0)
        _same(TIO.load_mm(tb, dtype=dtype), IO.load_mm(jb, dtype=dtype))
    tb.seek(0)
    jb.seek(0)
    th, *tarr = TIO.read_mm(tb)
    jh, *jarr = IO.read_mm(jb)
    assert repr(th) == repr(jh)
    for a, b in zip(tarr, jarr):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_matrix_market_round_trip_and_exports(tmp_path):
    m = _random_csr(TF, 6, dtype=np.float32)
    p = tmp_path / "m.mtx"
    repro_torch.save_mm(p, m, comment="c")
    _same(repro_torch.load_mm(p, dtype=np.float32), m)
    assert repro_torch.preprocess is TRO.preprocess
    buf = io.StringIO()
    TIO.save_mm(buf, m)
    buf.seek(0)
    _same(TIO.load_mm(buf, dtype=np.float32), m)


@pytest.mark.parametrize("txt,match,kw", [
    ("not a matrix market file\n", "banner", {}),
    ("%%MatrixMarket matrix coordinate complex general\n1 1 0\n",
     "complex", {}),
    ("%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1.0\n"
     "2 2 1.0\n", "declared 3", {}),
    ("%%MatrixMarket matrix coordinate real skew-symmetric\n2 2 2\n"
     "2 1 1.0\n1 1 5.0\n", "diagonal", {}),
    ("%%MatrixMarket matrix coordinate real symmetric\n2 3 1\n1 1 1.0\n",
     "2x3", {}),
    ("%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n"
     "3 1 9.0\n", "outside", {"validate": "strict"}),
    ("%%MatrixMarket matrix array pattern general\n2 2\n", "pattern", {}),
])
def test_matrix_market_errors_match_reference(txt, match, kw):
    _, IO, _, _ = _ref()
    with pytest.raises(TIO.MatrixMarketError, match=match) as e:
        TIO.load_mm(io.StringIO(txt), **kw)
    with pytest.raises(IO.MatrixMarketError) as je:
        IO.load_mm(io.StringIO(txt), **kw)
    assert str(e.value) == str(je.value)


def test_matrix_market_array_and_repair_match_reference():
    _, IO, _, _ = _ref()
    for txt in ("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
                "%%MatrixMarket matrix array real symmetric\n2 2\n1\n2\n3\n",
                "%%MatrixMarket matrix coordinate real general\n2 2 3\n"
                "1 1 2.0\n1 1 3.0\n2 2 1.0\n",
                "%%MatrixMarket matrix coordinate real general\n2 2 2\n"
                "1 1 1.0\n3 1 9.0\n"):
        _same(TIO.load_mm(io.StringIO(txt)), IO.load_mm(io.StringIO(txt)))


# ------------------------------------------------ the reorder stage
@pytest.mark.parametrize("fmt", ["csr", "ellpack_r", "sell", "pjds", "cmrs"])
def test_reordered_operator_is_bit_exact(fmt):
    """Integer-valued data: every product, transpose, block product and
    the diagonal of ``operator(m, reorder="rcm")`` equal the plain
    operator's and the reference's reordered operator's exactly."""
    import jax.numpy as jnp
    from repro.core.operator import operator as joperator
    tm, jm = _pair(512, 3, seed=1)
    op = repro_torch.operator(tm, fmt, reorder="rcm", device="cpu")
    op0 = repro_torch.operator(tm, fmt, device="cpu")
    jo = joperator(jm, fmt, reorder="rcm")
    assert op.dev.pre_perm is not None and op0.dev.pre_perm is None
    np.testing.assert_array_equal(op.dev.pre_perm.numpy(),
                                  np.asarray(jo.dev.pre_perm))
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 4, size=512).astype(np.float32)
    X = rng.integers(-3, 4, size=(512, 4)).astype(np.float32)
    for got, plain, ref in (
            (op @ torch.from_numpy(x), op0 @ torch.from_numpy(x),
             jo @ jnp.asarray(x)),
            (op.T @ torch.from_numpy(x), op0.T @ torch.from_numpy(x),
             jo.T @ jnp.asarray(x)),
            (op @ torch.from_numpy(X), op0 @ torch.from_numpy(X),
             jo @ jnp.asarray(X)),
            (op.diagonal(), op0.diagonal(), jo.diagonal())):
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_reorder_cache_key_separation_and_auto():
    tm, _ = _pair(256, 2, seed=4)
    sd_off = TO.as_device(tm, device="cpu")
    sd_on = TO.as_device(tm, reorder="rcm", device="cpu")
    assert sd_on is not sd_off
    assert sd_on.pre_perm is not None and sd_off.pre_perm is None
    assert TO.as_device(tm, reorder="rcm", device="cpu") is sd_on
    # one device: the H100 pricing declines, as the reference's does
    big, _ = _pair(2048, 3, seed=5)
    assert TO.as_device(big, reorder="auto", device="cpu").pre_perm is None


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_fused_solve_on_reordered_operand_stays_in_original_basis(method):
    """The fused loop runs on the stored operand B = P A P^T: solve()
    permutes b in and x out, so x solves A x = b."""
    m = TM.poisson_2d(24, 24)
    shuf = TRO.permute_symmetric(m, np.random.default_rng(0).permutation(
        m.n_rows))
    b = np.random.default_rng(1).standard_normal(m.n_rows).astype(
        np.float32)
    res = repro_torch.solve(shuf, b, method=method, reorder="rcm",
                            tune="off", fallback="off", device="cpu")
    plain = repro_torch.solve(shuf, b, method=method, tune="off",
                              fallback="off", device="cpu")
    assert res.info["strategy"] == plain.info["strategy"] == "fused"
    assert res.status == plain.status == "converged"
    a = np.zeros(shuf.shape)
    rows = np.repeat(np.arange(shuf.n_rows), shuf.row_lengths())
    a[rows, shuf.indices] = shuf.data
    r = np.linalg.norm(b - a @ res.x.double().numpy()) / np.linalg.norm(b)
    assert r <= 1e-5
    np.testing.assert_allclose(res.x.numpy(), plain.x.numpy(), rtol=1e-4,
                               atol=1e-4)


def _threads(m, fn, p=4):
    return run_ranks(ThreadComm.create(p, "cpu"), fn)


def test_dist_reorder_on_threads():
    """Four ranks: ``reorder="auto"`` applies RCM to the shuffled band
    (priced without the per-product sandwich), ships >= 10 x fewer halo
    bytes, and gives the plain partition's gathered y and A^T x bit for
    bit; the diagonal is the rank's slice in the stored basis; a CG
    solve on a shuffled Poisson operator gathers to the plain solve's
    x."""
    tm, _ = _pair(2048, 3, seed=5)
    x = np.random.default_rng(3).integers(-3, 4, size=2048).astype(
        np.float32)
    diag = TF.csr_diagonal(tm)
    p = TM.poisson_2d(24, 24)
    p = TRO.permute_symmetric(p, np.random.default_rng(0).permutation(
        p.n_rows))
    b = np.random.default_rng(1).standard_normal(p.n_rows)

    def body(c):
        op = dist_operator(tm, c, reorder="auto", device="cpu")
        op0 = dist_operator(tm, c, device="cpu")
        assert op.pre_perm is not None and op0.pre_perm is None
        y = op.gather_vector(op @ op.shard_vector(x))
        y0 = op0.gather_vector(op0 @ op0.shard_vector(x))
        z = op.gather_vector(op.T @ op.shard_vector(x))
        z0 = op0.gather_vector(op0.T @ op0.shard_vector(x))
        d = op.gather_vector(op.diagonal())
        opp = dist_operator(p, c, b_r=32, reorder="rcm", device="cpu")
        opp0 = dist_operator(p, c, b_r=32, device="cpu")
        res = repro_torch.solve(opp, opp.shard_vector(b), tol=1e-6)
        res0 = repro_torch.solve(opp0, opp0.shard_vector(b), tol=1e-6)
        return (y, y0, z, z0, d, opp.gather_vector(res.x),
                opp0.gather_vector(res0.x), res.status,
                op.dist.comm_bytes_per_device(4),
                op0.dist.comm_bytes_per_device(4))

    outs = _threads(tm, body)
    for y, y0, z, z0, d, xs, xs0, status, on, off in outs:
        assert torch.equal(y, y0) and torch.equal(z, z0)
        np.testing.assert_array_equal(d[:2048].numpy(),
                                      diag.astype(np.float32))
        assert status == "converged"
        np.testing.assert_allclose(xs.numpy(), xs0.numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert on * 10 <= off


def test_dist_threads_share_one_host_plan():
    """Ranks run as threads build the host plan once."""
    tm, _ = _pair(512, 2, seed=6)

    def body(c):
        return dist_operator(tm, c, reorder="rcm", device="cpu")

    ops_ = _threads(tm, body)
    assert all(o.dist is ops_[0].dist and o.t_dist is ops_[0].t_dist
               for o in ops_)
    assert all(o.pre_perm is ops_[0].pre_perm for o in ops_)


_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    sys.path.insert(0, sys.argv[2])
    from repro.core import formats as F, matrices as M, solvers as S
    from repro.core.reorder import permute_symmetric
    from repro.core.operator import dist_operator
    from test_torch_reorder import _banded
    mh = Mesh(np.array(jax.devices()[:4]), ("data",))
    out = {}
    m = _banded(F, permute_symmetric, 2048, 3, seed=5)
    op = dist_operator(m, mh, reorder="rcm")
    n = op.dist.n_global_pad
    x = np.zeros(n, np.float32)
    x[:2048] = np.random.default_rng(3).integers(-3, 4, size=2048)
    xj = jax.device_put(jnp.asarray(x), NamedSharding(mh, P("data")))
    out["y"] = np.asarray(jax.jit(op.matvec)(xj))
    out["z"] = np.asarray(jax.jit(op.rmatvec)(xj))
    out["perm"] = np.asarray(op.pre_perm)
    p = M.poisson_2d(24, 24)
    p = permute_symmetric(p, np.random.default_rng(0).permutation(p.n_rows))
    op = dist_operator(p, mh, b_r=32, reorder="rcm")
    b = np.zeros(op.dist.n_global_pad, np.float32)
    b[:p.n_rows] = np.random.default_rng(1).standard_normal(p.n_rows)
    bj = jax.device_put(jnp.asarray(b), NamedSharding(mh, P("data")))
    res = S.cg(op, bj, tol=1e-6)
    out["cg_x"] = np.asarray(res.x)
    out["cg_iters"] = np.array(int(res.iters))
    np.savez(sys.argv[1], **out)
""")


def test_dist_reorder_matches_reference(tmp_path):
    """The reference's distributed operator with forced RCM on a
    4-device mesh (it permutes around every product; the port at shard
    and gather time): the same gathered y and A^T x, bit for bit on
    integer data, and the same CG solve."""
    pytest.importorskip("jax")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [q for q in env.get("PYTHONPATH", "").split(
            os.pathsep) if q])
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp_path / "ref.npz"),
         str(ROOT / "tests")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    tm, _ = _pair(2048, 3, seed=5)
    p = TM.poisson_2d(24, 24)
    p = TRO.permute_symmetric(p, np.random.default_rng(0).permutation(
        p.n_rows))

    def body(c):
        op = dist_operator(tm, c, reorder="rcm", device="cpu")
        x = np.random.default_rng(3).integers(-3, 4, size=2048).astype(
            np.float32)
        y = op.gather_vector(op @ op.shard_vector(x))
        z = op.gather_vector(op.T @ op.shard_vector(x))
        opp = dist_operator(p, c, b_r=32, reorder="rcm", device="cpu")
        b = np.random.default_rng(1).standard_normal(p.n_rows).astype(
            np.float32)
        res = repro_torch.solve(opp, opp.shard_vector(b), tol=1e-6,
                                fallback="off")
        return y, z, op.pre_perm, opp.gather_vector(res.x), res.iters

    outs = _threads(tm, body)
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    ref = dict(np.load(tmp_path / "ref.npz"))
    for y, z, perm, x, iters in outs:
        np.testing.assert_array_equal(perm, ref["perm"])
        np.testing.assert_array_equal(y.numpy(), ref["y"])
        np.testing.assert_array_equal(z.numpy(), ref["z"])
        assert abs(iters - int(ref["cg_iters"])) <= 2
        scale = np.abs(ref["cg_x"]).max()
        assert np.abs(x.numpy() - ref["cg_x"]).max() <= 1e-5 * scale
