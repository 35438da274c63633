"""The port's distributed layer run on the CPU against float64 truth and
against the reference's ``dist_operator`` and distributed solves.

* ``ThreadComm`` ranks (threads of this process) run every mode x halo
  flavour over 1-D and 2-D grids of 2, 4 and 8 ranks: each rank's y
  slice (and Y for a block of three right-hand sides) within 1e-5 *
  max|y| of float64 truth, and for 4 and 8 ranks within the same bound
  of the reference's y, which one subprocess computes on a mesh of
  virtual host devices (f32 on both sides, summed in another order).
* Four gloo processes (``torch.distributed`` with a ``FileStore``) run
  the same bodies: their y equals the threads' bit for bit (the same
  operations in the same order on the same CPU).  Their CG, Jacobi
  PCG, BiCGStab and block CG through ``repro_torch.solve`` end with the
  reference's status, every rank with the same status and iterations,
  within 2 iterations of the reference's distributed solvers.
* The operator's pieces: ``rmatvec`` / ``.T`` against float64 A^T,
  ``diagonal()``, ``shard_vector`` / ``gather_vector``, the errors of
  what is not ported, and refinement over a distributed operator.
* ``kernels._build.load`` builds once when threads ask at once.

Card tests (marked ``cuda``) run a 4-rank ``ThreadComm`` partition on
the card against the same body on the CPU and count K1's launches.
"""
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro_torch
from repro_torch.core import dist_spmv as D
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.core.dist_comm import ThreadComm, run_ranks
from repro_torch.core.operator import DistOperator, dist_operator

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5          # max|y - y_ref| <= TOL * max|y_ref|: f32 sums in
                    # another order than the reference / float64
B_R = 32


def _nondivisible():
    """323 rows, random band of reach 40 (the reference's 2-D test
    matrix); the same code in every process gives the same matrix."""
    rng = np.random.default_rng(0)
    n = 323
    rows, cols = [], []
    for r in range(n):
        cand = np.arange(max(0, r - 40), min(n, r + 40))
        sel = cand[rng.random(len(cand)) < 0.3]
        rows += [r] * len(sel)
        cols += list(sel)
    return TF.csr_from_coo(np.array(rows), np.array(cols),
                           rng.standard_normal(len(rows)), (n, n))


M323 = _nondivisible()
A323 = sp.csr_matrix((M323.data, M323.indices, M323.indptr),
                     shape=M323.shape)


def _gstr(grid):
    return "1d" if grid is None else f"{grid[0]}x{grid[1]}"


def _xs(n_pad):
    """The right-hand sides every process draws: x (n_pad,), X (n_pad, 3)."""
    return (np.random.default_rng(1).standard_normal(n_pad).astype(
        np.float32), np.random.default_rng(2).standard_normal(
        (n_pad, 3)).astype(np.float32))


_PLANS = {}


def _plan(m_key, p, grid):
    key = (m_key, p, grid)
    if key not in _PLANS:
        m = {"m323": lambda: M323, "tiny": _tiny,
             "blockdiag": _blockdiag}[m_key]()
        _PLANS[key] = D.partition_csr(m, p, b_r=B_R, grid=grid)
    return _PLANS[key]


def _tiny():
    n = 40
    return TF.csr_from_dense(np.diag(np.full(n, 4.0))
                             + np.diag(np.full(n - 1, -1.0), 1)
                             + np.diag(np.full(n - 1, -1.0), -1))


def _blockdiag():
    """8 dense 32 x 32 blocks: on 4 ranks no entry crosses a link."""
    rng = np.random.default_rng(0)
    return TF.csr_from_dense(np.kron(np.eye(8), rng.standard_normal(
        (32, 32))))


def _threads(plan, mode, halo, x, X=None, device="cpu"):
    """y (and Y) of every rank, by ThreadComm ranks."""
    comms = ThreadComm.create(plan.n_dev, device)

    def body(c):
        op = DistOperator(plan, c, mode=mode, halo=halo, device=device)
        y = op.matvec(op.shard_vector(x))
        Y = None if X is None else op.matmat(op.shard_vector(X))
        return y.cpu(), None if Y is None else Y.cpu()

    return run_ranks(comms, body)


def _close(y, truth, tol=TOL):
    y, truth = np.asarray(y, np.float64), np.asarray(truth, np.float64)
    assert y.shape == truth.shape
    scale = max(np.abs(truth).max(), 1e-30)
    err = np.abs(y - truth).max() / scale
    assert err <= tol, err


_SHAPES = [(2, None), (2, (1, 2)), (4, None), (4, (2, 2)), (4, (1, 4)),
           (4, (4, 1)), (8, None), (8, (2, 4))]
_BODY = [pytest.param(p, g, mode, halo,
                      id=f"P{p}-{_gstr(g)}-{mode}-{halo}")
         for p, g in _SHAPES for mode in D.MODES for halo in D.HALOS]


@pytest.mark.parametrize("p,grid,mode,halo", _BODY)
def test_threads_match_float64(p, grid, mode, halo):
    plan = _plan("m323", p, grid)
    x, X = _xs(plan.n_global_pad)
    out = _threads(plan, mode, halo, x, X)
    y = np.concatenate([o[0].numpy() for o in out])
    Y = np.concatenate([o[1].numpy() for o in out])
    n = M323.n_rows
    _close(y[:n], A323 @ x[:n].astype(np.float64))
    _close(Y[:n], A323 @ X[:n].astype(np.float64))
    assert not y[n:].any() and not Y[n:].any()     # padded rows stay 0


@pytest.mark.parametrize("grid", [None, (2, 4), (4, 2)])
@pytest.mark.parametrize("halo", D.HALOS)
def test_degenerate_partition(grid, halo):
    """Most of the 8 ranks own only padding: their operands are empty
    (K1 walks no diagonal) and y keeps the truth."""
    plan = _plan("tiny", 8, grid)
    assert plan.n_loc * 2 > 40        # ranks 2.. own no row of the matrix
    m = _tiny()
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    x, _ = _xs(plan.n_global_pad)
    for mode in ("overlap", "pipeline"):
        y = np.concatenate([o[0].numpy() for o in
                            _threads(plan, mode, halo, x)])
        _close(y[:40], a @ x[:40].astype(np.float64))


# --------------------------------------------------------- the reference
_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.core import formats as F, matrices as M, dist_spmv as D
    from repro.core import solvers as S
    from repro.core.operator import dist_operator

    def mesh(p):
        return Mesh(np.array(jax.devices()[:p]), ("data",))

    out = {}
    rng = np.random.default_rng(0)
    n = 323
    rows, cols = [], []
    for r in range(n):
        cand = np.arange(max(0, r - 40), min(n, r + 40))
        sel = cand[rng.random(len(cand)) < 0.3]
        rows += [r] * len(sel)
        cols += list(sel)
    m = F.csr_from_coo(np.array(rows), np.array(cols),
                       rng.standard_normal(len(rows)), (n, n))
    for p, grid in ((4, None), (4, (2, 2)), (4, (1, 4)), (8, None),
                    (8, (2, 4))):
        dist = D.partition_csr(m, p, b_r=32, grid=grid)
        x = np.random.default_rng(1).standard_normal(
            dist.n_global_pad).astype(np.float32)
        X = np.random.default_rng(2).standard_normal(
            (dist.n_global_pad, 3)).astype(np.float32)
        mh = mesh(p)
        xj = jax.device_put(jnp.asarray(x), NamedSharding(mh, P("data")))
        Xj = jax.device_put(jnp.asarray(X),
                            NamedSharding(mh, P("data", None)))
        g = "1d" if grid is None else f"{grid[0]}x{grid[1]}"
        for mode in ("vector", "naive", "overlap", "pipeline"):
            for halo in ("gathered", "full"):
                op = dist_operator(dist, mh, mode=mode, halo=halo)
                out[f"y_{p}_{g}_{mode}_{halo}"] = np.asarray(
                    jax.jit(op.matvec)(xj))
                if mode == "overlap":
                    out[f"Y_{p}_{g}_{mode}_{halo}"] = np.asarray(
                        jax.jit(op.matmat)(Xj))
    mh = mesh(4)
    for key, mat, fn, tol, kw, k in (
            ("cg", M.poisson_2d(24, 24), S.cg, 1e-6, {}, 0),
            ("pcg", M.poisson_2d(24, 24), S.cg, 1e-6, {"M": "jacobi"}, 0),
            ("bicgstab", M.convection_poisson(17, 19, beta=0.4),
             S.bicgstab, 3e-6, {}, 0),
            ("block_cg", M.poisson_2d(24, 24), S.block_cg, 1e-6, {}, 3)):
        op = dist_operator(mat, mh, b_r=32)
        npad = op.dist.n_global_pad
        r = np.random.default_rng(3)
        if k:
            b = np.zeros((npad, k), np.float32)
            b[:mat.n_rows] = r.standard_normal((mat.n_rows, k))
            spec = P("data", None)
        else:
            b = np.zeros(npad, np.float32)
            b[:mat.n_rows] = r.standard_normal(mat.n_rows)
            spec = P("data")
        bj = jax.device_put(jnp.asarray(b), NamedSharding(mh, spec))
        res = fn(op, bj, tol=tol, **kw)
        out[f"status_{key}"] = np.array(res.status)
        out[f"iters_{key}"] = np.array(int(res.iters))
    np.savez(sys.argv[1], **out)
""")

# One gloo rank: the bodies of 4 ranks over three grids, then the solves.
_GLOO_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    store = dist.FileStore(tmp + "/store", world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    import repro_torch
    from repro_torch.core import dist_spmv as D, matrices as TM
    from repro_torch.core.operator import DistOperator, dist_operator
    sys.path.insert(0, sys.argv[4])
    from test_torch_dist import M323, _xs
    comm = repro_torch.GroupComm()
    out = {}
    for grid in (None, (2, 2), (1, 4)):
        plan = D.partition_csr(M323, world, b_r=32, grid=grid)
        x, X = _xs(plan.n_global_pad)
        g = "1d" if grid is None else f"{grid[0]}x{grid[1]}"
        for mode in D.MODES:
            for halo in D.HALOS:
                op = DistOperator(plan, comm, mode=mode, halo=halo,
                                  device="cpu")
                out[f"y_{g}_{mode}_{halo}"] = op.matvec(
                    op.shard_vector(x)).numpy()
                out[f"Y_{g}_{mode}_{halo}"] = op.matmat(
                    op.shard_vector(X)).numpy()
    for key, mat, method, tol, kw, k in (
            ("cg", TM.poisson_2d(24, 24), "cg", 1e-6, {}, 0),
            ("pcg", TM.poisson_2d(24, 24), "cg", 1e-6,
             {"precond": "jacobi"}, 0),
            ("bicgstab", TM.convection_poisson(17, 19, beta=0.4),
             "bicgstab", 3e-6, {}, 0),
            ("block_cg", TM.poisson_2d(24, 24), "block_cg", 1e-6, {}, 3)):
        op = dist_operator(mat, comm, b_r=32, device="cpu")
        npad = op.shape[0]
        r = np.random.default_rng(3)
        if k:
            b = np.zeros((npad, k), np.float32)
            b[:mat.n_rows] = r.standard_normal((mat.n_rows, k))
        else:
            b = np.zeros(npad, np.float32)
            b[:mat.n_rows] = r.standard_normal(mat.n_rows)
        res = repro_torch.solve(op, op.shard_vector(b), method=method,
                                tol=tol, **kw)
        out[f"status_{key}"] = np.array(res.status)
        out[f"iters_{key}"] = np.array(res.iters)
        out[f"x_{key}"] = res.x.numpy()
    dist.destroy_process_group()
    np.savez(f"{tmp}/rank{rank}.npz", **out)
""")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference subprocess and the four gloo ranks together;
    returns their outputs once all have ended."""
    tmp = tmp_path_factory.mktemp("dist")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "ref.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _GLOO_SCRIPT, str(r), "4", str(tmp),
         str(ROOT / "tests")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return (dict(np.load(tmp / "ref.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)])


_REF_SHAPES = [(4, None), (4, (2, 2)), (4, (1, 4)), (8, None), (8, (2, 4))]


@pytest.mark.parametrize("p,grid,mode,halo", [
    pytest.param(p, g, mode, halo, id=f"P{p}-{_gstr(g)}-{mode}-{halo}")
    for p, g in _REF_SHAPES for mode in D.MODES for halo in D.HALOS])
def test_threads_match_reference(runs, p, grid, mode, halo):
    ref, _ = runs
    plan = _plan("m323", p, grid)
    x, X = _xs(plan.n_global_pad)
    out = _threads(plan, mode, halo, x, X)
    key = f"{p}_{_gstr(grid)}_{mode}_{halo}"
    _close(np.concatenate([o[0].numpy() for o in out]), ref[f"y_{key}"])
    if mode == "overlap":
        _close(np.concatenate([o[1].numpy() for o in out]), ref[f"Y_{key}"])


@pytest.mark.parametrize("grid", [None, (2, 2), (1, 4)], ids=_gstr)
@pytest.mark.parametrize("mode", D.MODES)
def test_gloo_equals_threads_bit_for_bit(runs, grid, mode):
    _, ranks = runs
    plan = _plan("m323", 4, grid)
    x, X = _xs(plan.n_global_pad)
    for halo in D.HALOS:
        out = _threads(plan, mode, halo, x, X)
        for r in range(4):
            key = f"{_gstr(grid)}_{mode}_{halo}"
            np.testing.assert_array_equal(ranks[r][f"y_{key}"],
                                          out[r][0].numpy())
            np.testing.assert_array_equal(ranks[r][f"Y_{key}"],
                                          out[r][1].numpy())


@pytest.mark.parametrize("key", ["cg", "pcg", "bicgstab", "block_cg"])
def test_gloo_solves_match_reference(runs, key):
    ref, ranks = runs
    statuses = {str(rk[f"status_{key}"]) for rk in ranks}
    iters = {int(rk[f"iters_{key}"]) for rk in ranks}
    assert statuses == {str(ref[f"status_{key}"])} == {"converged"}
    assert len(iters) == 1
    assert abs(iters.pop() - int(ref[f"iters_{key}"])) <= 2


def test_gloo_solution_is_right(runs):
    """The CG ranks' slices put together solve the system (float64
    residual of the gathered solution)."""
    _, ranks = runs
    m = TM.poisson_2d(24, 24)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    npad = sum(rk["x_cg"].shape[0] for rk in ranks)
    b = np.zeros(npad)
    b[:m.n_rows] = np.random.default_rng(3).standard_normal(m.n_rows)
    for key in ("cg", "pcg"):
        x = np.concatenate([rk[f"x_{key}"] for rk in ranks])[:m.n_rows]
        res = np.linalg.norm(b[:m.n_rows] - a @ x.astype(np.float64))
        assert res / np.linalg.norm(b) <= 2e-6


def test_dist_scaling_rehearses_on_gloo():
    """The four-card harness (``dist_scaling.py``) run as four gloo CPU
    processes on a small sAMG: every check passes (y within 1e-5 *
    max|y| of scipy, CG alike on every rank), every mode x halo of the
    1-D and the 2 x 2 partition is reported, and the last line is
    ``{"ok": true, ...}``."""
    import json
    r = subprocess.run([sys.executable, str(ROOT / "dist_scaling.py"),
                        "--backend", "gloo", "--scale", "0.001",
                        "--timeout", "240"], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()]
    assert lines[-1] == {"ok": True, "backend": "gloo", "ranks": 4}
    phases = {ln.get("phase") for ln in lines}
    for mode in D.MODES:
        for halo in D.HALOS:
            assert f"dist_scaling:{mode}:{halo}" in phases
            assert f"dist_scaling:2x2:{mode}:{halo}" in phases
    setup = next(ln for ln in lines if ln.get("phase") ==
                 "dist_scaling:setup")
    assert setup["cg"]["status"] == "converged"
    assert setup["p1"]["max_rel_err_vs_scipy_f64"] <= TOL


# ------------------------------------------------------- operator pieces
@pytest.mark.parametrize("grid", [None, (2, 2)], ids=_gstr)
def test_transpose_diagonal_and_vectors(grid):
    """``rmatvec``, ``.T @ x`` and ``rmatmat`` against float64 A^T (the
    transpose partition on the swapped grid), ``diagonal()`` the rank's
    slice of diag(A), and shard / gather round trips."""
    comms = ThreadComm.create(4, "cpu")
    n = M323.n_rows

    def body(c):
        op = dist_operator(M323, c, b_r=B_R, grid=grid, device="cpu")
        x, X = _xs(op.shape[0])
        xl, Xl = op.shard_vector(x), op.shard_vector(X)
        back = op.gather_vector(xl)
        short = op.shard_vector(x[:n])
        return (op.rmatvec(xl), op.T @ xl, op.T.matmat(Xl), op.rmatmat(Xl),
                op.diagonal(), back, short, xl, op.T.T.matvec(xl),
                op.matvec(xl), op.dist.grid, op.t_dist.grid)

    out = run_ranks(comms, body)
    x, X = _xs(out[0][5].shape[0])
    at = A323.T.tocsr()
    cat = lambda i: np.concatenate([o[i].numpy() for o in out])  # noqa
    _close(cat(0)[:n], at @ x[:n].astype(np.float64))
    np.testing.assert_array_equal(cat(0), cat(1))
    _close(cat(2)[:n], at @ X[:n].astype(np.float64))
    np.testing.assert_array_equal(cat(2), cat(3))
    np.testing.assert_array_equal(cat(4)[:n], TF.csr_diagonal(M323).astype(
        np.float32))
    for o in out:
        np.testing.assert_array_equal(o[5].numpy(), x)     # gather
    np.testing.assert_array_equal(cat(7), x)
    short = cat(6)
    np.testing.assert_array_equal(short[:n], x[:n])
    assert not short[n:].any()
    np.testing.assert_array_equal(cat(8), cat(9))          # (A^T)^T = A
    g = out[0][10]
    assert out[0][11] == (None if g is None else (g[1], g[0]))


def test_operator_errors(tmp_path, monkeypatch):
    comms = ThreadComm.create(2, "cpu")
    plan = _plan("m323", 2, None)
    c = comms[0]
    op = dist_operator(plan, c, device="cpu")   # wrapped as-is
    assert op.shape == (plan.n_global_pad,) * 2 and op.n_rows == 323
    assert op.dtype == torch.float32 and op.device == torch.device("cpu")
    with pytest.raises(ValueError, match="transpose"):
        op.rmatvec(torch.zeros(plan.n_loc))
    with pytest.raises(ValueError, match="transpose"):
        op.T
    with pytest.raises(ValueError, match="diagonal"):
        op.diagonal()
    with pytest.raises(ValueError, match="slice"):
        op.matvec(torch.zeros(plan.n_global_pad))
    with pytest.raises(ValueError, match="grid"):
        dist_operator(plan, c, grid=(1, 2), device="cpu")
    # tune= raised until the distributed tuner (ROADMAP.md 1.20) was
    # ported; on one rank it now tunes (tests/test_torch_dist_tune.py)
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    one = ThreadComm.create(1, "cpu")[0]
    for tune in ("auto", "force"):
        op1 = dist_operator(M323, one, device="cpu", tune=tune, b_r=B_R,
                            transpose=None)
        assert op1.dist.chunk_l in (8, 16, 32)
    with pytest.raises(ValueError, match="tune"):
        dist_operator(M323, c, tune="bogus", device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        DistOperator(_plan("m323", 4, None), c, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        DistOperator(plan, c, mode="bogus", device="cpu")


def test_auto_choices():
    """``grid="auto"`` keeps the cheapest shape under the perf model,
    ``halo="auto"`` its gathered/full pick, ``mode="auto"`` overlap."""
    from repro_torch.core import perf_model as PM
    c = ThreadComm.create(4, "cpu")[0]
    op = dist_operator(M323, c, b_r=B_R, grid="auto", halo="auto",
                       mode="auto", transpose=None, device="cpu")
    costs = {}
    for g in D.grid_shapes(4):
        d = D.partition_csr(M323, 4, b_r=B_R,
                            grid=None if g == (4, 1) else g)
        costs[g] = min(PM.predicted_dist_spmv_seconds(d, h, "overlap")
                       for h in D.HALOS)
    assert op.dist.grid_eff == min(costs, key=costs.get)
    assert op.halo == PM.choose_halo(op.dist, "overlap")
    assert op.mode == "overlap" and op.t_dist is None


def test_group_comm_refuses_a_foreign_device(tmp_path):
    """A gloo group carries CPU tensors only; the check raises before
    any message is posted (a process group of one)."""
    import torch.distributed as dist
    from repro_torch.core.dist_comm import GroupComm
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        c = GroupComm()
        assert (c.rank, c.size, c.backend) == (0, 1, "gloo")
        c.check(torch.zeros(1))
        out = c.all_reduce_sum(torch.arange(3.0))
        assert out.tolist() == [0.0, 1.0, 2.0]
        with pytest.raises(ValueError, match="carries cpu"):
            c.check(torch.zeros(1, device="meta"))
        op = dist_operator(M323, c, b_r=B_R, device="cpu")
        x, _ = _xs(op.shape[0])
        _close(op.matvec(op.shard_vector(x)).numpy()[:323],
               A323 @ x[:323].astype(np.float64))
    finally:
        dist.destroy_process_group()


def test_refined_distributed_solve():
    """``refine=True`` over a DistOperator: each rank's operands cast to
    bf16 (the index sets shared), the transpose partition dropped, and
    the refined solve converges on every rank alike."""
    m = TM.poisson_2d(24, 24)
    comms = ThreadComm.create(4, "cpu")
    b = np.random.default_rng(3).standard_normal(m.n_rows)

    def body(c):
        op = dist_operator(m, c, b_r=B_R, device="cpu")
        from repro_torch.api import _cast_low_precision
        lo = _cast_low_precision(op)
        assert lo.dtype == torch.bfloat16 and lo.t_shard is None
        assert lo.shard.links is op.shard.links
        assert op.dtype == torch.float32
        res = repro_torch.solve(op, op.shard_vector(b), refine=True,
                                tol=1e-6)
        return res.status, res.iters, res.info["strategy"]

    out = run_ranks(comms, body)
    assert len(set(out)) == 1
    assert out[0][0] == "converged" and out[0][2] == "composed+refined"


def test_failed_rank_releases_the_others():
    """A rank that raises ends the run with its error; the ranks waiting
    on it are released instead of hanging."""
    comms = ThreadComm.create(3, "cpu")

    def body(c):
        if c.rank == 1:
            raise KeyError("boom")
        return c.all_reduce_sum(torch.ones(1))

    with pytest.raises(KeyError, match="boom"):
        run_ranks(comms, body)


def test_threadcomm_messages_and_sums():
    """Messages match by (sender, receiver, tag) in order; a sum is the
    rank-order sum, the same bits on every rank."""
    comms = ThreadComm.create(4, "cpu")
    vals = [torch.tensor([0.1, 1e8, -3.0]) * (r + 1) for r in range(4)]

    def body(c):
        r, n = c.rank, c.size
        got = [torch.empty(2), torch.empty(2)]
        h = c.exchange([(torch.full((2,), float(r)), (r + 1) % n, 7),
                        (torch.full((2,), 10.0 + r), (r + 1) % n, 7)],
                       [(got[0], (r - 1) % n, 7), (got[1], (r - 1) % n, 7)])
        h.wait()
        return got, c.all_reduce_sum(vals[r])

    out = run_ranks(comms, body)
    want = vals[0].clone()
    for v in vals[1:]:
        want = want + v
    for r, (got, s) in enumerate(out):
        src = (r - 1) % 4
        assert got[0].tolist() == [float(src)] * 2
        assert got[1].tolist() == [10.0 + src] * 2
        assert torch.equal(s, want)


def test_build_load_builds_once_across_threads(monkeypatch, tmp_path):
    """Eight threads asking for a library at once wait for ONE build
    (the compiler stubbed: each call of build_all counts)."""
    from repro_torch.kernels import _build
    calls = []
    barrier = threading.Barrier(8)

    def fake_build_all():
        calls.append(threading.get_ident())
        return {}

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.demo_error_string = type("F", (), {})()

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    import ctypes
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    got = []

    def worker():
        barrier.wait()
        got.append(_build.load("demo"))

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert len(calls) == 1 and len(got) == 8
    assert all(g is got[0] for g in got)


def test_launch_count_is_exact_across_threads():
    """The launch counts lose no update when ranks launch at once."""
    from repro_torch.kernels import _build

    def fake():
        pass

    fake.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            _build.count_launch(fake) for _ in range(2000)])
            for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert fake.launches == 16000


# ------------------------------------------------------------- the card
def _k1_per_call(plan, mode, halo):
    """K1 launches of one rank's matvec: the local operand, then the
    remote one or one per pipeline stage (none without a halo)."""
    if (sum(plan.halo_lens) == 0 if halo == "gathered"
            else plan.halo_w == 0):
        return 1
    return 1 + (len(plan.stage_dists) if mode == "pipeline" else 1)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("m_key,grid", [
    ("m323", None), ("m323", (2, 2)),
    # ranks 2 and 3 own only padding: operands whose warps walk nothing
    ("tiny", None), ("tiny", (2, 2)),
    # no remote entry anywhere: the local launch alone
    ("blockdiag", None)], ids=lambda v: v if isinstance(v, str) else _gstr(v))
def test_threads_on_card_match_cpu(m_key, grid):
    """Four ThreadComm ranks on one card, each on its own stream: every
    mode x halo gives the CPU body's y within TOL, through K1 (and K5
    for X), exactly one local launch per rank and call plus the remote
    or stage launches -- empty operands launch too and write zeros."""
    _need_card()
    from repro_torch.kernels.pjds_spmm import pjds_matmat_kernel_call
    from repro_torch.kernels.pjds_spmv import pjds_matvec_kernel_call
    plan = _plan(m_key, 4, grid)
    x, X = _xs(plan.n_global_pad)
    for mode in D.MODES:
        for halo in D.HALOS:
            cpu = _threads(plan, mode, halo, x, X)
            k1, k5 = (pjds_matvec_kernel_call.launches,
                      pjds_matmat_kernel_call.launches)
            card = _threads(plan, mode, halo, x, X, device="cuda")
            per = _k1_per_call(plan, mode, halo)
            assert pjds_matvec_kernel_call.launches - k1 == 4 * per
            assert pjds_matmat_kernel_call.launches - k5 == 4 * per
            for (yc, Yc), (yg, Yg) in zip(cpu, card):
                _close(yg.numpy(), yc.numpy())
                _close(Yg.numpy(), Yc.numpy())
            if m_key == "tiny" and grid is None:
                for yg, Yg in card[2:]:           # rows of padding only
                    assert not yg.any() and not Yg.any()


@pytest.mark.cuda
def test_threadcomm_defaults_to_the_card():
    """With no device named the ranks run on the card, each on a CUDA
    stream of its own."""
    _need_card()
    comms = ThreadComm.create(4)
    streams = [c.stream for c in comms]
    assert all(s is not None and s.device.type == "cuda" for s in streams)
    assert len({s.cuda_stream for s in streams}) == 4


def test_threadcomm_names_the_cpu_without_a_card(monkeypatch):
    """Without a card, ``create`` with no device raises rather than
    quietly running the ranks on the CPU; ``device="cpu"`` gives ranks
    without streams."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ThreadComm.create(4)
    assert all(c.stream is None for c in ThreadComm.create(4, "cpu"))
