"""The eigensolvers against the reference's: ``lanczos``,
``block_lanczos``, ``power_iteration``, ``tridiag_eigvals`` and
``block_tridiag_eigvals`` on small symmetric matrices (2-D Poisson and a
symmetrised HMEp analogue), through the port's operator and the
reference's on the same host matrix and starting vector; the one host
read per run; and Lanczos over a distributed operator on four ranks as
threads.

Tolerances (f32 on both sides, summation orders differ): alphas and
betas within 1e-4 relative to their largest magnitude for m <= 30, the
Ritz extremes within 1e-4 relative, power iteration's eigenvalue within
1e-5 relative; the host-side eigenvalue routines on identical inputs
exactly.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.core import solvers as TS
from repro_torch.core.dist_comm import ThreadComm, run_ranks
from repro_torch.core.operator import dist_operator


def _jax():
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import formats as F
    from repro.core import matrices as M
    from repro.core import solvers as S
    from repro.core.operator import operator as joperator
    return jnp, F, M, S, joperator


def _hmep_sym(F, M):
    raw = M.hmep(scale=1e-4)
    rows = np.repeat(np.arange(raw.n_rows), raw.row_lengths())
    d = np.zeros(raw.shape)
    d[rows, raw.indices] = raw.data
    return F.csr_from_dense(((d + d.T) / 2).astype(np.float32))


_CASES = {
    "poisson": lambda F, M: M.poisson_2d(14, 13),
    "hmep": _hmep_sym,
}


def _pair(name):
    jnp, F, M, S, joperator = _jax()
    return _CASES[name](TF, TM), _CASES[name](F, M)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("m_steps", [10, 30])
@pytest.mark.parametrize("fmt", ["sell", "cmrs", "pjds", "csr"])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_lanczos_matches_reference(name, fmt, m_steps):
    jnp, F, M, S, joperator = _jax()
    tm, jm = _pair(name)
    v0 = np.random.default_rng(0).standard_normal(tm.n_rows).astype(
        np.float32)
    op = repro_torch.operator(tm, fmt, b_r=32, device="cpu")
    res = TS.lanczos(op, torch.from_numpy(v0), m=m_steps)
    al, be = res
    ja, jb = S.lanczos(joperator(jm, fmt, b_r=32), jnp.asarray(v0),
                       m=m_steps)
    assert res.info["host_syncs"] == 1
    assert al.shape == be.shape == (m_steps,) and al.device.type == "cpu"
    assert _rel(al, ja) <= 1e-4 and _rel(be, jb) <= 1e-4
    ev, jev = TS.tridiag_eigvals(al, be), S.tridiag_eigvals(ja, jb)
    for a, b in ((ev.min(), jev.min()), (ev.max(), jev.max())):
        assert abs(a - b) <= 1e-4 * abs(b)


@pytest.mark.parametrize("fmt", ["sell", "pjds", "cmrs"])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_block_lanczos_matches_reference(name, fmt):
    jnp, F, M, S, joperator = _jax()
    tm, jm = _pair(name)
    V0 = np.random.default_rng(1).standard_normal((tm.n_rows, 4)).astype(
        np.float32)
    res = TS.block_lanczos(repro_torch.operator(tm, fmt, b_r=32,
                                                device="cpu"),
                           torch.from_numpy(V0), m=6)
    A, B = res
    JA, JB = S.block_lanczos(joperator(jm, fmt, b_r=32), jnp.asarray(V0),
                             m=6)
    assert res.info["host_syncs"] == 1
    assert A.shape == B.shape == (6, 4, 4)
    assert _rel(A, JA) <= 1e-4 and _rel(B, JB) <= 1e-4
    ev, jev = TS.block_tridiag_eigvals(A, B), S.block_tridiag_eigvals(JA, JB)
    for a, b in ((ev.min(), jev.min()), (ev.max(), jev.max())):
        assert abs(a - b) <= 1e-4 * abs(b)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_power_iteration_matches_reference(name):
    jnp, F, M, S, joperator = _jax()
    tm, jm = _pair(name)
    v0 = np.ones(tm.n_rows, np.float32)
    v0[::3] = 2.0
    res = TS.power_iteration(repro_torch.operator(tm, "sell", b_r=32,
                                                  device="cpu"),
                             torch.from_numpy(v0), iters=300)
    v, lam = res
    jv, jl = S.power_iteration(joperator(jm, "sell", b_r=32),
                               jnp.asarray(v0), iters=300)
    assert res.info["host_syncs"] == 1 and lam.dim() == 0
    assert abs(float(lam) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-5


def test_host_eigenvalue_routines_match_reference():
    _, _, _, S, _ = _jax()
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal(12), rng.standard_normal(12)
    np.testing.assert_array_equal(TS.tridiag_eigvals(a, b),
                                  S.tridiag_eigvals(a, b))
    A, B = rng.standard_normal((5, 3, 3)), rng.standard_normal((5, 3, 3))
    np.testing.assert_array_equal(TS.block_tridiag_eigvals(A, B),
                                  S.block_tridiag_eigvals(A, B))


def test_lanczos_finds_the_extremes_of_poisson():
    """The reference's Lanczos test, on the port: the largest Ritz value
    of 60 steps within 1e-3 of the dense spectrum's."""
    m = TM.poisson_2d(16, 16)
    d = np.zeros(m.shape)
    d[np.repeat(np.arange(m.n_rows), m.row_lengths()), m.indices] = m.data
    op = repro_torch.operator(m, device="cpu")
    v0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        m.n_rows).astype(np.float32))
    ev = TS.tridiag_eigvals(*TS.lanczos(op, v0, m=60))
    dense = np.linalg.eigvalsh(d)
    assert abs(ev.max() - dense.max()) < 1e-3 * abs(dense.max())
    # a matvec closure works as well as an operator
    ev2 = TS.tridiag_eigvals(*TS.lanczos(op.matvec, v0, m=60))
    np.testing.assert_array_equal(ev, ev2)


def test_lanczos_over_a_distributed_operator():
    """Four ranks as threads: the dots are summed over the ranks, so
    every rank gets the single-device alphas and betas."""
    tm, _ = _pair("hmep")
    v0 = np.random.default_rng(4).standard_normal(tm.n_rows).astype(
        np.float32)
    al1, be1 = TS.lanczos(repro_torch.operator(tm, "sell", device="cpu"),
                          torch.from_numpy(v0), m=20)

    def body(c):
        op = dist_operator(tm, c, b_r=32, device="cpu")
        res = TS.lanczos(op, op.shard_vector(v0), m=20)
        V0 = np.stack([v0, v0[::-1].copy()], axis=1)
        blk = TS.block_lanczos(op, op.shard_vector(V0), m=4)
        return res, res.info["host_syncs"], blk

    outs = run_ranks(ThreadComm.create(4, "cpu"), body)
    for (al, be), syncs, (A, B) in outs:
        assert syncs == 1
        assert _rel(al, al1) <= 1e-4 and _rel(be, be1) <= 1e-4
        assert torch.equal(A, outs[0][2][0]) and A.shape == (4, 2, 2)


# ------------------------------------------------------------ the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["sell", "cmrs", "pjds"])
def test_eigensolvers_on_card(fmt):
    """On the card: the kernels' Lanczos and block Lanczos within the
    stated tolerances of the CPU's plain versions, one host read each,
    and no plain version on the way."""
    _need_cuda()
    from repro_torch.kernels import ref as TR
    raw = TM.hmep(scale=3e-4)
    rows = np.repeat(np.arange(raw.n_rows), raw.row_lengths())
    d = np.zeros(raw.shape)
    d[rows, raw.indices] = raw.data
    h = TF.csr_from_dense(((d + d.T) / 2).astype(np.float32))
    v0 = np.random.default_rng(5).standard_normal(h.n_rows).astype(
        np.float32)
    TR.reset_calls()
    res = TS.lanczos(repro_torch.operator(h, fmt), torch.from_numpy(v0).cuda(),
                     m=30)
    assert not any(f.calls for f in TR._COUNTED)
    cpu = TS.lanczos(repro_torch.operator(h, fmt, device="cpu"),
                     torch.from_numpy(v0), m=30)
    assert res.info["host_syncs"] == 1
    assert _rel(res[0], cpu[0]) <= 1e-4 and _rel(res[1], cpu[1]) <= 1e-4
    V0 = np.random.default_rng(6).standard_normal((h.n_rows, 4)).astype(
        np.float32)
    blk = TS.block_lanczos(repro_torch.operator(h, fmt),
                           torch.from_numpy(V0).cuda(), m=6)
    blk_c = TS.block_lanczos(repro_torch.operator(h, fmt, device="cpu"),
                             torch.from_numpy(V0), m=6)
    assert _rel(blk[0], blk_c[0]) <= 1e-4 and _rel(blk[1], blk_c[1]) <= 1e-4
