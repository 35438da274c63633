"""The yardstick at tiny sizes on the CPU: the frozen generators against
the port's, the byte counts against hand counts, the reference against
dense products, the trace reduction on a hand-made trace."""
import numpy as np
import pytest

from bench_port import generators as G
from bench_port import reference as R
from bench_port import roofline as RF
from bench_port import tracing as T


@pytest.mark.parametrize("nx,ny", [(7, 5), (1, 9), (64, 48), (33, 1)])
def test_poisson_equals_the_ports(nx, ny):
    from repro_torch.core import matrices as TM
    indptr, indices, data, shape = G.poisson_2d(nx, ny)
    m = TM.poisson_2d(nx, ny)
    assert shape == m.shape
    for got, want in ((indptr, m.indptr), (indices, m.indices),
                      (data, m.data)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale,seed", [(0.0001, 0), (0.001, 5),
                                        (0.003, 2 ** 31 + 7),
                                        (0.002, 6_000_000_000)])
def test_samg_equals_the_ports_bit_for_bit(scale, seed):
    from repro_torch.core import matrices as TM
    indptr, indices, data, shape = G.samg(scale, seed)
    m = TM.samg(scale, seed)
    assert shape == m.shape
    np.testing.assert_array_equal(indptr, m.indptr)
    np.testing.assert_array_equal(indices, m.indices)
    assert indices.dtype == m.indices.dtype and data.dtype == m.data.dtype
    np.testing.assert_array_equal(data.view(np.int64), m.data.view(np.int64))


def test_byte_counts_by_hand():
    # 3 x 4 CSR with 5 nnz: values and indices 5 * 8, offsets 4 * 4
    assert RF.csr_bytes(3, 5) == 40 + 16
    # + x (4 entries) and y (3 entries), 4 bytes each
    assert RF.spmv_bytes(3, 4, 5) == 56 + 28
    # square 3 x 3, 5 nnz: CSR 56 + nine passes over 3-word vectors
    assert RF.cg_iteration_bytes(3, 5) == 56 + 9 * 3 * 4
    assert RF.bound_seconds(3.35e12) == pytest.approx(1.0)


def test_reference_against_dense_products():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((9, 7)) * (rng.random((9, 7)) < 0.4)
    rows, cols = np.nonzero(a)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=9))])
    a64 = R.csr_f64(indptr, cols.astype(np.int32), a[rows, cols], a.shape)
    x = rng.standard_normal(7)
    y = rng.standard_normal(9)
    np.testing.assert_allclose(a64 @ x, a @ x, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(a64.T @ y, a.T @ y, rtol=1e-14, atol=1e-14)
    assert R.rel_err(a @ x, a @ x) == 0.0
    assert R.rel_err(a @ x + 1e-3 * abs(a @ x).max(), a @ x) == \
        pytest.approx(1e-3)
    assert R.rel_err(np.full(9, np.nan), a @ x) == float("inf")
    sq = a[:7] + 10 * np.eye(7)
    rows, cols = np.nonzero(sq)
    ip = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=7))])
    s64 = R.csr_f64(ip, cols.astype(np.int32), sq[rows, cols], sq.shape)
    b = sq @ x
    assert R.rel_residual(s64, b, x) < 1e-15
    assert R.rel_residual(s64, b, np.zeros(7)) == pytest.approx(1.0)


def test_bf16_rounding_and_product():
    v = np.array([1.0, 1.00390625, 1.005859375, -3.0e-3, 2.0 ** -130],
                 dtype=np.float32)
    r = R.to_bf16(v)
    # 1 + 2^-8 is a tie between 1 and 1 + 2^-7: to even, 1
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == np.float32(1.0078125)
    assert abs(r[3] - v[3]) <= abs(v[3]) * 2 ** -8
    ip, ix, d, sh = G.poisson_2d(4, 3)
    x = np.linspace(-1, 1, 12).astype(np.float32)
    dense = np.zeros(sh)
    dense[np.repeat(np.arange(sh[0]), np.diff(ip)), ix] = d
    y = R.spmv_bf16(ip, ix, d.astype(np.float32), sh, x)
    want = dense @ R.to_bf16(x).astype(np.float64)
    assert R.rel_err(y, want) <= 2 ** -7


def test_cg_plain_solves_a_small_poisson():
    ip, ix, d, sh = G.poisson_2d(6, 5)
    a64 = R.csr_f64(ip, ix, d, sh)
    b = np.ones(sh[0])
    x, k = R.cg_plain(lambda p: a64 @ p, b, tol=1e-10, maxiter=500)
    assert R.rel_residual(a64, b, x) < 1e-9 and 0 < k <= 30


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


def test_trace_summary_by_hand():
    trace = {"traceEvents": [
        _ev("user_annotation", "bench.slice", 0, 100),
        _ev("user_annotation", "bench.spmv", 10, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=7),
        _ev("kernel", "k1", 20, 30, correlation=7),
        _ev("kernel", "k2", 40, 20, correlation=8),   # overlaps k1
        _ev("user_annotation", "bench.rmatvec", 70, 5),
        _ev("cpu_op", "aten::item", 71, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 72, 1, correlation=9),
        _ev("kernel", "k3", 90, 20, correlation=9),    # past the slice
        _ev("gpu_memcpy", "Memcpy DtoH", 85, 2),
    ]}
    s = T.summarize(trace)
    assert s["window_s"] == pytest.approx(100e-6)
    # union of [20, 60], [85, 87], [90, 100]
    assert s["busy_s"] == pytest.approx(52e-6)
    assert s["span_device_s"] == pytest.approx({"spmv": 30e-6,
                                                "rmatvec": 20e-6})
    assert s["span_calls"] == {"spmv": 1, "rmatvec": 1}
    assert dict((k, v) for k, v in s["device_ops"])["k3"] == \
        pytest.approx(20e-6)
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    # [0, 20] before any span, [60, 85] at 60: no span covers it;
    # [87, 90] neither
    assert gaps["outside any span"] == pytest.approx(48e-6)
    card = T.device_busy(trace, 200e-6)       # a card-only slice
    assert card == pytest.approx({"window_s": 200e-6, "busy_s": 62e-6})
    assert T.idle_share({"trace": dict(s, card_only=card)}) == \
        pytest.approx(69.0)
    with pytest.raises(ValueError):
        T.summarize({"traceEvents": []})


def test_reservoir_is_uniform_and_keeps_the_last():
    from bench_port.drivers._common import Reservoir
    counts = np.zeros(100)
    for seed in range(400):
        r = Reservoir(5, seed)
        for i in range(100):
            r.offer(i, i)
        items = r.items()
        assert items[-1][0] == 99 and len(items) in (5, 6)
        for i, _ in items[:5]:
            counts[i] += 1
    # each call is kept with probability 5 / 100
    assert counts.sum() == 2000 and counts.max() < 45 and counts.min() > 4
