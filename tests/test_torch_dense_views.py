"""The port's dense views (``formats.csr_to_dense``, ``pjds_to_dense``,
``sell_to_dense``) against the reference's, bit for bit (same dtype,
``np.array_equal`` with NaNs equal) on sAMG, Poisson and random CSR
matrices, every pJDS / SELL layout option, and inputs with a repeated
column and stored zeros.
"""
import numpy as np
import pytest

from repro.core import formats as F
from repro.core import matrices as M
from repro_torch.core import formats as TF


def _random_csr(n_rows, n_cols, density, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_rows, n_cols)).astype(dtype)
    a[rng.random((n_rows, n_cols)) > density] = 0
    return F.csr_from_dense(a)


_MATS = {
    "samg": lambda: M.samg(scale=0.0005),
    "poisson": lambda: M.poisson_2d(24, 17),
    "random_square": lambda: _random_csr(300, 300, 0.05, 0),
    "random_wide": lambda: _random_csr(130, 257, 0.1, 1),
    "random_f64": lambda: _random_csr(200, 200, 0.08, 2, np.float64),
    "empty_rows": lambda: _random_csr(260, 260, 0.002, 3),
}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("name", sorted(_MATS))
def test_csr_to_dense(name):
    m = _MATS[name]()
    _same(TF.csr_to_dense(m), F.csr_to_dense(m))


@pytest.mark.parametrize("name", sorted(_MATS))
@pytest.mark.parametrize("b_r,permuted", [(128, True), (32, False),
                                          (8, True)])
def test_pjds_to_dense(name, b_r, permuted):
    m = _MATS[name]()
    if permuted and m.shape[0] != m.shape[1]:
        permuted = False
    p = F.csr_to_pjds(m, b_r=b_r, permuted_cols=permuted)
    _same(TF.pjds_to_dense(p), F.pjds_to_dense(p))
    _same(TF.pjds_to_dense(p), F.csr_to_dense(m))


@pytest.mark.parametrize("name", sorted(_MATS))
@pytest.mark.parametrize("sigma", [32, 128, 1024])
def test_sell_to_dense(name, sigma):
    m = _MATS[name]()
    s = F.csr_to_sell(m, c=32, sigma=sigma,
                      permuted_cols=m.shape[0] == m.shape[1])
    _same(TF.sell_to_dense(s), F.sell_to_dense(s))


def test_the_ports_own_layouts_densify_alike():
    m = M.samg(scale=0.0005)
    p = TF.csr_to_pjds(m)
    _same(TF.pjds_to_dense(p), F.pjds_to_dense(p))
    s = TF.csr_to_sell(m, sigma=64)
    _same(TF.sell_to_dense(s), F.sell_to_dense(s))


def test_repeated_columns_stored_zeros_and_non_finite():
    """A repeated (row, column) keeps the CSR loop's last value and the
    pJDS loop's sum in diagonal order; stored zeros are skipped; NaN and
    inf pass through."""
    indptr = np.array([0, 3, 5, 5, 8], np.int64)
    indices = np.array([1, 1, 3, 0, 2, 0, 0, 3], np.int32)
    data = np.array([1.0, 2.5, 0.0, np.nan, -1.0, 1e-38, 3e38, np.inf],
                    np.float32)
    m = F.CSRMatrix(indptr, indices, data, (4, 4))
    tm = TF.CSRMatrix(indptr, indices, data, (4, 4))
    _same(TF.csr_to_dense(tm), F.csr_to_dense(m))
    p = F.PJDSMatrix(
        val=np.array([[1.0, np.nan, 3e38, 0.0], [2.5, -1.0, 3e38, 0.0]],
                     np.float32),
        col_idx=np.array([[1, 0, 0, 0], [1, 2, 0, 0]], np.int32),
        block_start=np.array([0, 2], np.int32),
        block_len=np.array([2], np.int32),
        rowlen=np.array([2, 2, 2, 0], np.int32),
        perm=np.array([0, 1, 3, 2], np.int32),
        inv_perm=np.array([0, 1, 3, 2], np.int32),
        shape=(4, 4), b_r=4, n_rows_pad=4, permuted_cols=False)
    _same(TF.pjds_to_dense(p), F.pjds_to_dense(p))
