"""The port's copies of the paper's matrix generators against the
reference's: the same seed and scale build bit-identical arrays
(``indptr``, ``indices``, ``data``, dtype included) for HMEp, DLR1,
DLR2, UHBR, the power-law worst case, and through ``TEST_MATRICES`` /
``make_test_matrix``.  Tolerance: none -- the arrays are compared
exactly.  Sizes are cut to a few hundred to a few thousand rows (each
generator's floor).
"""
import numpy as np
import pytest

from repro_torch.core import matrices as TM


def _ref():
    pytest.importorskip("jax")
    from repro.core import matrices as M
    return M


def _same(tm, jm):
    assert tm.shape == jm.shape
    for f in ("indptr", "indices", "data"):
        a, b = getattr(tm, f), getattr(jm, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name,kw", [
    pytest.param("hmep", dict(scale=1e-4), id="hmep-620"),
    pytest.param("hmep", dict(scale=3e-4, seed=5), id="hmep-1860-seed5"),
    pytest.param("dlr1", dict(scale=0.002), id="dlr1-560"),
    pytest.param("dlr2", dict(scale=0.0012), id="dlr2-640"),
    pytest.param("uhbr", dict(scale=1e-4), id="uhbr-512"),
    pytest.param("uhbr", dict(scale=2e-4, seed=9), id="uhbr-900-seed9"),
    pytest.param("power_law", dict(n=700), id="power_law-700"),
    pytest.param("power_law", dict(n=512, seed=3, exponent=2.1, min_rl=3),
                 id="power_law-512-zipf2.1"),
])
def test_generator_matches_reference(name, kw):
    M = _ref()
    _same(getattr(TM, name)(**kw), getattr(M, name)(**kw))


def test_test_matrices_table_matches_reference():
    M = _ref()
    assert sorted(TM.TEST_MATRICES) == sorted(M.TEST_MATRICES)
    for name in TM.TEST_MATRICES:
        assert TM.TEST_MATRICES[name].__name__ == \
            M.TEST_MATRICES[name].__name__


@pytest.mark.parametrize("name,scale,seed", [
    ("HMEp", 1e-4, None), ("sAMG", 1e-4, 3), ("DLR1", 0.002, None),
    ("DLR2", 0.0012, 1), ("UHBR", 1e-4, None)])
def test_make_test_matrix_matches_reference(name, scale, seed):
    M = _ref()
    _same(TM.make_test_matrix(name, scale=scale, seed=seed),
          M.make_test_matrix(name, scale=scale, seed=seed))


def test_published_statistics_hold_at_small_scale():
    """The structural statistics the paper's analysis rests on: HMEp's
    ~15 non-zeros per row with its contiguous off-diagonals, DLR2's
    dense 5 x 5 blocks."""
    h = TM.hmep(scale=3e-4)
    assert 12 < h.n_nzr < 16
    d = TM.dlr2(scale=0.0012)
    assert d.n_rows % 5 == 0
    rl = d.row_lengths()
    assert np.all(rl % 5 == 0)           # whole 5 x 5 blocks per row
