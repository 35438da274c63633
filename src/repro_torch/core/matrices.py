"""Synthetic test matrices: a copy of the reference package's
``repro.core.matrices``, so both packages generate identical host
matrices from the same seed.

The generators reproduce the row-length statistics of the paper's five
test matrices (§1.3, Fig. 3) -- dimension, average non-zeros per row
N_nzr, row-length spread and characteristic substructure (off-diagonals
for HMEp, dense 5x5 blocks for DLR2, ...); the values are random but
deterministic per seed.  Each takes a ``scale`` that shrinks the
dimension while keeping N_nzr and the row-length distribution:
``samg(scale=1.0)`` is the sAMG analogue at its published 3.4 M rows,
``hmep(scale=1.0)`` HMEp at 6.2 M.  ``power_law`` is the dispatch's
worst case (Zipf row lengths), ``poisson_2d`` and ``convection_poisson``
the SPD and non-symmetric solver test operators.
"""
from __future__ import annotations

import numpy as np

from .formats import CSRMatrix, csr_from_coo

__all__ = [
    "hmep",
    "samg",
    "dlr1",
    "dlr2",
    "uhbr",
    "TEST_MATRICES",
    "make_test_matrix",
    "poisson_2d",
    "convection_poisson",
    "power_law",
]

# Published statistics (paper §1.3) -- dimension, avg nnz/row.
_PUBLISHED = {
    "HMEp": dict(dim=6_200_000, n_nzr=15),
    "sAMG": dict(dim=3_400_000, n_nzr=7),
    "DLR1": dict(dim=280_000, n_nzr=144),
    "DLR2": dict(dim=540_000, n_nzr=315),
    "UHBR": dict(dim=4_500_000, n_nzr=123),
}



def _dedup_clip(rows, cols, vals, n):
    keep = (cols >= 0) & (cols < n)
    return rows[keep], cols[keep], vals[keep]


def hmep(scale: float = 0.01, seed: int = 0) -> CSRMatrix:
    """Holstein-Hubbard model matrix analogue: very sparse (~15 nnz/row)
    with contiguous off-diagonals (published length 15 000, scaled)."""
    rng = np.random.default_rng(seed)
    n = max(int(_PUBLISHED["HMEp"]["dim"] * scale), 256)
    off_len = max(int(15_000 * scale * 4), 8)  # off-diagonal offset magnitude
    rows_l, cols_l, vals_l = [], [], []
    idx = np.arange(n)
    # main diagonal + a few contiguous off-diagonals (hopping terms)
    offsets = [0, 1, -1, off_len, -off_len, 3 * off_len, -3 * off_len]
    for off in offsets:
        r = idx
        c = idx + off
        v = rng.standard_normal(n)
        r, c, v = _dedup_clip(r, c, v, n)
        rows_l.append(r), cols_l.append(c), vals_l.append(v)
    # phonon coupling: ~8 extra scattered entries/row, row count varies
    extra = rng.poisson(8.0, size=n)
    tot = int(extra.sum())
    r = np.repeat(idx, extra)
    c = rng.integers(0, n, size=tot)
    v = rng.standard_normal(tot)
    rows_l.append(r), cols_l.append(c), vals_l.append(v)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    return csr_from_coo(rows, cols, vals, (n, n))


def samg(scale: float = 0.01, seed: int = 1) -> CSRMatrix:
    """Adaptive-multigrid Poisson analogue: N_nzr ~ 7, longest row > 4x the
    shortest, weight concentrated on short rows (paper Fig. 3)."""
    rng = np.random.default_rng(seed)
    n = max(int(_PUBLISHED["sAMG"]["dim"] * scale), 256)
    # row lengths: mostly 4-8 (short), heavy tail to ~30
    rl = np.clip(rng.geometric(0.35, size=n) + 3, 4, 30)
    tot = int(rl.sum())
    rows = np.repeat(np.arange(n), rl)
    # unstructured mesh neighbours: local band + occasional long-range
    jitter = rng.integers(-50, 51, size=tot)
    cols = np.clip(rows + jitter, 0, n - 1)
    far = rng.random(tot) < 0.05
    cols[far] = rng.integers(0, n, size=int(far.sum()))
    vals = rng.standard_normal(tot)
    m = csr_from_coo(rows, cols, vals, (n, n))
    return _spd_shift(m)


def dlr1(scale: float = 0.05, seed: int = 2) -> CSRMatrix:
    """Adjoint CFD (TAU) analogue: N_nzr ~ 144, narrow spread
    (max/min ~ 2; 80% of rows >= 0.8 * max)."""
    rng = np.random.default_rng(seed)
    n = max(int(_PUBLISHED["DLR1"]["dim"] * scale), 512)
    max_rl = 160
    rl = np.where(
        rng.random(n) < 0.8,
        rng.integers(int(0.8 * max_rl), max_rl + 1, size=n),
        rng.integers(max_rl // 2, int(0.8 * max_rl), size=n),
    )
    return _banded_random(n, rl, band=400, rng=rng)


def dlr2(scale: float = 0.05, seed: int = 3) -> CSRMatrix:
    """Aerodynamic-gradients analogue: N_nzr ~ 315, built entirely of dense
    5x5 subblocks (paper: '...consists entirely of dense 5x5 subblocks')."""
    rng = np.random.default_rng(seed)
    n_pts = max(int(_PUBLISHED["DLR2"]["dim"] * scale) // 5, 128)
    n = n_pts * 5
    nbrs_per_pt = 315 // 5  # 63 block-neighbours -> ~315 nnz/row
    rows_l, cols_l, vals_l = [], [], []
    for pt in range(n_pts):
        k = max(int(rng.normal(nbrs_per_pt, 8)), 8)
        nb = np.unique(
            np.clip(pt + rng.integers(-200, 201, size=k), 0, n_pts - 1)
        )
        # dense 5x5 block for each neighbour pair
        bi, bj = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
        for q in nb:
            rows_l.append(pt * 5 + bi.ravel())
            cols_l.append(q * 5 + bj.ravel())
        vals_l.append(rng.standard_normal(len(nb) * 25))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    return csr_from_coo(rows, cols, vals, (n, n))


def uhbr(scale: float = 0.01, seed: int = 4) -> CSRMatrix:
    """UHBR turbine-fan (TRACE) analogue: large dimension, N_nzr ~ 123,
    moderate spread."""
    rng = np.random.default_rng(seed)
    n = max(int(_PUBLISHED["UHBR"]["dim"] * scale), 512)
    rl = np.clip(rng.normal(123, 30, size=n).astype(np.int64), 20, 220)
    return _banded_random(n, rl, band=600, rng=rng)


def _banded_random(n, rl, band, rng) -> CSRMatrix:
    tot = int(rl.sum())
    rows = np.repeat(np.arange(n), rl)
    jitter = rng.integers(-band, band + 1, size=tot)
    cols = np.clip(rows + jitter, 0, n - 1)
    vals = rng.standard_normal(tot)
    return csr_from_coo(rows, cols, vals, (n, n))


def _spd_shift(m: CSRMatrix) -> CSRMatrix:
    """Add a diagonal shift so Krylov examples converge.  The result is
    strongly diagonally dominant but NOT symmetric: only the diagonal
    changes."""
    n = m.shape[0]
    rl = m.row_lengths()
    shift = float(np.abs(m.data).max(initial=1.0)) * (int(rl.max(initial=1)) + 1)
    diag_rows = np.arange(n)
    rows = np.concatenate([np.repeat(np.arange(n), rl), diag_rows])
    cols = np.concatenate([m.indices, diag_rows])
    vals = np.concatenate([m.data, np.full(n, shift, dtype=m.data.dtype)])
    return csr_from_coo(rows, cols, vals, (n, n))


def power_law(n: int = 4096, seed: int = 7, exponent: float = 1.6,
              min_rl: int = 2) -> CSRMatrix:
    """Zipf-distributed row lengths — the extreme row-length-variance
    case (scale-free graphs, web/social adjacency) where the formats
    diverge most: ELLPACK pads every row to the rare hub length, pJDS
    needs a global sort to avoid that, SELL-C-sigma bounds the sort.
    The format-dispatch benchmarks and tests use this as the worst-case
    pattern alongside the paper's five matrices."""
    rng = np.random.default_rng(seed)
    rl = np.clip(rng.zipf(exponent, size=n) + min_rl - 1, min_rl, n // 4)
    tot = int(rl.sum())
    rows = np.repeat(np.arange(n), rl)
    cols = rng.integers(0, n, size=tot)
    vals = rng.standard_normal(tot)
    return csr_from_coo(rows, cols, vals, (n, n))


def poisson_2d(nx: int = 64, ny: int = 64) -> CSRMatrix:
    """5-point Laplacian on an nx x ny grid -- the SPD solver test
    operator."""
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    rows_l, cols_l, vals_l = [], [], []
    rows_l.append(idx.ravel()); cols_l.append(idx.ravel())
    vals_l.append(np.full(n, 4.0))
    for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
        src = idx.take(range(max(0, shift), idx.shape[axis] + min(0, shift)), axis=axis)
        dst = idx.take(range(max(0, -shift), idx.shape[axis] + min(0, -shift)), axis=axis)
        rows_l.append(src.ravel()); cols_l.append(dst.ravel())
        vals_l.append(np.full(src.size, -1.0))
    rows = np.concatenate(rows_l); cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    return csr_from_coo(rows, cols, vals, (n, n))


def convection_poisson(nx: int = 64, ny: int = 64,
                       beta: float = 0.5) -> CSRMatrix:
    """Poisson + upwind convection skew on the fast-axis neighbours
    (entries at col == row +- 1, which in ``poisson_2d`` exist only for
    true grid neighbours): non-symmetric, with a positive-definite
    symmetric part for |beta| < 1 -- the BiCGStab test operator.  Values
    are stored float32, as the reference stores them."""
    m = poisson_2d(nx, ny)
    rows = np.repeat(np.arange(m.n_rows), np.diff(m.indptr))
    cols = m.indices.astype(np.int64)
    data = m.data.astype(np.float64).copy()
    data[cols == rows + 1] += beta
    data[cols == rows - 1] -= beta
    return CSRMatrix(m.indptr, m.indices, data.astype(np.float32), m.shape)


TEST_MATRICES = {
    "HMEp": hmep,
    "sAMG": samg,
    "DLR1": dlr1,
    "DLR2": dlr2,
    "UHBR": uhbr,
}


def make_test_matrix(name: str, scale: float | None = None, seed: int | None = None) -> CSRMatrix:
    fn = TEST_MATRICES[name]
    kwargs = {}
    if scale is not None:
        kwargs["scale"] = scale
    if seed is not None:
        kwargs["seed"] = seed
    return fn(**kwargs)
