"""Synthetic test matrices: a copy of the reference package's
``repro.core.matrices`` restricted to the generators the port's main
path runs (the sAMG analogue, the 2-D Poisson operator and its
non-symmetric convection variant, BiCGStab's test operator), so both
packages generate identical host matrices from the same seed.

``samg(scale=1.0)`` is the paper's sAMG at its published dimension
(3.4 M rows, N_nzr ~ 7); ``scale`` shrinks the dimension while keeping
the row-length distribution.
"""
from __future__ import annotations

import numpy as np

from .formats import CSRMatrix, csr_from_coo

__all__ = ["samg", "poisson_2d", "convection_poisson"]

# Published statistics (paper §1.3) -- dimension, avg nnz/row.
_PUBLISHED = {
    "sAMG": dict(dim=3_400_000, n_nzr=7),
}


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
