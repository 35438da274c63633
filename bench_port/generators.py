"""Frozen generators of the benchmark's matrices, as host CSR arrays.

The arrays equal those of the port's ``core.matrices.poisson_2d`` and
``core.matrices.samg`` at the same arguments, bit for bit
(``tests/test_bench_port_generators.py``), so the benchmark's inputs
stay fixed whatever later changes make to the program.  They are built
without the port's general COO path: Poisson's rows directly in CSR
order, sAMG's with one stable sort and duplicates summed in the same
order as ``np.add.at`` sums them.  Nothing here imports the program.

A configuration file names its generator under ``"generator"`` and its
arguments under ``"args"``; :func:`generate` returns
``(indptr int64, indices int32, data float64, shape)``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["GENERATORS", "generate", "poisson_2d", "samg"]


def _csr_sum_sorted(rows, cols, vals, n_rows: int, n_cols: int):
    """CSR of COO triplets, columns ascending within a row, duplicates
    summed in their order of appearance starting from 0.0: the arrays of
    ``lexsort`` + ``unique`` + ``np.add.at``."""
    key = rows * n_cols + cols
    order = np.argsort(key, kind="stable")
    key = key[order]
    vals = vals[order]
    first = np.empty(len(key), dtype=bool)
    first[:1] = True
    np.not_equal(key[1:], key[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    sizes = np.diff(np.append(starts, len(key)))
    summed = np.zeros(len(starts), dtype=vals.dtype)
    for k in range(int(sizes.max(initial=0))):
        g = np.flatnonzero(sizes > k)
        summed[g] += vals[starts[g] + k]
    ukey = key[starts]
    r = ukey // n_cols
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n_rows), out=indptr[1:])
    return indptr, (ukey % n_cols).astype(np.int32), summed


def poisson_2d(nx: int, ny: int):
    """The 5-point Laplacian on an nx x ny grid (4 on the diagonal, -1
    to each grid neighbour), row-major grid numbering."""
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    a, b = idx // ny, idx % ny
    cand = np.stack([idx - ny, idx - 1, idx, idx + 1, idx + ny], axis=1)
    valid = np.stack([a > 0, b > 0, np.ones(n, dtype=bool), b < ny - 1,
                      a < nx - 1], axis=1)
    coef = np.broadcast_to(np.array([-1.0, -1.0, 4.0, -1.0, -1.0]), (n, 5))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=indptr[1:])
    return indptr, cand[valid].astype(np.int32), coef[valid].copy(), (n, n)


def samg(scale: float, seed: int):
    """The paper's sAMG analogue (adaptive multigrid, N_nzr ~ 7, row
    lengths 4-30): a local band of +-50 with 5 % long-range entries,
    random values, then a diagonal shift of max(|a|, 1) times (longest
    row + 1), added to the stored diagonal where there is one."""
    rng = np.random.default_rng(seed)
    n = max(int(3_400_000 * scale), 256)
    rl = np.clip(rng.geometric(0.35, size=n) + 3, 4, 30)
    tot = int(rl.sum())
    rows = np.repeat(np.arange(n), rl)
    jitter = rng.integers(-50, 51, size=tot)
    cols = np.clip(rows + jitter, 0, n - 1)
    far = rng.random(tot) < 0.05
    cols[far] = rng.integers(0, n, size=int(far.sum()))
    vals = rng.standard_normal(tot)
    indptr, indices, data = _csr_sum_sorted(rows, cols, vals, n, n)
    del rows, cols, vals, jitter, far

    lens = np.diff(indptr)
    shift = float(np.abs(data).max(initial=1.0)) * (int(lens.max(initial=1))
                                                     + 1)
    row_of = np.repeat(np.arange(n), lens)
    on_diag = indices == row_of
    has_diag = np.zeros(n, dtype=bool)
    has_diag[row_of[on_diag]] = True
    data = data.copy()
    data[on_diag] = (0.0 + data[on_diag]) + shift
    # rows without a stored diagonal get (0 + shift) after their last
    # entry left of the diagonal
    new_rows = np.flatnonzero(~has_diag)
    before = np.searchsorted(  # entries of the row left of the diagonal
        row_of * n + indices, new_rows * n + new_rows)
    indices = np.insert(indices, before, new_rows.astype(np.int32))
    data = np.insert(data, before, 0.0 + shift)
    add = np.zeros(n + 1, dtype=np.int64)
    add[1:] = np.cumsum(~has_diag)
    return indptr + add, indices, data, (n, n)


GENERATORS = {"poisson_2d": poisson_2d, "samg": samg}


def generate(name: str, args: dict, seed: int):
    """The arrays of generator ``name`` with ``args``; a generator that
    takes a seed gets ``seed``."""
    fn = GENERATORS[name]
    if name == "samg":
        return fn(seed=seed, **args)
    return fn(**args)
