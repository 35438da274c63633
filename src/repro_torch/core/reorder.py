"""Bandwidth-reducing reordering -- the preprocessing stage.

Port of ``repro/core/reorder.py``: the same reverse Cuthill-McKee (RCM)
permutation, symmetric permutation and bandwidth, and the priced entry
point :func:`preprocess`, over this package's ``formats`` and
``perf_model``.  The paper observes (§2.2, §3) that matrices whose
non-zeros scatter across the column space degrade the distributed halo
exchange toward an all-gather; RCM concentrates the non-zeros near the
diagonal, which shrinks the partitioner's halo, and the perf model
decides whether that pays for the permute / unpermute sandwich around
every product.

Pure numpy breadth-first search, as in the reference (a Python loop
over rows: seconds per million rows on the host).

Permutation convention (every function here, and the ``pre_perm``
sandwich of ``kernels.ops.SparseDevice``)::

    perm[k] = old index placed at new position k,
    inv[perm] = arange(n)  (so inv[old] = new position of old index).

:func:`preprocess` prices with the H100 by default
(``spec=perf_model.H100``); the reference prices with the TPU v5e, and
the parity tests pass ``perf_model.TPU_V5E`` to get its decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import perf_model as PM
from .formats import CSRMatrix, csr_from_coo, estimate_storage_elements

__all__ = ["rcm_permutation", "permute_symmetric", "bandwidth",
           "Preprocessed", "preprocess"]


def rcm_permutation(m: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrised adjacency.

    Returns ``perm`` in the module's convention: ``perm[k]`` is the OLD
    row index placed at new position ``k`` — exactly what
    :func:`permute_symmetric` consumes (``B[k, :] = A[perm[k], :]`` up
    to the matching column permutation).  The new position of old row
    ``i`` is therefore ``inv[i]`` with ``inv[perm] = arange(n)``."""
    n = m.n_rows
    # symmetrised adjacency in CSR form (A + A^T pattern)
    rl = np.diff(m.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), rl)
    cols = m.indices.astype(np.int64)
    ar = np.concatenate([rows, cols])
    ac = np.concatenate([cols, rows])
    order = np.lexsort((ac, ar))
    ar, ac = ar[order], ac[order]
    keep = np.ones(len(ar), bool)
    keep[1:] = (ar[1:] != ar[:-1]) | (ac[1:] != ac[:-1])
    ar, ac = ar[keep], ac[keep]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, ar + 1, 1)
    np.cumsum(indptr, out=indptr)

    degree = np.diff(indptr)
    visited = np.zeros(n, bool)
    result = np.empty(n, np.int64)
    pos = 0
    # BFS from minimum-degree node of each component
    remaining = np.argsort(degree, kind="stable")
    rem_i = 0
    while pos < n:
        while rem_i < n and visited[remaining[rem_i]]:
            rem_i += 1
        start = remaining[rem_i]
        visited[start] = True
        result[pos] = start
        head = pos
        pos += 1
        while head < pos:
            u = result[head]
            head += 1
            nbrs = ac[indptr[u]:indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                result[pos:pos + len(nbrs)] = nbrs
                pos += len(nbrs)
    return result[::-1].copy()          # the "reverse" in RCM


def permute_symmetric(m: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """B = P A P^T with perm[k] = old index placed at new position k.

    Square matrices only: the SAME permutation is applied to rows and
    columns, so a rectangular input has no symmetric permutation (and
    indexing the row-sized inverse with column indices would silently
    produce garbage).  The ``sum_duplicates=False`` fast path is safe:
    ``csr_from_coo`` sorts within rows before that branch (see its
    docstring), and a permutation maps distinct (row, col) pairs to
    distinct pairs — no new duplicates to merge."""
    n = m.n_rows
    if m.shape[0] != m.shape[1]:
        raise ValueError(
            f"permute_symmetric requires a square matrix; got {m.shape}")
    perm = np.asarray(perm)
    if perm.shape != (n,):
        raise ValueError(
            f"perm must have shape ({n},) to permute a {m.shape} matrix; "
            f"got {perm.shape}")
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    rl = np.diff(m.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), rl)
    new_rows = inv[rows]
    new_cols = inv[m.indices.astype(np.int64)]
    return csr_from_coo(new_rows, new_cols, m.data.copy(), m.shape,
                        sum_duplicates=False)


def bandwidth(m: CSRMatrix) -> int:
    """max |row - col| over stored entries — the locality metric RCM
    minimises and :func:`preprocess` prices halo traffic with."""
    rl = np.diff(m.indptr)
    rows = np.repeat(np.arange(m.n_rows, dtype=np.int64), rl)
    if len(rows) == 0:
        return 0
    return int(np.abs(rows - m.indices.astype(np.int64)).max())


# --------------------------------------------------------------------------
# The priced preprocessing stage
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Preprocessed:
    """Outcome of :func:`preprocess`.  When ``applied`` is False,
    ``matrix`` is the input object unchanged and the permutations are
    None; otherwise ``matrix = P A P^T`` and the caller must sandwich
    every apply — ``y = B_path(x[perm])[inv_perm]`` — to stay in the
    original basis."""

    matrix: CSRMatrix
    perm: Optional[np.ndarray]
    inv_perm: Optional[np.ndarray]
    applied: bool
    reason: str
    bandwidth_before: int
    bandwidth_after: int
    predicted_off_s: float
    predicted_on_s: float


_PREPROCESS_FMTS = ("ellpack_r", "sell", "pjds", "cmrs")


def _best_format_seconds(rl: np.ndarray, n: int, nnz: int, *,
                         n_dev: int, value_bytes: int, index_bytes: int,
                         vec_bytes: int, spec, calibration) -> float:
    """Cheapest predicted single-chip spMVM time over the blocked
    formats for the given ROW-LENGTH ORDER (sell/cmrs storage depends on
    it; dispatch re-decides the actual format later).  Distributed
    callers price the per-device slice (uniform 1-D row split)."""
    n_loc = -(-n // n_dev)
    best = np.inf
    for fmt in _PREPROCESS_FMTS:
        elems = estimate_storage_elements(rl, fmt)
        ib = index_bytes + (PM.CMRS_RIS_BYTES if fmt == "cmrs" else 0)
        t = PM.predicted_spmv_seconds(
            -(-elems // n_dev), n_loc, max(nnz / max(n, 1), 1.0),
            perm_bytes=PM.perm_traffic_bytes(
                n_loc, vec_bytes, window_local=(fmt != "pjds")),
            spec=spec, value_bytes=value_bytes, index_bytes=ib,
            vec_bytes=vec_bytes, fmt=fmt, calibration=calibration)
        if fmt == "cmrs":
            t = max(t, PM.cmrs_reduce_seconds(-(-elems // n_dev), 128, spec))
        best = min(best, t)
    return float(best)


def _gathered_halo_elements(rows: np.ndarray, cols: np.ndarray,
                            n: int, n_dev: int) -> float:
    """Mean per-device count of UNIQUE remote x entries under a uniform
    1-D row partition — what the gathered halo exchange ships
    (``dist_spmv.comm_bytes_per_device`` measures the same quantity on
    the built partition)."""
    if n_dev <= 1 or len(rows) == 0:
        return 0.0
    n_loc = -(-n // n_dev)
    dev_r = rows // n_loc
    remote = dev_r != cols // n_loc
    if not remote.any():
        return 0.0
    pairs = np.unique(dev_r[remote] * np.int64(n) + cols[remote])
    return len(pairs) / n_dev


def preprocess(m: CSRMatrix, reorder: str = "auto", *,
               n_dev: int = 1,
               spec: PM.TPUSpec = PM.H100,
               calibration="default",
               min_gain: float = 0.02,
               value_bytes: Optional[int] = None,
               vec_bytes: Optional[int] = None,
               sandwich: bool = True) -> Preprocessed:
    """The priced RCM preprocessing stage.

    ``"off"`` returns the input untouched; ``"rcm"`` always applies the
    permutation (raising on non-square input); ``"auto"`` applies it
    only when the model predicts a win of at least ``min_gain``
    (relative) — comparing, per matvec,

    * single chip: the best blocked format's predicted time on the
      ORIGINAL row-length order vs the REORDERED order plus the
      unfusable permute/unpermute sandwich
      (``2 * perm_traffic_bytes(n)``) the operator wraps around the
      stored matrix;
    * ``n_dev > 1``: the same per-device-slice terms plus the gathered
      halo-exchange time (``t_link_gathered``) over the EXACT per-device
      unique remote-column counts of a uniform 1-D row partition, before
      vs after reordering — the paper's §2.2 locality argument, priced
      instead of assumed.

    ``sandwich=False`` prices a caller that permutes once per solve
    instead of around every product (``core.operator.dist_operator``
    permutes at shard / gather time); the default charges the sandwich,
    as the reference always does.

    Both sides use the installed :class:`perf_model.Calibration` (pass
    ``calibration=None`` for data-sheet numbers), so "auto" follows the
    measured machine whenever one was calibrated.  ``spec`` defaults to
    the H100 (the reference's to the TPU v5e).  Non-square or empty
    matrices: "auto" quietly skips, "rcm" raises (RCM is a symmetric
    permutation).
    """
    if reorder not in ("off", "auto", "rcm"):
        raise ValueError(f"reorder must be 'off', 'auto' or 'rcm'; "
                         f"got {reorder!r}")
    bw0 = bandwidth(m)
    skip = None
    if reorder == "off":
        skip = "off"
    elif m.shape[0] != m.shape[1]:
        if reorder == "rcm":
            raise ValueError(
                f"reorder='rcm' requires a square matrix; got {m.shape}")
        skip = "non_square"
    elif m.nnz == 0:
        if reorder == "rcm":
            raise ValueError("reorder='rcm' on an empty matrix")
        skip = "empty"
    if skip is not None:
        return Preprocessed(m, None, None, False, skip, bw0, bw0,
                            float("nan"), float("nan"))

    if value_bytes is None:
        value_bytes = m.data.dtype.itemsize
    if vec_bytes is None:
        vec_bytes = max(4, value_bytes)
    n, nnz = m.n_rows, m.nnz
    perm = rcm_permutation(m)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    rl = m.row_lengths()
    rows = np.repeat(np.arange(n, dtype=np.int64), rl)
    cols = m.indices.astype(np.int64)
    bw1 = int(np.abs(inv[rows] - inv[cols]).max(initial=0))

    index_bytes = m.indices.dtype.itemsize
    price = dict(n_dev=n_dev, value_bytes=value_bytes,
                 index_bytes=index_bytes, vec_bytes=vec_bytes,
                 spec=spec, calibration=calibration)
    t_off = _best_format_seconds(rl, n, nnz, **price)
    # Row lengths of B = P A P^T are rl[perm] — order is all that
    # changes, and order is what sell/cmrs storage estimates react to.
    t_on = _best_format_seconds(rl[perm], n, nnz, **price)
    # The outer sandwich is NOT fusable into the kernels: one gather of
    # x into the permuted basis, one of y back out, per matvec.
    cal = PM.get_calibration() if calibration == "default" else calibration
    bw_scale = cal.bw_scale if cal is not None else 1.0
    if sandwich:
        t_on += 2 * PM.perm_traffic_bytes(n, vec_bytes) / (
            spec.hbm_bw * bw_scale)
    if n_dev > 1:
        halo0 = _gathered_halo_elements(rows, cols, n, n_dev)
        halo1 = _gathered_halo_elements(inv[rows], inv[cols], n, n_dev)
        t_off += PM.t_link_gathered(halo0, spec.ici_bw,
                                    value_bytes=vec_bytes, msgs=2,
                                    calibration=calibration)
        t_on += PM.t_link_gathered(halo1, spec.ici_bw,
                                   value_bytes=vec_bytes, msgs=2,
                                   calibration=calibration)

    apply = (reorder == "rcm") or (t_on < t_off * (1.0 - min_gain))
    if not apply:
        return Preprocessed(m, None, None, False,
                            f"predicted_loss: on={t_on:.3e}s off={t_off:.3e}s",
                            bw0, bw1, t_off, t_on)
    reason = ("forced" if reorder == "rcm"
              else f"predicted_gain: on={t_on:.3e}s off={t_off:.3e}s")
    return Preprocessed(permute_symmetric(m, perm), perm, inv, True,
                        reason, bw0, bw1, t_off, t_on)
