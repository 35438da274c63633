"""Host-side (numpy) storage formats: CSR, ELLPACK-R, pJDS, SELL-C-sigma
and CMRS.

A copy of the reference package's ``repro.core.formats`` restricted to
what the port's main path uses, so that both packages build
bit-identical host arrays from the same CSR matrix.  The one change is
in the fills of :func:`_pjds_with_perm`, :func:`csr_to_ell` and
:func:`csr_to_cmrs` (and the padding audit): the reference's per-row or
per-strip Python loops are vectorised into one scatter over all stored
entries, which turns loops of many seconds at the paper's 3.4 M-row
sAMG size into well under a second each; the arrays they build are
identical (``tests/test_torch_formats.py`` holds them equal).

Layout of the blocked arrays: ``val``/``col_idx`` have shape
``(total_jds, b_r)`` -- jagged diagonals major, rows minor -- which is
the paper's column-major ELLPACK layout restricted to one block of
``b_r`` sorted rows.  On the GPU one thread owns one row lane of a
block, so a diagonal ``val[j, :]`` is one coalesced load of ``b_r``
values.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import numpy as np

__all__ = [
    "CSRMatrix",
    "ELLMatrix",
    "PJDSMatrix",
    "SELLMatrix",
    "CMRSMatrix",
    "csr_from_dense",
    "csr_from_coo",
    "validate_csr",
    "CSRValidationError",
    "ValidationReport",
    "csr_to_ell",
    "ell_to_dense",
    "csr_to_pjds",
    "csr_to_sell",
    "csr_to_cmrs",
    "cmrs_to_dense",
    "windowed_sort_perm",
    "windowed_block_lengths",
    "csr_transpose",
    "csr_diagonal",
    "estimate_storage_elements",
    "structural_fingerprint",
    "csr_remote_columns_by_distance",
    "PAD_COL",
    "min_index_dtype",
    "resolve_index_dtype",
    "assert_padding_invariant",
    "storage_elements",
    "format_nbytes",
    "data_reduction_vs_ellpack",
]

_DEFAULT_BR = 128          # rows per pJDS block (one CTA of row lanes)
_DEFAULT_DIAG_ALIGN = 8    # jagged-diagonal padding

# Padding sentinel: padded entries store val == 0 AND col_idx == PAD_COL.
# PAD_COL is an IN-RANGE column, so the kernels' RHS gather reads x[0]
# for padded lanes without masking; correctness comes from val == 0.
# (A NaN in x[0] therefore poisons every row with padding -- the
# reference behaves the same way, and the non-finite solve statuses
# rely on it.)
PAD_COL = 0

# When True every converter audits its freshly built arrays.
PAD_AUDIT = bool(__debug__)


def min_index_dtype(span: int) -> np.dtype:
    """Narrowest signed integer dtype that can address columns
    ``[0, span)``: int16 up to 2**15, otherwise int32."""
    return np.dtype(np.int16) if span <= 2 ** 15 else np.dtype(np.int32)


def resolve_index_dtype(index_dtype, span: int) -> np.dtype:
    """Resolve an ``index_dtype`` build argument: ``"auto"`` compresses
    to :func:`min_index_dtype`; an explicit dtype is validated against
    the addressable span (a lossy narrowing is a build error)."""
    if index_dtype == "auto":
        return min_index_dtype(span)
    dt = np.dtype(index_dtype)
    if dt.kind != "i":
        raise ValueError(f"index_dtype must be a signed integer; got {dt}")
    if span > np.iinfo(dt).max + 1:
        raise ValueError(
            f"index_dtype {dt} cannot address {span} columns "
            f"(max span {np.iinfo(dt).max + 1})")
    return dt


# --------------------------------------------------------------------------
# CSR (interchange format)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CSRMatrix:
    """Host-side CSR. ``indptr`` int64, ``indices`` int32."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @property
    def n_nzr(self) -> float:
        """Average non-zeros per row (the paper's N_nzr)."""
        return self.nnz / max(self.n_rows, 1)


def csr_from_dense(a: np.ndarray) -> CSRMatrix:
    n_rows, n_cols = a.shape
    mask = a != 0
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    indices = np.nonzero(mask)[1].astype(np.int32)
    data = a[mask]
    return CSRMatrix(indptr, indices, data, (n_rows, n_cols))


def csr_from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    sum_duplicates: bool = True,
) -> CSRMatrix:
    """Build CSR from COO triplets (vectorised).  Column indices come
    out ascending within each row on both paths: the ``lexsort`` runs
    before the ``sum_duplicates`` branch."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and len(rows):
        key = rows * shape[1] + cols
        uniq, inv = np.unique(key, return_inverse=True)
        summed = np.zeros(len(uniq), dtype=vals.dtype)
        np.add.at(summed, inv, vals)
        rows = (uniq // shape[1]).astype(np.int64)
        cols = (uniq % shape[1]).astype(np.int64)
        vals = summed
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRMatrix(indptr, cols.astype(np.int32), vals, shape)


class CSRValidationError(ValueError):
    """A host CSR matrix failed admission validation.  ``report`` is the
    :class:`ValidationReport` with per-issue counts."""

    def __init__(self, message: str, report: "ValidationReport"):
        super().__init__(message)
        self.report = report


@dataclasses.dataclass
class ValidationReport:
    """What :func:`validate_csr` found (and, under ``repair=True``,
    fixed).  ``issues`` maps issue name -> count."""

    issues: dict
    repaired: bool = False

    @property
    def ok(self) -> bool:
        return not self.issues


def validate_csr(m: CSRMatrix, *, repair: bool = False
                 ) -> tuple[CSRMatrix, ValidationReport]:
    """Admission check for a host CSR matrix: ``indptr`` structure,
    column indices in range and sorted per row, no within-row
    duplicates, finite values.  ``repair=False`` raises
    :class:`CSRValidationError` on any issue; ``repair=True`` drops
    out-of-range / non-finite entries, sums duplicates and re-sorts.  A
    corrupt ``indptr`` raises either way."""
    indptr = np.asarray(m.indptr)
    indices = np.asarray(m.indices)
    data = np.asarray(m.data)
    n_rows, n_cols = m.shape
    issues: dict = {}

    structural = []
    if indptr.ndim != 1 or len(indptr) != n_rows + 1:
        structural.append("indptr_shape")
    else:
        if int(indptr[0]) != 0 or int(indptr[-1]) != len(indices):
            structural.append("indptr_bounds")
        if np.any(np.diff(indptr) < 0):
            structural.append("indptr_non_monotone")
    if len(indices) != len(data):
        structural.append("indices_data_mismatch")
    if structural:
        report = ValidationReport({k: 1 for k in structural})
        raise CSRValidationError(
            f"CSR structure is corrupt ({', '.join(structural)}): row "
            "boundaries cannot be trusted, not repairable", report)

    out_of_range = (indices < 0) | (indices >= n_cols)
    n_oor = int(out_of_range.sum())
    if n_oor:
        issues["out_of_range_indices"] = n_oor
    finite = np.isfinite(data)
    n_nonfinite = int((~finite).sum())
    if n_nonfinite:
        issues["non_finite_values"] = n_nonfinite

    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
    if len(indices):
        keys = rows * max(n_cols, 1) + np.clip(indices, 0, n_cols - 1)
        step = np.diff(keys)
        same_row = np.diff(rows) == 0
        n_dup = int(((step == 0) & same_row).sum())
        n_unsorted = int(((step < 0) & same_row).sum())
        if n_dup:
            issues["duplicate_indices"] = n_dup
        if n_unsorted:
            issues["unsorted_indices"] = n_unsorted

    if not issues:
        return m, ValidationReport({})
    if not repair:
        raise CSRValidationError(
            "CSR failed validation: "
            + ", ".join(f"{k}={v}" for k, v in issues.items())
            + " (pass repair=True / validate='repair' to rebuild)",
            ValidationReport(dict(issues)))
    keep = finite & ~out_of_range
    fixed = csr_from_coo(rows[keep], indices[keep].astype(np.int64),
                         data[keep], m.shape, sum_duplicates=True)
    fixed = CSRMatrix(fixed.indptr, fixed.indices,
                      fixed.data.astype(data.dtype), m.shape)
    return fixed, ValidationReport(dict(issues), repaired=True)


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# --------------------------------------------------------------------------
# ELLPACK / ELLPACK-R
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ELLMatrix:
    """ELLPACK(-R), jagged-diagonal-major: ``val[j, i]`` = j-th nonzero of
    row i (the paper's ``val[j*N + i]``).  Padded entries have val 0 and
    column ``PAD_COL`` so gathers stay in range.  ``rowlen`` turns plain
    ELLPACK into ELLPACK-R (paper Listing 1)."""

    val: np.ndarray       # (max_nzr_pad, n_rows_pad)
    col_idx: np.ndarray   # (max_nzr_pad, n_rows_pad) int16/int32
    rowlen: np.ndarray    # (n_rows_pad,) int32
    shape: Tuple[int, int]
    n_rows_pad: int

    @property
    def max_nzr(self) -> int:
        return self.val.shape[0]


def _entry_rows(m: CSRMatrix) -> np.ndarray:
    """Row of every stored entry, (nnz,) int64."""
    return np.repeat(np.arange(m.n_rows, dtype=np.int64), np.diff(m.indptr))


def csr_to_ell(
    m: CSRMatrix,
    row_align: int = _DEFAULT_BR,
    diag_align: int = _DEFAULT_DIAG_ALIGN,
    index_dtype="auto",
) -> ELLMatrix:
    rl = m.row_lengths()
    max_nzr = _pad_to(max(int(rl.max(initial=0)), 1), diag_align)
    n_pad = _pad_to(m.n_rows, row_align)
    idt = resolve_index_dtype(index_dtype, m.shape[1])
    val = np.zeros((max_nzr, n_pad), dtype=m.data.dtype)
    col = np.full((max_nzr, n_pad), PAD_COL, dtype=idt)
    # Vectorised fill: entry e of row i lands at depth e - indptr[i].
    rows = _entry_rows(m)
    depth = np.arange(m.nnz, dtype=np.int64) - m.indptr[rows]
    val[depth, rows] = m.data[: m.nnz]
    col[depth, rows] = m.indices[: m.nnz]
    rowlen = np.zeros(n_pad, dtype=np.int32)
    rowlen[: m.n_rows] = rl
    e = ELLMatrix(val, col, rowlen, m.shape, n_pad)
    if PAD_AUDIT:
        assert_padding_invariant(e)
    return e


def ell_to_dense(e: ELLMatrix) -> np.ndarray:
    a = np.zeros((e.shape[0], e.shape[1]), dtype=e.val.dtype)
    j = np.arange(e.max_nzr)[:, None]
    keep = j < e.rowlen[None, :]
    rows = np.broadcast_to(np.arange(e.n_rows_pad)[None, :], keep.shape)
    np.add.at(a, (rows[keep], e.col_idx[keep].astype(np.int64)),
              e.val[keep])
    return a


# --------------------------------------------------------------------------
# pJDS -- the paper's contribution
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PJDSMatrix:
    """Padded Jagged Diagonals Storage (paper Fig. 1), blocked.

    Rows are sorted by descending non-zero count; blocks of ``b_r``
    consecutive *sorted* rows are padded to the block-local max length
    (rounded up to ``diag_align``).  Block ``b`` occupies rows
    ``block_start[b]:block_start[b+1]`` of the flat ``(total_jds, b_r)``
    ``val``/``col_idx`` arrays -- the paper's ``col_start[]`` at block
    granularity.  With ``permuted_cols=True`` the stored column indices
    live in the permuted basis (symmetric permutation).
    """

    val: np.ndarray         # (total_jds, b_r)
    col_idx: np.ndarray     # (total_jds, b_r) int16/int32
    block_start: np.ndarray # (n_blocks + 1,) int32
    block_len: np.ndarray   # (n_blocks,) int32  == diff(block_start)
    rowlen: np.ndarray      # (n_rows_pad,) int32, sorted order
    perm: np.ndarray        # (n_rows_pad,) int32: perm[p] = original row at sorted pos p
    inv_perm: np.ndarray    # (n_rows_pad,) int32
    shape: Tuple[int, int]
    b_r: int
    n_rows_pad: int
    permuted_cols: bool

    @property
    def n_blocks(self) -> int:
        return len(self.block_len)

    @property
    def total_jds(self) -> int:
        return self.val.shape[0]


def csr_to_pjds(
    m: CSRMatrix,
    b_r: int = _DEFAULT_BR,
    diag_align: int = _DEFAULT_DIAG_ALIGN,
    permuted_cols: bool = True,
    index_dtype="auto",
) -> PJDSMatrix:
    rl = m.row_lengths()
    n_pad = _pad_to(m.n_rows, b_r)
    rl_pad = np.zeros(n_pad, dtype=np.int64)
    rl_pad[: m.n_rows] = rl
    # "sort" step (Fig. 1): stable sort by descending row length.
    perm = np.argsort(-rl_pad, kind="stable").astype(np.int32)
    return _pjds_with_perm(m, perm, b_r, diag_align, permuted_cols,
                           index_dtype)


# --------------------------------------------------------------------------
# SELL-C-sigma (pJDS with a bounded sorting window)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SELLMatrix:
    """SELL-C-sigma: like pJDS but rows are sorted only inside windows of
    ``sigma`` rows.  ``sigma = n_rows`` reproduces pJDS; ``sigma = C`` is
    pure sliced ELLPACK.  Storage layout is identical to
    :class:`PJDSMatrix`."""

    pjds: PJDSMatrix
    sigma: int


def windowed_sort_perm(rowlen: np.ndarray, sigma: int) -> np.ndarray:
    """Permutation sorting rows by DESCENDING length inside each window
    of ``sigma`` rows (stable within the window).  ``perm[p]`` = original
    row at sorted position ``p``; ``|perm[p] - p| < sigma``."""
    rl = np.asarray(rowlen, dtype=np.int64)
    n = len(rl)
    perm = np.arange(n, dtype=np.int32)
    for w in range(0, n, sigma):
        hi = min(w + sigma, n)
        sub = np.argsort(-rl[w:hi], kind="stable")
        perm[w:hi] = (w + sub).astype(np.int32)
    return perm


def csr_to_sell(
    m: CSRMatrix,
    c: int = _DEFAULT_BR,
    sigma: int | None = None,
    diag_align: int = _DEFAULT_DIAG_ALIGN,
    permuted_cols: bool = True,
    index_dtype="auto",
) -> SELLMatrix:
    if sigma is None:
        sigma = 8 * c
    rl = m.row_lengths()
    n_pad = _pad_to(m.n_rows, c)
    rl_pad = np.zeros(n_pad, dtype=np.int64)
    rl_pad[: m.n_rows] = rl
    perm = windowed_sort_perm(rl_pad, sigma)
    pj = _pjds_with_perm(m, perm, c, diag_align, permuted_cols, index_dtype)
    return SELLMatrix(pjds=pj, sigma=sigma)


def _pjds_with_perm(
    m: CSRMatrix,
    perm: np.ndarray,
    b_r: int,
    diag_align: int,
    permuted_cols: bool,
    index_dtype="auto",
) -> PJDSMatrix:
    """pJDS blocking with an externally supplied row permutation."""
    if permuted_cols and m.shape[0] != m.shape[1]:
        raise ValueError("symmetric permutation requires a square matrix")
    n_pad = len(perm)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n_pad, dtype=np.int32)
    rl = m.row_lengths()
    rl_pad = np.zeros(n_pad, dtype=np.int64)
    rl_pad[: m.n_rows] = rl
    sorted_rl = rl_pad[perm]
    n_blocks = n_pad // b_r
    block_len = np.zeros(n_blocks, dtype=np.int32)
    for b in range(n_blocks):
        blk = sorted_rl[b * b_r : (b + 1) * b_r]
        block_len[b] = _pad_to(max(int(blk.max(initial=0)), 1), diag_align)
    block_start = np.zeros(n_blocks + 1, dtype=np.int32)
    np.cumsum(block_len, out=block_start[1:])
    total = int(block_start[-1])
    # With a symmetric permutation the stored indices live in the PERMUTED
    # column space, whose addressable span is the padded row count.
    idt = resolve_index_dtype(index_dtype,
                              n_pad if permuted_cols else m.shape[1])
    val = np.zeros((total, b_r), dtype=m.data.dtype)
    col = np.full((total, b_r), PAD_COL, dtype=idt)
    # Vectorised fill: entry k of the row at sorted position p lands at
    # (block_start[p // b_r] + k, p % b_r) -- the same slots the
    # reference's per-row loop writes.
    pos = np.nonzero(perm < m.n_rows)[0]
    orig = perm[pos].astype(np.int64)
    lens = rl_pad[orig]
    n_ent = int(lens.sum())
    if n_ent:
        first = np.cumsum(lens) - lens
        k = np.arange(n_ent, dtype=np.int64) - np.repeat(first, lens)
        src = np.repeat(m.indptr[orig].astype(np.int64), lens) + k
        p = np.repeat(pos.astype(np.int64), lens)
        dst_j = block_start[p // b_r].astype(np.int64) + k
        dst_r = p % b_r
        cols = m.indices[src]
        if permuted_cols:
            cols = inv_perm[cols]
        val[dst_j, dst_r] = m.data[src]
        col[dst_j, dst_r] = cols.astype(idt)
    pj = PJDSMatrix(
        val=val,
        col_idx=col,
        block_start=block_start,
        block_len=block_len,
        rowlen=sorted_rl.astype(np.int32),
        perm=perm.astype(np.int32),
        inv_perm=inv_perm.astype(np.int32),
        shape=m.shape,
        b_r=b_r,
        n_rows_pad=n_pad,
        permuted_cols=permuted_cols,
    )
    if PAD_AUDIT:
        assert_padding_invariant(pj)
    return pj


# --------------------------------------------------------------------------
# Transpose and diagonal (the distributed operator's A^T partition and
# Jacobi diagonal)
# --------------------------------------------------------------------------
def csr_transpose(m: CSRMatrix) -> CSRMatrix:
    """A^T as a host CSR (the CSC view of ``m`` re-read as CSR), so the
    forward spMV of its partition computes ``A^T x``.  Duplicates stay
    duplicates, and ``csr_from_coo`` sorts within rows before its
    ``sum_duplicates`` branch, so rows stay sorted."""
    rows = np.repeat(np.arange(m.n_rows, dtype=np.int64), m.row_lengths())
    return csr_from_coo(m.indices.astype(np.int64), rows, m.data,
                        (m.n_cols, m.n_rows), sum_duplicates=False)


def csr_diagonal(m: CSRMatrix) -> np.ndarray:
    """diag(A) for a square CSR (missing entries are 0); duplicate
    (i, i) entries add, as they do in a matvec."""
    if m.shape[0] != m.shape[1]:
        raise ValueError("diagonal requires a square matrix")
    d = np.zeros(m.n_rows, dtype=m.data.dtype)
    rows = np.repeat(np.arange(m.n_rows, dtype=np.int64), m.row_lengths())
    on_diag = m.indices == rows
    np.add.at(d, rows[on_diag], m.data[on_diag])
    return d


# --------------------------------------------------------------------------
# CMRS -- Compressed Multi-Row Storage (arXiv:1203.2946), blocked
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CMRSMatrix:
    """CMRS on the blocked tiling: rows stay in ORIGINAL order and are
    grouped into *strips* of ``b_r`` consecutive rows.  Each strip's
    nonzeros are packed densely, row-major, into ``(strip_su, b_r)``
    tiles: entry ``k`` of a strip lands at row ``k // b_r``, lane
    ``k % b_r`` relative to the strip's first tile row, and
    ``row_in_strip`` (int8, values in ``[0, b_r)``) routes each slot back
    to its row inside the strip.  So a row's slots are contiguous, and a
    row longer than ``b_r`` spans several tile rows.

    ``strip_su[s] = ceil(strip_nnz / b_r)`` padded to ``diag_align``
    (min 1); ``strip_start`` is its exclusive prefix sum.  Padding slots
    carry ``val == 0``, ``col == PAD_COL`` and ``row_in_strip == 0``;
    ``strip_nnz`` keeps the true per-strip count."""

    val: np.ndarray            # (total_su, b_r)
    col_idx: np.ndarray        # (total_su, b_r) int16/int32
    row_in_strip: np.ndarray   # (total_su, b_r) int8
    strip_start: np.ndarray    # (n_strips + 1,) int32, tile-row offsets
    strip_len: np.ndarray      # (n_strips,) int32 == diff(strip_start)
    strip_nnz: np.ndarray      # (n_strips,) int64, true nonzeros per strip
    shape: Tuple[int, int]
    b_r: int
    n_rows_pad: int

    @property
    def n_strips(self) -> int:
        return len(self.strip_len)

    @property
    def total_su(self) -> int:
        return int(self.strip_start[-1])


def _cmrs_strip_len(strip_nnz: np.ndarray, b_r: int,
                    diag_align: int) -> np.ndarray:
    """``_pad_to(max(ceil(nnz / b_r), 1), diag_align)`` per strip."""
    su = np.maximum(-(-np.asarray(strip_nnz, np.int64) // b_r), 1)
    return -(-su // diag_align) * diag_align


def csr_to_cmrs(
    m: CSRMatrix,
    b_r: int = _DEFAULT_BR,
    diag_align: int = _DEFAULT_DIAG_ALIGN,
    index_dtype="auto",
) -> CMRSMatrix:
    """Pack ``m`` into CMRS strips of ``b_r`` rows (original order)."""
    n = m.n_rows
    n_pad = _pad_to(max(n, 1), b_r)
    n_strips = n_pad // b_r
    rl = m.row_lengths()
    idt = resolve_index_dtype(index_dtype, m.n_cols)

    rl_pad = np.zeros(n_pad, dtype=np.int64)
    rl_pad[:n] = rl
    strip_nnz = rl_pad.reshape(n_strips, b_r).sum(axis=1)
    strip_len = _cmrs_strip_len(strip_nnz, b_r, diag_align).astype(np.int32)
    strip_start = np.zeros(n_strips + 1, dtype=np.int32)
    np.cumsum(strip_len, out=strip_start[1:])

    total = int(strip_start[-1])
    val = np.zeros((total, b_r), dtype=m.data.dtype)
    col = np.full((total, b_r), PAD_COL, dtype=idt)
    ris = np.zeros((total, b_r), dtype=np.int8)
    # Vectorised fill: entry e of row i is entry k = e - indptr[s * b_r]
    # of strip s = i // b_r, stored at (strip_start[s] + k // b_r,
    # k % b_r) -- the slots the reference's per-strip loop writes.
    rows = _entry_rows(m)
    s = rows // b_r
    k = np.arange(m.nnz, dtype=np.int64) - m.indptr[s * b_r]
    dst_j = strip_start[s].astype(np.int64) + k // b_r
    dst_r = k % b_r
    val[dst_j, dst_r] = m.data[: m.nnz]
    col[dst_j, dst_r] = m.indices[: m.nnz].astype(idt)
    ris[dst_j, dst_r] = (rows - s * b_r).astype(np.int8)

    cm = CMRSMatrix(
        val=val, col_idx=col, row_in_strip=ris,
        strip_start=strip_start, strip_len=strip_len, strip_nnz=strip_nnz,
        shape=m.shape, b_r=b_r, n_rows_pad=n_pad)
    if PAD_AUDIT:
        assert_padding_invariant(cm)
    return cm


def _cmrs_padding(c: CMRSMatrix) -> np.ndarray:
    """Boolean (total_su, b_r): which slots are padding."""
    strip = np.repeat(np.arange(c.n_strips), c.strip_len)
    flat = (np.arange(c.total_su) - c.strip_start[strip])[:, None] * c.b_r \
        + np.arange(c.b_r)[None, :]
    return flat >= c.strip_nnz[strip][:, None]


def cmrs_to_dense(c: CMRSMatrix) -> np.ndarray:
    a = np.zeros(c.shape, dtype=c.val.dtype)
    keep = ~_cmrs_padding(c)
    strip = np.repeat(np.arange(c.n_strips, dtype=np.int64), c.strip_len)
    rows = strip[:, None] * c.b_r + c.row_in_strip.astype(np.int64)
    np.add.at(a, (rows[keep], c.col_idx[keep].astype(np.int64)),
              c.val[keep])
    return a


# --------------------------------------------------------------------------
# Padding-sentinel audit
# --------------------------------------------------------------------------
def _check_pad(name: str, val_pad: np.ndarray, col_pad: np.ndarray) -> None:
    if val_pad.size and np.any(val_pad != 0):
        raise AssertionError(
            f"{name}: padded entries carry non-zero values — the unmasked "
            f"kernels would add them into y")
    if col_pad.size and np.any(col_pad != PAD_COL):
        raise AssertionError(
            f"{name}: padded entries carry column != PAD_COL ({PAD_COL}) — "
            f"the RHS gather would touch arbitrary entries of x")


def assert_padding_invariant(fmt) -> None:
    """Audit the padding sentinel invariant (see :data:`PAD_COL`): every
    padded slot of a blocked format must store ``val == 0`` and
    ``col_idx == PAD_COL``.  Raises AssertionError on violation."""
    if isinstance(fmt, SELLMatrix):
        fmt = fmt.pjds
    if isinstance(fmt, ELLMatrix):
        j = np.arange(fmt.val.shape[0])[:, None]
        pad = j >= fmt.rowlen[None, :]
        _check_pad("ELLMatrix", fmt.val[pad], fmt.col_idx[pad])
        return
    if isinstance(fmt, CMRSMatrix):
        pad = _cmrs_padding(fmt)
        _check_pad("CMRSMatrix", fmt.val[pad], fmt.col_idx[pad])
        if np.any(fmt.row_in_strip[pad] != 0):
            raise AssertionError(
                "CMRSMatrix: padded entries carry row_in_strip != 0 -- the "
                "segment reduction would scatter into arbitrary rows")
        return
    if isinstance(fmt, PJDSMatrix):
        # per stored diagonal j of block b: lane r is padding iff
        # j - block_start[b] >= rowlen[b * b_r + r]
        n_blocks, b_r = fmt.n_blocks, fmt.b_r
        blk = np.repeat(np.arange(n_blocks), fmt.block_len)
        depth = np.arange(fmt.total_jds) - fmt.block_start[blk]
        rl = fmt.rowlen.reshape(n_blocks, b_r)[blk]
        pad = depth[:, None] >= rl
        _check_pad("PJDSMatrix", fmt.val[pad], fmt.col_idx[pad])
        return
    if isinstance(fmt, CSRMatrix):
        return              # CSR stores no padding
    raise TypeError(type(fmt))


# --------------------------------------------------------------------------
# Memory accounting (paper Table 1, "data reduction" column)
# --------------------------------------------------------------------------
def storage_elements(fmt) -> int:
    """Number of stored value elements (incl. padding zeros) -- the
    paper's measure for the ELLPACK-vs-pJDS comparison."""
    if isinstance(fmt, CSRMatrix):
        return fmt.nnz
    if isinstance(fmt, SELLMatrix):
        return int(fmt.pjds.val.size)
    if isinstance(fmt, (ELLMatrix, PJDSMatrix, CMRSMatrix)):
        return int(fmt.val.size)
    raise TypeError(type(fmt))


def format_nbytes(fmt, value_bytes: int | None = None,
                  index_bytes: int | None = None) -> int:
    """Total footprint: values + column indices + per-format metadata.
    ``value_bytes`` / ``index_bytes`` default to the widths actually
    stored; pass explicit widths to price another storage precision."""
    if isinstance(fmt, SELLMatrix):
        return format_nbytes(fmt.pjds, value_bytes, index_bytes)
    if value_bytes is None:
        value_bytes = (fmt.data if isinstance(fmt, CSRMatrix)
                       else fmt.val).dtype.itemsize
    if index_bytes is None:
        index_bytes = (fmt.indices if isinstance(fmt, CSRMatrix)
                       else fmt.col_idx).dtype.itemsize
    e = storage_elements(fmt)
    base = e * (value_bytes + index_bytes)
    if isinstance(fmt, CSRMatrix):
        return base + (fmt.n_rows + 1) * 8
    if isinstance(fmt, ELLMatrix):
        return base + fmt.n_rows_pad * 4          # rowlen (ELLPACK-R)
    if isinstance(fmt, PJDSMatrix):
        return base + (fmt.n_blocks + 1) * 4 + fmt.n_rows_pad * 4  # col_start + perm
    if isinstance(fmt, CMRSMatrix):
        # + the int8 row-in-strip stream and the strip offsets
        return base + e * 1 + (fmt.n_strips + 1) * 4
    raise TypeError(type(fmt))


def data_reduction_vs_ellpack(m: CSRMatrix, b_r: int = _DEFAULT_BR) -> float:
    """Paper Table 1: fraction of ELLPACK storage saved by pJDS."""
    ell = csr_to_ell(m, row_align=b_r)
    pj = csr_to_pjds(m, b_r=b_r, permuted_cols=(m.shape[0] == m.shape[1]))
    return 1.0 - storage_elements(pj) / storage_elements(ell)


# --------------------------------------------------------------------------
# Storage estimators from row lengths alone (no matrix build); the
# dispatch layer (kernels.ops.select_format) prices each candidate with
# these before converting anything.
# --------------------------------------------------------------------------
def windowed_block_lengths(
    rowlen: np.ndarray,
    b_r: int = _DEFAULT_BR,
    diag_align: int = _DEFAULT_DIAG_ALIGN,
    sigma: int | None = None,
) -> np.ndarray:
    """Per-block padded jagged-diagonal counts of a blocked (pJDS / SELL)
    layout, from row lengths alone.  ``sigma=None`` is the global sort
    (pJDS).  Matches the ``block_len`` the real converters produce."""
    rl = np.asarray(rowlen, dtype=np.int64)
    n_pad = _pad_to(max(len(rl), 1), b_r)
    rl_pad = np.zeros(n_pad, dtype=np.int64)
    rl_pad[: len(rl)] = rl
    if sigma is None or sigma >= n_pad:
        srt = -np.sort(-rl_pad)
    else:
        srt = rl_pad[windowed_sort_perm(rl_pad, sigma)]
    blk_max = srt.reshape(-1, b_r).max(axis=1)
    return np.array(
        [_pad_to(max(int(b), 1), diag_align) for b in blk_max], dtype=np.int32
    )


def estimate_storage_elements(
    rowlen: np.ndarray,
    fmt: str,
    b_r: int = _DEFAULT_BR,
    diag_align: int = _DEFAULT_DIAG_ALIGN,
    sigma: int | None = None,
) -> int:
    """Stored value elements (incl. padding) a format WOULD use, from row
    lengths alone.  Agrees with the size of the built matrix's ``val``.
    Prices every format the reference's dispatch weighs."""
    rl = np.asarray(rowlen, dtype=np.int64)
    if fmt == "csr":
        return int(rl.sum())
    if fmt in ("ellpack", "ellpack_r"):
        n_pad = _pad_to(max(len(rl), 1), b_r)
        return n_pad * _pad_to(max(int(rl.max(initial=0)), 1), diag_align)
    if fmt == "pjds":
        return int(windowed_block_lengths(rl, b_r, diag_align, None).sum()) * b_r
    if fmt == "sell":
        if sigma is None:
            sigma = 8 * b_r
        return int(windowed_block_lengths(rl, b_r, diag_align, sigma).sum()) * b_r
    if fmt == "cmrs":
        n_pad = _pad_to(max(len(rl), 1), b_r)
        rl_pad = np.zeros(n_pad, dtype=np.int64)
        rl_pad[: len(rl)] = rl
        strip_nnz = rl_pad.reshape(-1, b_r).sum(axis=1)
        su = np.array(
            [_pad_to(max(-(-int(c) // b_r), 1), diag_align)
             for c in strip_nnz], dtype=np.int64)
        return int(su.sum()) * b_r
    raise ValueError(f"unknown format {fmt!r}")


def structural_fingerprint(m: CSRMatrix) -> str:
    """sha1 digest of the matrix STRUCTURE: shape + indptr + indices,
    deliberately excluding the stored values (the tuner's cache key).

    Every quantity the tuner's search space and the perf model depend on
    -- row lengths, padding, column spans -- is a function of the
    structure alone, so tuned kernel statics transfer across value
    updates, while any structural edit (new entry, reorder, resize)
    changes the digest and invalidates the cached decision.
    """
    h = hashlib.sha1()
    h.update(np.asarray(m.shape, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(m.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(m.indices, dtype=np.int64).tobytes())
    return h.hexdigest()


def csr_remote_columns_by_distance(
    sl: CSRMatrix, p: int, n_loc: int, n_dev: int
) -> dict:
    """For rank ``p``'s row slice ``sl`` (a CSR over the GLOBAL column
    space) under a uniform n_loc-row ring partition: the slice-local
    column indices it references in each OTHER rank's slice, keyed by
    signed ring distance d (owner = (p + d) % n_dev, |d| <= n_dev//2).

    Each value is sorted and unique -- the gather set of the paper's
    "local gather + point-to-point" halo exchange, the entries of the
    neighbour's x slice that must cross the wire (the distributed
    tuner's measured coupling width, ``tune.tune_partition``).
    """
    cols = sl.indices.astype(np.int64)
    own_lo, own_hi = p * n_loc, (p + 1) * n_loc
    rcols = cols[(cols < own_lo) | (cols >= own_hi)]
    owner = rcols // n_loc
    d = (owner - p + n_dev) % n_dev
    d = np.where(d > n_dev // 2, d - n_dev, d)
    return {
        int(dd): np.unique(rcols[d == dd] % n_loc).astype(np.int32)
        for dd in np.unique(d)
    }
