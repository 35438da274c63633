"""Dependency-free Matrix Market (``.mtx``) ingestion and export.

Port of ``repro/core/io_mm.py`` over this package's ``formats``: the
same reader, writer and admission gate, so a file loads into arrays
identical to the reference's and a matrix writes the same text.
Supported header space:

* ``coordinate`` (sparse triplets, 1-based) and ``array`` (dense,
  column-major) formats;
* ``real`` / ``integer`` / ``pattern`` value fields (``pattern``
  entries load as 1.0; ``complex`` / ``hermitian`` are rejected);
* ``general`` / ``symmetric`` / ``skew-symmetric`` symmetries -- the
  stored lower triangle is expanded on load (skew off-diagonals with
  the sign flip; a stored nonzero skew diagonal is rejected).

Every load goes through :func:`formats.validate_csr` before the matrix
enters the pipeline (``validate="repair"`` sums / drops / sorts,
``"strict"`` raises, ``"off"`` trusts the file).  The writer emits 9
significant digits for f32 and 17 for f64, so ``save_mm`` ->
``load_mm`` is bit-exact; ``symmetry="auto"`` stores only the lower
triangle of a symmetric or skew-symmetric square matrix.
"""
from __future__ import annotations

import io
import os
from typing import Optional, TextIO, Tuple, Union

import numpy as np

from . import formats as F

__all__ = ["load_mm", "save_mm", "read_mm", "write_mm", "MMHeader",
           "MatrixMarketError"]

_FORMATS = ("coordinate", "array")
_FIELDS = ("real", "integer", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric")


class MatrixMarketError(ValueError):
    """Malformed or unsupported Matrix Market content."""


class MMHeader:
    """Parsed banner + size line of a Matrix Market file."""

    def __init__(self, format: str, field: str, symmetry: str,
                 shape: Tuple[int, int], nnz: Optional[int]):
        self.format = format
        self.field = field
        self.symmetry = symmetry
        self.shape = shape
        self.nnz = nnz          # None for array format

    def __repr__(self):
        return (f"MMHeader({self.format}, {self.field}, {self.symmetry}, "
                f"shape={self.shape}, nnz={self.nnz})")


def _parse_banner(line: str) -> Tuple[str, str, str]:
    parts = line.strip().lower().split()
    if len(parts) != 5 or parts[0] != "%%matrixmarket" or parts[1] != "matrix":
        raise MatrixMarketError(
            f"not a Matrix Market file: bad banner {line.strip()!r}")
    fmt, field, sym = parts[2], parts[3], parts[4]
    if fmt not in _FORMATS:
        raise MatrixMarketError(f"unsupported format {fmt!r} "
                                f"(supported: {_FORMATS})")
    if field not in _FIELDS:
        raise MatrixMarketError(f"unsupported field {field!r} "
                                f"(supported: {_FIELDS})")
    if sym not in _SYMMETRIES:
        raise MatrixMarketError(f"unsupported symmetry {sym!r} "
                                f"(supported: {_SYMMETRIES})")
    return fmt, field, sym


def _data_lines(f: TextIO):
    for line in f:
        s = line.strip()
        if not s or s.startswith("%"):
            continue
        yield s


def read_mm(f: TextIO) -> Tuple[MMHeader, np.ndarray, np.ndarray, np.ndarray]:
    """Parse an open text stream into ``(header, rows, cols, vals)`` COO
    triplets (0-based, symmetry EXPANDED, duplicates NOT summed — the
    CSR build owns deduplication).  Low-level; most callers want
    :func:`load_mm`."""
    banner = f.readline()
    fmt, field, sym = _parse_banner(banner)
    lines = _data_lines(f)
    try:
        size = next(lines)
    except StopIteration:
        raise MatrixMarketError("missing size line")
    toks = size.split()
    vdt = np.int64 if field == "integer" else np.float64

    if fmt == "coordinate":
        if len(toks) != 3:
            raise MatrixMarketError(
                f"coordinate size line needs 'rows cols nnz'; got {size!r}")
        n_rows, n_cols, nnz = (int(t) for t in toks)
        want = 2 if field == "pattern" else 3
        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        vals = np.ones(nnz, dtype=vdt)
        k = 0
        for s in lines:
            t = s.split()
            if len(t) != want:
                raise MatrixMarketError(
                    f"entry {k}: expected {want} tokens, got {s!r}")
            if k >= nnz:
                raise MatrixMarketError(
                    f"more than the declared {nnz} entries")
            rows[k] = int(t[0]) - 1
            cols[k] = int(t[1]) - 1
            if want == 3:
                vals[k] = vdt(t[2]) if field == "integer" else float(t[2])
            k += 1
        if k != nnz:
            raise MatrixMarketError(f"declared {nnz} entries, found {k}")
    else:                                   # array (dense, column-major)
        if len(toks) != 2:
            raise MatrixMarketError(
                f"array size line needs 'rows cols'; got {size!r}")
        n_rows, n_cols = (int(t) for t in toks)
        if field == "pattern":
            raise MatrixMarketError("array format cannot be pattern")
        if sym == "general":
            pairs = [(i, j) for j in range(n_cols) for i in range(n_rows)]
        elif sym == "symmetric":            # lower triangle incl. diagonal
            pairs = [(i, j) for j in range(n_cols) for i in range(j, n_rows)]
        else:                               # skew: strict lower triangle
            pairs = [(i, j) for j in range(n_cols)
                     for i in range(j + 1, n_rows)]
        nnz = len(pairs)
        vals = np.empty(nnz, dtype=vdt)
        k = 0
        for s in lines:
            for tok in s.split():
                if k >= nnz:
                    raise MatrixMarketError(
                        f"more than the expected {nnz} array values")
                vals[k] = vdt(tok) if field == "integer" else float(tok)
                k += 1
        if k != nnz:
            raise MatrixMarketError(f"expected {nnz} array values, found {k}")
        rows = np.array([p[0] for p in pairs], dtype=np.int64)
        cols = np.array([p[1] for p in pairs], dtype=np.int64)

    if sym != "general":
        if n_rows != n_cols:
            raise MatrixMarketError(
                f"{sym} declared on a {n_rows}x{n_cols} matrix")
        off = rows != cols
        if sym == "skew-symmetric" and np.any(vals[~off] != 0):
            raise MatrixMarketError(
                "skew-symmetric file stores a nonzero diagonal")
        sign = -1 if sym == "skew-symmetric" else 1
        r0, c0 = rows, cols
        rows = np.concatenate([r0, c0[off]])
        cols = np.concatenate([c0, r0[off]])
        vals = np.concatenate([vals, sign * vals[off]])

    hdr = MMHeader(fmt, field, sym, (n_rows, n_cols),
                   nnz if fmt == "coordinate" else None)
    return hdr, rows, cols, vals


def load_mm(source: Union[str, os.PathLike, TextIO], *,
            dtype=np.float64, validate: str = "repair") -> F.CSRMatrix:
    """Load a Matrix Market file (path or open text stream) as a host
    :class:`formats.CSRMatrix`.

    ``dtype`` is the value dtype of the returned matrix (float64
    default; integer-valued files cast exactly for any float dtype wide
    enough).  ``validate`` gates the admission check:
    ``"repair"`` (default) rebuilds through
    ``validate_csr(repair=True)`` — duplicates summed, out-of-range
    and non-finite entries dropped; ``"strict"`` raises
    ``CSRValidationError`` on any issue; ``"off"`` skips the scan.
    """
    if validate not in ("repair", "strict", "off"):
        raise ValueError(f"validate must be 'repair', 'strict' or 'off'; "
                         f"got {validate!r}")
    if isinstance(source, (str, os.PathLike)):
        with open(source, "r") as f:
            hdr, rows, cols, vals = read_mm(f)
    else:
        hdr, rows, cols, vals = read_mm(source)
    # Out-of-range indices would crash the bincount inside csr_from_coo;
    # clamp here and let validate_csr report/drop them (strict raises).
    n_rows, n_cols = hdr.shape
    bad = ((rows < 0) | (rows >= n_rows) | (cols < 0) | (cols >= n_cols))
    if np.any(bad):
        if validate != "repair":
            raise MatrixMarketError(
                f"{int(bad.sum())} entries outside the declared "
                f"{n_rows}x{n_cols} shape")
        keep = ~bad
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    m = F.csr_from_coo(rows, cols, vals.astype(dtype), shape=hdr.shape)
    if validate != "off":
        m, _ = F.validate_csr(m, repair=(validate == "repair"))
    return m


def _value_format(data: np.ndarray) -> str:
    # Enough decimal digits to round-trip the binary value exactly:
    # 9 for binary32, 17 for binary64.
    return "%.9g" if data.dtype.itemsize <= 4 else "%.17g"


def _detect_symmetry(m: F.CSRMatrix) -> str:
    if m.shape[0] != m.shape[1]:
        return "general"
    mt = F.csr_transpose(m)
    same_struct = (np.array_equal(m.indptr, mt.indptr)
                   and np.array_equal(m.indices, mt.indices))
    if not same_struct:
        return "general"
    if np.array_equal(m.data, mt.data):
        return "symmetric"
    if (np.array_equal(m.data, -mt.data)
            and np.all(F.csr_diagonal(m) == 0)):
        return "skew-symmetric"
    return "general"


def write_mm(f: TextIO, m: F.CSRMatrix, *, symmetry: str = "auto",
             field: str = "auto", comment: Optional[str] = None) -> None:
    """Write ``m`` to an open text stream in coordinate format.

    ``symmetry="auto"`` detects symmetric / skew-symmetric square
    matrices (structure AND values) and stores the lower triangle only;
    explicit ``"general"`` / ``"symmetric"`` / ``"skew-symmetric"``
    skip detection (the caller asserts the property — symmetric output
    of a non-symmetric matrix silently drops the upper triangle).
    ``field="auto"`` writes ``integer`` for integer dtypes, else
    ``real``; ``field="pattern"`` stores structure only.
    """
    if symmetry == "auto":
        symmetry = _detect_symmetry(m)
    if symmetry not in _SYMMETRIES:
        raise ValueError(f"symmetry must be 'auto' or one of {_SYMMETRIES}; "
                         f"got {symmetry!r}")
    if field == "auto":
        field = "integer" if np.issubdtype(m.data.dtype, np.integer) \
            else "real"
    if field not in _FIELDS:
        raise ValueError(f"field must be 'auto' or one of {_FIELDS}; "
                         f"got {field!r}")

    rows = np.repeat(np.arange(m.n_rows, dtype=np.int64), m.row_lengths())
    cols = np.asarray(m.indices, dtype=np.int64)
    vals = np.asarray(m.data)
    if symmetry != "general":
        keep = rows >= cols if symmetry == "symmetric" else rows > cols
        rows, cols, vals = rows[keep], cols[keep], vals[keep]

    f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
    if comment:
        for line in comment.splitlines():
            f.write(f"% {line}\n")
    f.write(f"{m.shape[0]} {m.shape[1]} {len(vals)}\n")
    if field == "pattern":
        for r, c in zip(rows, cols):
            f.write(f"{r + 1} {c + 1}\n")
    elif field == "integer":
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r + 1} {c + 1} {int(v)}\n")
    else:
        vf = _value_format(vals)
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r + 1} {c + 1} {vf % v}\n")


def save_mm(dest: Union[str, os.PathLike, TextIO], m: F.CSRMatrix, *,
            symmetry: str = "auto", field: str = "auto",
            comment: Optional[str] = None) -> None:
    """Write ``m`` as a coordinate Matrix Market file (path or stream).
    See :func:`write_mm` for the symmetry / field knobs; the value
    format is chosen so ``load_mm(save_mm(...))`` round-trips the
    stored dtype bit-exactly."""
    if isinstance(dest, (str, os.PathLike)):
        with open(dest, "w") as f:
            write_mm(f, m, symmetry=symmetry, field=field, comment=comment)
    else:
        write_mm(dest, m, symmetry=symmetry, field=field, comment=comment)
