"""The yardstick's peaks and the bytes that the benchmark's operations
need, counted from the matrix's shape alone.

The bytes are those of the algorithm on a CSR matrix with 4-byte
values and 4-byte indices (the configurations' storage), each input
read once and each output written once, whatever format or strategy
the program runs: the CSR arrays (values, column indices, row offsets),
and the vectors that the operation needs.  They do not change when the
implementation does, so a share of the roofline moves only with time.
"""
from __future__ import annotations

__all__ = ["H100_SXM", "csr_bytes", "spmv_bytes", "cg_iteration_bytes",
           "bound_seconds", "CG_VECTOR_PASSES"]

# NVIDIA's data sheet, H100 SXM5 80 GB, dense rates, at the full 700 W.
H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
    "hbm_bytes": 80e9,
}

VALUE_BYTES = 4
INDEX_BYTES = 4

# One iteration of CG (Hestenes-Stiefel) in the fewest vector passes:
# the product reads p and writes Ap (with <p, Ap> on the fly), and one
# update pass reads x, r, p and Ap and writes x, r and p (with <r, r>
# on the fly): 2 + 7 vectors of n words.
CG_VECTOR_PASSES = 9


def csr_bytes(n_rows: int, nnz: int) -> int:
    """Values and column indices once, row offsets once."""
    return nnz * (VALUE_BYTES + INDEX_BYTES) + (n_rows + 1) * INDEX_BYTES


def spmv_bytes(n_rows: int, n_cols: int, nnz: int) -> int:
    """y = A x (or x = A^T y, the same arrays): the CSR arrays, the
    input vector and the output vector, each once."""
    return csr_bytes(n_rows, nnz) + (n_rows + n_cols) * VALUE_BYTES


def cg_iteration_bytes(n: int, nnz: int) -> int:
    """One CG iteration on a square n x n matrix."""
    return csr_bytes(n, nnz) + CG_VECTOR_PASSES * n * VALUE_BYTES


def bound_seconds(nbytes: float, spec: dict = H100_SXM) -> float:
    """The least time the bytes take at the peak bandwidth.  (Every
    operation here does 2 flops per 8 or more bytes, far below the
    card's 20 flops a byte, so bandwidth bounds it.)"""
    return nbytes / spec["hbm_bytes_per_s"]
