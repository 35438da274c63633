"""The plain reference: what the program's outputs are judged against.

Float64 NumPy / SciPy on the benchmark's own CSR arrays (the arrays the
generators made, the values as the configuration stores them), so it
shares nothing with the program: it imports neither the port nor JAX,
and it takes none of the program's layouts, permutations or
partitions.  It reads the program's outputs only to judge them.

Also here, for the controls (``controls.py``): the same operations
computed one precision lower than the configurations state (bfloat16
for their float32), and a plain CG.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["csr_f64", "rel_err", "rel_residual", "to_bf16", "spmv_bf16",
           "cg_plain"]


def csr_f64(indptr, indices, data, shape) -> sp.csr_matrix:
    """The matrix in float64, from the benchmark's arrays."""
    return sp.csr_matrix((np.asarray(data, dtype=np.float64),
                          np.asarray(indices), np.asarray(indptr)),
                         shape=shape)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|: a product's error against the
    float64 product, relative to the product's largest entry."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = float(np.abs(want).max(initial=0.0))
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.abs(got - want).max(initial=0.0)) / max(scale, 1e-300)


def rel_residual(a64: sp.csr_matrix, b, x) -> float:
    """||b - A x|| / ||b|| in float64: the relative residual of a
    solution x to A x = b, which the program's solve stops on."""
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    if x.shape != (a64.shape[1],) or not np.all(np.isfinite(x)):
        return float("inf")
    return float(np.linalg.norm(b - a64 @ x) / max(np.linalg.norm(b),
                                                    1e-300))


def to_bf16(a) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even),
    returned as float32."""
    u = np.asarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def spmv_bf16(indptr, indices, data, shape, x) -> np.ndarray:
    """y = A x with the values and x in bfloat16, each product exact in
    float32 and rounded to bfloat16, the rows summed in float32 and the
    result rounded to bfloat16: the configuration's float32 product one
    precision lower."""
    v = to_bf16(data)
    xb = to_bf16(x)
    prod = to_bf16(v * xb[np.asarray(indices)])
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    y = np.bincount(rows, weights=prod, minlength=shape[0])
    return to_bf16(y.astype(np.float32))


def cg_plain(matvec, b, *, tol: float, maxiter: int, dot=None):
    """Textbook CG from x0 = 0 on whatever array type ``matvec`` and
    ``b`` share (NumPy or torch, any precision): stops when the
    recurrence residual reaches ``tol * ||b||`` or after ``maxiter``
    iterations.  Returns ``(x, iterations)``."""
    dot = dot or (lambda u, v: float((u * v).sum()))
    x = b * 0
    r = b.copy() if hasattr(b, "copy") else b.clone()
    p = r.copy() if hasattr(r, "copy") else r.clone()
    rr = dot(r, r)
    stop = tol * tol * dot(b, b)
    k = 0
    while k < maxiter and rr > stop:
        ap = matvec(p)
        pap = dot(p, ap)
        if not pap > 0:
            break
        alpha = rr / pap
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        k += 1
    return x, k
