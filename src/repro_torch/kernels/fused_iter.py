"""K3: the fused Krylov iteration -- SELL-C-sigma spMV plus the five dot
products of a CG/BiCGStab step in one pass, hand-written for Hopper.

Replaces ``repro/kernels/fused_iter.py::fused_spmv_dots_kernel_call``
(the Pallas TPU kernel).  The CUDA source is ``csrc/fused_iter.cu``:
K2's window kernel plus an epilogue.  The same sigma-window CTA (128
threads, more when too few windows would leave the card idle) runs K2's
walk (``repro::window_spmv``: each warp walks its derived ``warp_len``
diagonals and adds the skipped padding's ``0 * x[0]`` once), so y is
K2's y bit for bit; while the unpermuted slab is still in shared memory
it multiplies each row it writes by ``w1[i]`` / ``w2[i]`` and reduces
the CTA's partials of

    <y,w1>   <y,w2>   <y,y>   <w2,w2>   <w1,w2>

into one row of an ``(n_win, 5)`` buffer; a second stage sums the rows
in a fixed order.  No float atomics, so solves are deterministic.  Every
window stores at least one chunk, so all five dots cover every row (the
reference kernel's empty-window caveat never arises).

What bounds it on an H100: bytes -- K2's traffic (the walked slots,
1.05 x nnz on the 3.4 M-row sAMG, where every stored slot would be 2.70
x) plus w1 and w2 read once and the partials written and read once.

The port's ``matvec_dots`` closures return ``(y, dots)`` with ``dots``
one (5,) float32 tensor in the order above (the reference returns the
five as separate scalars): the solver reads all five with one transfer.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as R
from ._backend import check_blocked, kind_codes, resolve_backend, stream_of
from .sell_spmv import slab_fits, window_blocks

__all__ = ["fused_spmv_dots_kernel_call", "fused_matvec_dots",
           "make_matvec_dots"]


def _fn():
    lib = _build.load("fused_iter")
    fn = lib.fused_spmv_dots
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i] + [p] * 10 + [i, i, i, p]
        fn.restype = ctypes.c_int
        lib.fused_iter_gather_rows.argtypes = []
        lib.fused_iter_gather_rows.restype = ctypes.c_int
    return fn, lib.fused_iter_gather_rows


def fused_spmv_dots_kernel_call(val: torch.Tensor, col_idx: torch.Tensor,
                                block_start: torch.Tensor,
                                inv_perm: torch.Tensor,
                                warp_len: torch.Tensor, x: torch.Tensor,
                                w1: torch.Tensor, w2: torch.Tensor, *,
                                n_blocks: int, sigma: int, max_col: int):
    """(y, dots) through K3: y = A_sell @ x in ORIGINAL row order,
    (n_blocks * b_r,) float32, and dots = [<y,w1>, <y,w2>, <y,y>,
    <w2,w2>, <w1,w2>] as a (5,) float32 tensor.  Operands as for K2
    (``warp_len``: (n_blocks * b_r / 32,) int32, the diagonals each warp
    walks; ``ops.stored_warp_len`` walks them all); ``w1``/``w2`` are
    (n_blocks * b_r,) float32 carriers, zero past the real rows."""
    b_r = val.shape[1]
    n_pad = n_blocks * b_r
    x = check_blocked(val, col_idx, block_start, x, n_blocks, max_col,
                      vectors=[("inv_perm", inv_perm, n_pad),
                               ("warp_len", warp_len, n_pad // 32),
                               ("w1", w1, n_pad), ("w2", w2, n_pad)])
    if inv_perm.dtype != torch.int32 or warp_len.dtype != torch.int32:
        raise TypeError("inv_perm and warp_len must be int32")
    if w1.dtype != torch.float32 or w2.dtype != torch.float32:
        raise TypeError("w1 and w2 must be float32")
    if n_blocks < 1:
        raise ValueError("the fused pass needs at least one row block")
    fn, gather_rows = _fn()
    w_b = window_blocks(sigma, b_r, n_blocks)
    dev = x.device
    y = torch.empty(n_pad, dtype=torch.float32, device=dev)
    if slab_fits(w_b, b_r):
        scratch, n_part = None, -(-n_blocks // w_b)
    else:
        scratch, n_part = torch.empty_like(y), -(-n_pad // gather_rows())
    part = torch.empty((n_part, 5), dtype=torch.float32, device=dev)
    dots = torch.empty(5, dtype=torch.float32, device=dev)
    vk, ik = kind_codes(val, col_idx)
    rc = fn(val.data_ptr(), vk, col_idx.data_ptr(), ik,
            block_start.data_ptr(), inv_perm.data_ptr(), warp_len.data_ptr(),
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr(),
            part.data_ptr(), dots.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            n_blocks, b_r, w_b, stream_of(x))
    _build.check("fused_iter", rc, "fused_iter launch")
    fused_spmv_dots_kernel_call.launches += 1
    return y, dots


fused_spmv_dots_kernel_call.launches = 0


def fused_matvec_dots(a, x, w1, w2, *, backend: str = "auto"):
    """(y, dots) over a ``SELLDevice``: K3 for CUDA tensors, the plain
    version for CPU tensors.  Carriers live at the padded length
    ``a.n_rows_pad``."""
    if resolve_backend(x, backend) == "kernel":
        return fused_spmv_dots_kernel_call(
            a.val, a.col_idx, a.block_start, a.inv_perm, a.warp_len, x, w1,
            w2, n_blocks=a.n_blocks, sigma=a.sigma, max_col=a.max_col)
    return R.fused_matvec_dots_ref(a.val, a.col_idx, a.row_block,
                                   a.inv_perm, x, w1, w2, a.n_blocks)


def make_matvec_dots(a, *, backend: str = "auto"):
    """A closure over one ``SELLDevice`` for the fused solvers
    (``core.solvers.fused_cg``); build it once per operand."""
    def matvec_dots(v, w1, w2):
        return fused_matvec_dots(a, v, w1, w2, backend=backend)
    return matvec_dots
