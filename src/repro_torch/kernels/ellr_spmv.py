"""K4: ELLPACK-R sparse matrix-vector multiplication, hand-written for
Hopper (paper Listing 1, the baseline pJDS is measured against).

Replaces ``repro/kernels/ellr_spmv.py::ell_matvec_kernel_call`` (the
Pallas TPU kernel).  The CUDA source is ``csrc/ellr_spmv.cu``: one
thread per row in original order, reading ``j < rowlen[i]`` of the
jagged-diagonal-major ``(max_nzr, n_pad)`` arrays, so each diagonal is
one coalesced load across a warp.  The TPU kernel's ``tile_chunks`` /
``tile_r`` grid is TPU plumbing and has no counterpart.

Unlike the TPU kernel -- which computes every padded slot below its row
tile's longest row, so a non-finite ``x[0]`` leaks into short rows --
this kernel reads no slot past ``rowlen``, like the reference's plain
version (``ref.ell_matvec_ref``), which is what the CPU parity tests
compare against.

What bounds it on an H100: bytes -- nnz x (value + index width) plus
rowlen, x and y once; the 2 flops per slot are far below compute.  The
unsorted rows add a floor of their own: a 32-byte sector of the streams
spans 8 rows and is fetched while any of them runs (1.56 x nnz slots on
the 3.4 M-row sAMG).  So the kernel keeps loads in flight instead: each
warp loops to the longest of its rows, several diagonals per step, all
value and index loads of a step issued before its gathers and each
predicated by the lane's own ``rowlen``.  Each row sums in diagonal
order, so y keeps its bits from one build of the kernel to the next.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._backend import check_ell, kind_codes, stream_of

__all__ = ["ell_matvec_kernel_call"]


def _fn():
    fn = _build.load("ellr_spmv").ellr_spmv
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def ell_matvec_kernel_call(val: torch.Tensor, col_idx: torch.Tensor,
                           rowlen: torch.Tensor, x: torch.Tensor, *,
                           max_col: int) -> torch.Tensor:
    """y = A_ell @ x in the ORIGINAL row order, through K4.

    val/col_idx: (max_nzr, n_pad) f32|bf16 / int32|int16; rowlen:
    (n_pad,) int32 with every entry <= max_nzr; x: (> max_col,) f32|bf16
    on the same card.  Returns y: (n_pad,) float32."""
    x = check_ell(val, col_idx, rowlen, x, max_col)
    n_pad = val.shape[1]
    y = torch.empty(n_pad, dtype=torch.float32, device=x.device)
    vk, ik = kind_codes(val, col_idx)
    rc = _fn()(val.data_ptr(), vk, col_idx.data_ptr(), ik, rowlen.data_ptr(),
               x.data_ptr(), y.data_ptr(), n_pad, stream_of(x))
    _build.check("ellr_spmv", rc, "ellr_spmv launch")
    _build.count_launch(ell_matvec_kernel_call)
    return y


ell_matvec_kernel_call.launches = 0
