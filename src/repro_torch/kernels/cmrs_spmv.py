"""K6: CMRS sparse matrix-vector multiplication, hand-written for Hopper.

Replaces ``repro/kernels/cmrs_spmv.py::cmrs_matvec_kernel_call`` (the
Pallas TPU kernel, which reduces each chunk of a strip with a one-hot
routing matmul on the MXU).  The CUDA source is ``csrc/cmrs_spmv.cu``:
one CTA per strip of ``b_r`` original-order rows, one thread per lane,
walking the strip one tile row at a time; the products are reduced by
row with a segmented warp scan and an in-order combine across warps
into a shared-memory accumulator -- no atomics, a fixed summation
order, so results repeat bit for bit.  Padding slots route ``0 * x[0]``
into row 0 of their strip, as in the reference.

What bounds it on an H100: bytes -- the stored slots x (value + index
width + 1 byte of ``row_in_strip``), plus x, the strip offsets and y
once.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._backend import check_blocked, kind_codes, stream_of

__all__ = ["cmrs_matvec_kernel_call"]


def _fn():
    fn = _build.load("cmrs_spmv").cmrs_spmv
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def cmrs_matvec_kernel_call(val: torch.Tensor, col_idx: torch.Tensor,
                            row_in_strip: torch.Tensor,
                            strip_start: torch.Tensor, x: torch.Tensor, *,
                            n_strips: int, max_col: int) -> torch.Tensor:
    """y = A_cmrs @ x in the ORIGINAL row order, through K6.

    val/col_idx/row_in_strip: (total_su, b_r) f32|bf16 / int32|int16 /
    int8 with every row id < b_r (checked at conversion); strip_start:
    (n_strips + 1,) int32 tile-row offsets; x: (> max_col,) f32|bf16.
    Returns y: (n_strips * b_r,) float32."""
    x = check_blocked(val, col_idx, strip_start, x, n_strips, max_col)
    if row_in_strip.dtype != torch.int8 or row_in_strip.shape != val.shape:
        raise ValueError(f"row_in_strip must be int8 of shape "
                         f"{tuple(val.shape)}")
    if row_in_strip.device != x.device or not row_in_strip.is_contiguous():
        raise ValueError("row_in_strip must be contiguous on x's card")
    b_r = val.shape[1]
    y = torch.empty(n_strips * b_r, dtype=torch.float32, device=x.device)
    vk, ik = kind_codes(val, col_idx)
    rc = _fn()(val.data_ptr(), vk, col_idx.data_ptr(), ik,
               row_in_strip.data_ptr(), strip_start.data_ptr(), x.data_ptr(),
               y.data_ptr(), n_strips, b_r, stream_of(x))
    _build.check("cmrs_spmv", rc, "cmrs_spmv launch")
    cmrs_matvec_kernel_call.launches += 1
    return y


cmrs_matvec_kernel_call.launches = 0
