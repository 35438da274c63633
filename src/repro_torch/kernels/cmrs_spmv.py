"""K6: CMRS sparse matrix-vector multiplication, hand-written for Hopper.

Replaces ``repro/kernels/cmrs_spmv.py::cmrs_matvec_kernel_call`` (the
Pallas TPU kernel, which reduces each chunk of a strip with a one-hot
routing matmul on the MXU).  The CUDA source is ``csrc/cmrs_spmv.cu``:
one warp per strip of ``b_r`` original-order rows, several strips per
CTA.  The warp walks the strip's slots as one flat run, 128 per step
with 16-byte loads and the next step's loads issued before the current
one is reduced; a segmented warp scan sums each row into a per-warp
shared-memory accumulator with one write per row -- no atomics and no
CTA barrier, a fixed summation order, so results repeat bit for bit.

What bounds it on an H100: bytes.  Strips are padded to ``diag_align``
tile rows (2.40 x nnz slots on the 3.4 M-row sAMG), so the warp walks
only ``strip_nnz`` slots (``ops.cmrs_strip_nnz``: up to the strip's last
slot that is not padding, 1.06 x nnz there) and adds the skipped
padding's ``0 * x[0]`` to row 0 once, as the reference routes it.  The
bytes it must move are the walked slots times (value + index width +
1 byte of ``row_in_strip``), plus x, the strip offsets and lengths read
once and y written once.
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
        fn.argtypes = [p, i, p, i, p, p, p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def cmrs_matvec_kernel_call(val: torch.Tensor, col_idx: torch.Tensor,
                            row_in_strip: torch.Tensor,
                            strip_start: torch.Tensor,
                            strip_nnz: torch.Tensor, x: torch.Tensor, *,
                            n_strips: int, max_col: int) -> torch.Tensor:
    """y = A_cmrs @ x in the ORIGINAL row order, through K6.

    val/col_idx/row_in_strip: (total_su, b_r) f32|bf16 / int32|int16 /
    int8 with every row id < b_r (checked at conversion); strip_start:
    (n_strips + 1,) int32 tile-row offsets; strip_nnz: (n_strips,) int32
    slots to walk per strip (``ops.cmrs_strip_nnz``;
    ``ops.stored_strip_nnz`` walks them all); x: (> max_col,) f32|bf16.
    Returns y: (n_strips * b_r,) float32."""
    x = check_blocked(val, col_idx, strip_start, x, n_strips, max_col,
                      vectors=[("strip_nnz", strip_nnz, n_strips)])
    if strip_nnz.dtype != torch.int32:
        raise TypeError("strip_nnz must be int32")
    if row_in_strip.dtype != torch.int8 or row_in_strip.shape != val.shape:
        raise ValueError(f"row_in_strip must be int8 of shape "
                         f"{tuple(val.shape)}")
    if row_in_strip.device != x.device or not row_in_strip.is_contiguous():
        raise ValueError("row_in_strip must be contiguous on x's card")
    # the kernel reads four slots of each stream with one load
    for name, t in (("val", val), ("col_idx", col_idx),
                    ("row_in_strip", row_in_strip)):
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name} must start on a "
                             f"{4 * t.element_size()}-byte boundary")
    b_r = val.shape[1]
    y = torch.empty(n_strips * b_r, dtype=torch.float32, device=x.device)
    vk, ik = kind_codes(val, col_idx)
    rc = _fn()(val.data_ptr(), vk, col_idx.data_ptr(), ik,
               row_in_strip.data_ptr(), strip_start.data_ptr(),
               strip_nnz.data_ptr(), x.data_ptr(), y.data_ptr(), n_strips,
               b_r, stream_of(x))
    _build.check("cmrs_spmv", rc, "cmrs_spmv launch")
    _build.count_launch(cmrs_matvec_kernel_call)
    return y


cmrs_matvec_kernel_call.launches = 0
