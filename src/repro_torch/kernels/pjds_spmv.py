"""K1: pJDS sparse matrix-vector multiplication, hand-written for Hopper.

Replaces ``repro/kernels/pjds_spmv.py::pjds_matvec_kernel_call`` (the
Pallas TPU kernel, paper Listing 2).  The CUDA source is
``csrc/pjds_spmv.cu``: one thread per row lane of a pJDS row block,
each warp walking its block's jagged diagonals from
``block_start[b]`` with coalesced loads of ``val[j, :]`` /
``col[j, :]``.  The per-block extents are computed once at conversion
(``ops.to_device_pjds``) instead of per call, as the TPU kernel's
scalar-prefetched ``block_extents`` were.

What bounds it on an H100: bytes.  Blocks are padded to their longest
row and to ``diag_align`` (2.41 x nnz slots on the 3.4 M-row sAMG), so
each warp walks only its first ``warp_len`` diagonals (derived once at
conversion by ``ops.sell_warp_len``, the rule K2 uses; pJDS sorts rows
globally, so that is its first lane's length, 1.00002 x nnz there),
four diagonals per step so that several loads and gathers are in
flight, and adds the skipped padding's ``0 * x[0]`` once -- y keeps the
bits of the full walk, and a NaN or Inf in ``x[0]`` poisons the same
rows.  The bytes it must move are then the walked slots times (value +
index width), plus x, warp_len and block_start read once and y written
once; the 2 flops per slot are far below the card's compute rate.

``x_tiles`` has no counterpart: x is read whole through L2, so an
explicit tiling request computes the same y (``ops.pjds_matvec``
accepts and ignores it).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._backend import check_blocked, kind_codes, stream_of

__all__ = ["pjds_matvec_kernel_call"]


def _fn():
    fn = _build.load("pjds_spmv").pjds_spmv
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def pjds_matvec_kernel_call(val: torch.Tensor, col_idx: torch.Tensor,
                            block_start: torch.Tensor, warp_len: torch.Tensor,
                            x: torch.Tensor, *, n_blocks: int,
                            max_col: int) -> torch.Tensor:
    """y = A_pjds @ x in the permuted basis, through K1.

    val/col_idx: (total_jds, b_r) f32|bf16 / int32|int16; block_start:
    (n_blocks + 1,) int32 diagonal offsets; warp_len: (n_blocks * b_r /
    32,) int32, the diagonals each warp walks (``ops.sell_warp_len``;
    ``ops.stored_warp_len`` walks them all); x: (> max_col,) f32|bf16 on
    the same card.  Returns y: (n_blocks * b_r,) float32.  Raises on any
    operand the kernel does not take, and on a refused launch."""
    b_r = val.shape[1]
    x = check_blocked(val, col_idx, block_start, x, n_blocks, max_col,
                      vectors=[("warp_len", warp_len, n_blocks * b_r // 32)])
    if warp_len.dtype != torch.int32:
        raise TypeError("warp_len must be int32")
    y = torch.empty(n_blocks * b_r, dtype=torch.float32, device=x.device)
    vk, ik = kind_codes(val, col_idx)
    rc = _fn()(val.data_ptr(), vk, col_idx.data_ptr(), ik,
               block_start.data_ptr(), warp_len.data_ptr(), x.data_ptr(),
               y.data_ptr(), n_blocks, b_r, stream_of(x))
    _build.check("pjds_spmv", rc, "pjds_spmv launch")
    _build.count_launch(pjds_matvec_kernel_call)
    return y


pjds_matvec_kernel_call.launches = 0
