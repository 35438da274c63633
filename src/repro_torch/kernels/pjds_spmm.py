"""K5: pJDS sparse matrix times a block of right-hand sides, hand-written
for Hopper.

Replaces ``repro/kernels/pjds_spmm.py::pjds_matmat_kernel_call`` (the
Pallas TPU kernel behind block CG, the distributed matmat, the sparse
FFN and the serving block solves).  The CUDA source is
``csrc/pjds_spmm.cu``: K1's layout -- one CTA per row block, one thread
per row lane -- with a register tile of up to 8 accumulator columns per
thread; each gathered row of the row-major ``X`` is a contiguous run of
floats, read with 16-byte loads when ``k`` is a multiple of 4 and ``X``
is 16-byte aligned; each row of ``Y`` is stored the same way.  Wider
blocks run one column tile of 8 per grid row.  ``k == 0`` returns zeros
without a launch, as the reference does.  SELL reaches it through its
pJDS layout (``ops.SparseDevice.matmat``), which also hands it a row
map (``out_row``) so that each row is stored at its original position:
the unpermute is folded into the store instead of a separate pass.

What bounds it on an H100: bytes.  Blocks are padded to their longest
row and to ``diag_align`` (2.70 x nnz slots on the 3.4 M-row sAMG's SELL
layout), so each warp walks only its first ``warp_len`` diagonals (the
lengths K1 and K2 walk, ``ops.sell_warp_len``: 1.05 x nnz there),
several diagonals per step with their loads and X-row gathers in flight,
and adds the skipped padding's ``0 * X[0, c]`` once per column -- Y keeps
the bits of the full walk, and a NaN or Inf in ``X[0, c]`` poisons
column c of the same rows.  The bytes it must move are then the walked
slots x (value + index width) per column tile, ``X`` read and ``Y``
written once -- until k reaches the hundreds, where the 2 k flops per
slot take over.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._backend import check_blocked, kind_codes, stream_of

__all__ = ["pjds_matmat_kernel_call"]


def _fn():
    fn = _build.load("pjds_spmm").pjds_spmm
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def pjds_matmat_kernel_call(val: torch.Tensor, col_idx: torch.Tensor,
                            block_start: torch.Tensor, warp_len: torch.Tensor,
                            x: torch.Tensor, *, n_blocks: int, max_col: int,
                            out_row: Optional[torch.Tensor] = None,
                            n_out: int = 0) -> torch.Tensor:
    """Y = A_pjds @ X through K5.

    Operands as for K1 (``warp_len``: (n_blocks * b_r / 32,) int32, the
    diagonals each warp walks, ``ops.sell_warp_len``;
    ``ops.stored_warp_len`` walks them all); x: (> max_col, k) f32|bf16
    on the same card (a strided X is copied to row-major first).
    Returns Y float32: in the permuted basis, (n_blocks * b_r, k), or
    with a row map ``out_row`` (n_blocks * b_r,) int32 -- a bijection
    from the stored rows onto ``range(n_out)``, -1 for padding rows --
    as (n_out, k) with stored row p at row ``out_row[p]``."""
    b_r = val.shape[1]
    vectors = [("warp_len", warp_len, n_blocks * b_r // 32)]
    if out_row is not None:
        vectors.append(("out_row", out_row, n_blocks * b_r))
    x = check_blocked(val, col_idx, block_start, x, n_blocks, max_col,
                      vectors=vectors, x_dim=2)
    if warp_len.dtype != torch.int32:
        raise TypeError("warp_len must be int32")
    if out_row is not None and out_row.dtype != torch.int32:
        raise ValueError("out_row must be int32")
    k = x.shape[1]
    y = torch.empty((n_blocks * b_r if out_row is None else n_out, k),
                    dtype=torch.float32, device=x.device)
    if k == 0:
        return y
    # y is freshly allocated, so 16-byte aligned: x decides float4 use
    vec4 = int(k % 4 == 0 and x.data_ptr() % 16 == 0)
    vk, ik = kind_codes(val, col_idx)
    rc = _fn()(val.data_ptr(), vk, col_idx.data_ptr(), ik,
               block_start.data_ptr(), warp_len.data_ptr(), x.data_ptr(),
               None if out_row is None else out_row.data_ptr(), y.data_ptr(),
               n_blocks, b_r, k, vec4, stream_of(x))
    _build.check("pjds_spmm", rc, "pjds_spmm launch")
    _build.count_launch(pjds_matmat_kernel_call)
    return y


pjds_matmat_kernel_call.launches = 0
