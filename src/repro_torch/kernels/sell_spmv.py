"""K2: SELL-C-sigma sparse matrix-vector multiplication, hand-written for
Hopper, with the window-local unpermute fused.

Replaces ``repro/kernels/sell_spmv.py::sell_matvec_kernel_call`` (the
Pallas TPU kernel).  The CUDA source is ``csrc/sell_spmv.cu``: one CTA
per sigma-window of ``w_b = window_blocks(...)`` row blocks; the CTA
walks its blocks, drops the sorted row sums into a shared-memory slab
and writes them back out in ORIGINAL row order
(``y[i] = slab[inv_perm[i] - row0]``) -- the TPU kernel's "unpermute
without touching HBM".  When the slab would not fit 48 KB of shared
memory (``sigma >= n``, or sigma incommensurate with ``b_r``) the
unpermute goes through a scratch vector in device memory instead.

What bounds it on an H100: bytes.  Blocks are padded to their longest
row and to ``diag_align`` (2.70 x nnz slots on the 3.4 M-row sAMG), so
each warp walks only its first ``warp_len`` diagonals
(``ops.sell_warp_len``: up to the last slot of its 32 rows that is not
padding, 1.05 x nnz there), four diagonals per step so that several
loads and gathers are in flight, and adds the skipped padding's
``0 * x[0]`` once -- y is unchanged, and a NaN or Inf in ``x[0]``
poisons the same rows.  The bytes it must move are then the walked
slots times (value + index width), plus x, inv_perm, warp_len and
block_start read once and y written once.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._backend import check_blocked, kind_codes, stream_of

__all__ = ["sell_matvec_kernel_call", "window_blocks", "slab_fits",
           "SLAB_BYTES"]

# Static shared memory a CTA may use without an opt-in: the slab path's
# ceiling (sigma = 1024 rows of f32 is 4 KB).
SLAB_BYTES = 48 * 1024


def window_blocks(sigma: int, b_r: int, n_blocks: int) -> int:
    """Row blocks per output slab (``w_b``): the smallest block multiple
    whose row span is also a multiple of sigma, so every sigma-sized sort
    window -- and every entry of the inverse permutation -- lies inside
    one slab.  Falls back to the whole output when sigma and b_r are
    incommensurate or the window covers everything anyway."""
    if sigma >= n_blocks * b_r:
        return max(n_blocks, 1)
    if sigma >= b_r and sigma % b_r == 0:
        return sigma // b_r
    if sigma > 0 and b_r % sigma == 0:
        return 1
    return max(n_blocks, 1)


def slab_fits(w_b: int, b_r: int) -> bool:
    """Whether a window's f32 slab fits the shared-memory path."""
    return w_b * b_r * 4 <= SLAB_BYTES


def _fn():
    fn = _build.load("sell_spmv").sell_spmv
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def sell_matvec_kernel_call(val: torch.Tensor, col_idx: torch.Tensor,
                            block_start: torch.Tensor,
                            inv_perm: torch.Tensor, warp_len: torch.Tensor,
                            x: torch.Tensor, *, n_blocks: int, sigma: int,
                            max_col: int) -> torch.Tensor:
    """y = A_sell @ x in the ORIGINAL row order, through K2.

    Operands as for K1 plus ``inv_perm``: (n_blocks * b_r,) int32, the
    window-local inverse of the sigma-window row sort, and ``warp_len``:
    (n_blocks * b_r / 32,) int32, the diagonals each warp walks
    (``ops.sell_warp_len``; ``ops.stored_warp_len`` walks them all).
    Returns y: (n_blocks * b_r,) float32."""
    b_r = val.shape[1]
    n_pad = n_blocks * b_r
    x = check_blocked(val, col_idx, block_start, x, n_blocks, max_col,
                      vectors=[("inv_perm", inv_perm, n_pad),
                               ("warp_len", warp_len, n_pad // 32)])
    if inv_perm.dtype != torch.int32 or warp_len.dtype != torch.int32:
        raise TypeError("inv_perm and warp_len must be int32")
    w_b = window_blocks(sigma, b_r, n_blocks)
    y = torch.empty(n_pad, dtype=torch.float32, device=x.device)
    scratch = None if slab_fits(w_b, b_r) else torch.empty_like(y)
    vk, ik = kind_codes(val, col_idx)
    rc = _fn()(val.data_ptr(), vk, col_idx.data_ptr(), ik,
               block_start.data_ptr(), warp_len.data_ptr(),
               inv_perm.data_ptr(), x.data_ptr(), y.data_ptr(),
               None if scratch is None else scratch.data_ptr(),
               n_blocks, b_r, w_b, stream_of(x))
    _build.check("sell_spmv", rc, "sell_spmv launch")
    _build.count_launch(sell_matvec_kernel_call)
    return y


sell_matvec_kernel_call.launches = 0
