"""Plain PyTorch versions of the spMVM kernels (the ``ref.py`` layer).

Each function is the specification of the matching hand-written kernel,
written with vectorised torch ops: a gather of ``x`` at the stored
column indices and an ``index_add_`` standing in for the reference's
``segment_sum``.  The wrappers take them only for tensors on the CPU;
on the card they serve as the yardstick the kernels are held against.

All operate on the device layout of ``ops.to_device_*``: zero values and
column ``PAD_COL`` in padded slots make masking unnecessary (a padded
lane gathers ``x[0]`` and multiplies it by 0, exactly as the reference
does -- so a NaN in ``x[0]`` poisons rows with padding in both).  The
one exception is ELLPACK-R, whose plain version masks by ``rowlen`` as
the reference's does (paper Listing 1), so its padding never reads x.
The ELLPACK-R and CMRS versions also take a block of right-hand sides,
``x`` of shape ``(n, k)``, as the reference's do.

Every call adds one to the function's ``calls`` attribute, so a run can
show that its main path never went through a plain version.
"""
from __future__ import annotations

import torch

from ._backend import acc_dtype

__all__ = ["pjds_matvec_ref", "pjds_matmat_ref", "sell_matvec_ref",
           "fused_matvec_dots_ref", "csr_matvec_ref", "ell_matvec_ref",
           "cmrs_matvec_ref", "reset_calls"]


def _block_sums(val, col_idx, row_block, x, n_blocks):
    """Sorted-basis y: per row lane, the sum of val * x[col] over its
    block's jagged diagonals, accumulated in f32 or wider."""
    b_r = val.shape[1]
    dt = acc_dtype(val.dtype, x.dtype)
    # int16 storage keeps bytes/nnz; the gather widens it to int32
    contrib = x[col_idx.int()].to(dt) * val.to(dt)       # (total_jds, b_r)
    y_blk = torch.zeros((n_blocks, b_r), dtype=dt, device=val.device)
    y_blk.index_add_(0, row_block, contrib)
    return y_blk.reshape(n_blocks * b_r)


def pjds_matvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                    row_block: torch.Tensor, x: torch.Tensor,
                    n_blocks: int) -> torch.Tensor:
    """pJDS y = A x in the permuted basis (paper Listing 2).

    val/col_idx: (total_jds, b_r); row_block: (total_jds,) int32 block
    id of each jagged diagonal; x: (>= n_cols,).  Returns
    (n_blocks * b_r,) in the accumulator dtype."""
    pjds_matvec_ref.calls += 1
    return _block_sums(val, col_idx, row_block, x, n_blocks)


def pjds_matmat_ref(val: torch.Tensor, col_idx: torch.Tensor,
                    row_block: torch.Tensor, x: torch.Tensor,
                    n_blocks: int) -> torch.Tensor:
    """pJDS Y = A X, multi-RHS, in the permuted basis.
    x: (>= n_cols, k) -> (n_blocks * b_r, k) in the accumulator dtype."""
    pjds_matmat_ref.calls += 1
    b_r = val.shape[1]
    k = x.shape[1]
    dt = acc_dtype(val.dtype, x.dtype)
    contrib = x[col_idx.int()].to(dt) * val.to(dt)[..., None]
    y_blk = torch.zeros((n_blocks, b_r, k), dtype=dt, device=val.device)
    y_blk.index_add_(0, row_block, contrib)
    return y_blk.reshape(n_blocks * b_r, k)


def sell_matvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                    row_block: torch.Tensor, inv_perm: torch.Tensor,
                    x: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """SELL-C-sigma y = A x back in the ORIGINAL row order: the storage
    layout matvec is pJDS's, then ``y[i] = y_sorted[inv_perm[i]]``."""
    sell_matvec_ref.calls += 1
    return _block_sums(val, col_idx, row_block, x, n_blocks)[inv_perm]


def fused_matvec_dots_ref(val, col_idx, row_block, inv_perm, x, w1, w2,
                          n_blocks: int):
    """The fused iteration's function: the SELL ``y = A x`` and the
    (5,) tensor ``[<y,w1>, <y,w2>, <y,y>, <w2,w2>, <w1,w2>]`` over every
    row."""
    fused_matvec_dots_ref.calls += 1
    y = _block_sums(val, col_idx, row_block, x, n_blocks)[inv_perm]
    w1c, w2c = w1.to(y.dtype), w2.to(y.dtype)
    dots = torch.stack([torch.dot(y, w1c), torch.dot(y, w2c),
                        torch.dot(y, y), torch.dot(w2c, w2c),
                        torch.dot(w1c, w2c)])
    return y, dots


def csr_matvec_ref(data: torch.Tensor, indices: torch.Tensor,
                   row_ids: torch.Tensor, x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """CSR y = A x as a flat gather + index_add_ over the nnz stream.
    The reference has no kernel for CSR either: this is its
    implementation on every device.  ``x`` may carry a trailing block
    axis: (n,) or (n, k)."""
    csr_matvec_ref.calls += 1
    dt = acc_dtype(data.dtype, x.dtype)
    xg = x[indices].to(dt)                       # (nnz,) or (nnz, k)
    d = data.to(dt)
    contrib = xg * (d[:, None] if xg.dim() == 2 else d)
    y = torch.zeros((n_rows, *xg.shape[1:]), dtype=dt, device=data.device)
    return y.index_add_(0, row_ids, contrib)


def ell_matvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                   rowlen: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ELLPACK-R y = A x (paper Listing 1), jagged-diagonal-major layout,
    rows in ORIGINAL order.

    val/col_idx: (max_nzr, n_pad); rowlen: (n_pad,); x: (>= n_cols,) or
    (>= n_cols, k).  Returns (n_pad,) or (n_pad, k).  Slots at or past a
    row's ``rowlen`` are masked out, so a non-finite x never reaches a
    row through its padding."""
    ell_matvec_ref.calls += 1
    dt = acc_dtype(val.dtype, x.dtype)
    j = torch.arange(val.shape[0], device=val.device)[:, None]
    mask = j < rowlen[None, :]
    xg = x[col_idx.int()].to(dt)                 # (max_nzr, n_pad[, k])
    v = val.to(dt)
    if xg.dim() == 3:
        v, mask = v[..., None], mask[..., None]
    return (xg * v).masked_fill(~mask, 0).sum(dim=0)


def cmrs_matvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                    row_in_strip: torch.Tensor, strip_map: torch.Tensor,
                    x: torch.Tensor, n_strips: int) -> torch.Tensor:
    """CMRS y = A x in the ORIGINAL row order (no permutation).

    val/col_idx/row_in_strip: (total_su, b_r); strip_map: (total_su,)
    int32 strip of each tile row.  Each slot adds into global row
    ``strip_map * b_r + row_in_strip``; padding slots carry val == 0 and
    route ``0 * x[0]`` into row 0 of their strip.  x: (>= n_cols,) or
    (>= n_cols, k); returns (n_strips * b_r[, k])."""
    cmrs_matvec_ref.calls += 1
    b_r = val.shape[1]
    dt = acc_dtype(val.dtype, x.dtype)
    rows = (strip_map[:, None].long() * b_r
            + row_in_strip.long()).reshape(-1)
    xg = x[col_idx.int()].to(dt)                 # (total_su, b_r[, k])
    v = val.to(dt)
    contrib = xg * (v[..., None] if xg.dim() == 3 else v)
    flat = contrib.reshape(rows.numel(), *contrib.shape[2:])
    y = torch.zeros((n_strips * b_r, *contrib.shape[2:]), dtype=dt,
                    device=val.device)
    return y.index_add_(0, rows, flat)


_COUNTED = (pjds_matvec_ref, pjds_matmat_ref, sell_matvec_ref,
            fused_matvec_dots_ref, csr_matvec_ref, ell_matvec_ref,
            cmrs_matvec_ref)


def reset_calls() -> None:
    """Set every plain-version call count to 0."""
    for fn in _COUNTED:
        fn.calls = 0


reset_calls()
