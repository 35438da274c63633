"""K7: the transpose product z = A^T y over the stored layout,
hand-written for Hopper.

The reference has no Pallas kernel here: its transposes are
``segment_sum`` scatters in jnp (``repro/kernels/ref.py:108-180``,
reached from ``repro/kernels/ops.py:606-650``).  Ported directly they
would be ``index_add_`` on the card, whose float atomics add in an order
that changes from run to run.  The CUDA source is
``csrc/transpose_spmv.cu``: one thread per (column, right-hand side)
walks its column's slots in ascending slot order and writes z once, so
the sum repeats bit for bit and equals the plain version's
(``ref.*_rmatvec_ref``, which adds in the same order) for a finite y.

The walk needs a per-operand **slot index** (:func:`slot_index`), built
once on the device from the stored arrays: the flat positions of the
slots that hold more than padding, sorted stably by column (int32, 4
bytes per non-zero), and a column pointer (``n_cols + 1`` int32).  The
row of a slot is computed from its position and the format's metadata
(``row_block``, or ``strip_map`` and ``row_in_strip``), and the values
are read where they are stored: no copy of the matrix is made.

What bounds it on an H100: bytes -- the slot, the value and y at the
slot's row per non-zero, the column pointer and z per column; the value
and y reads are gathers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import PAD_COL
from . import _build
from ._backend import VALUE_DTYPES, stream_of

__all__ = ["slot_index", "padding_mask", "transpose_matvec_kernel_call"]


def slot_index(val: torch.Tensor, col_idx: torch.Tensor, real: torch.Tensor,
               n_cols: int) -> tuple:
    """The slot index of a stored operand: ``(slot, colptr)``.

    ``real`` is the boolean mask (``val``'s shape) of the slots that
    hold more than padding.  ``slot`` (nnz,) int32 are their flat
    positions, ordered by column and, within a column, by position (a
    stable sort); ``colptr`` (n_cols + 1,) int32 bounds each column's
    run.  Deterministic on the card (no atomics on floats)."""
    if val.numel() >= 2 ** 31:
        raise ValueError(f"{val.numel()} stored slots do not fit the "
                         f"index's int32 positions")
    pos = real.reshape(-1).nonzero().squeeze(1)
    cols = col_idx.reshape(-1)[pos].long()
    cols, order = torch.sort(cols, stable=True)
    slot = pos[order].to(torch.int32)
    colptr = torch.zeros(n_cols + 1, dtype=torch.int64, device=val.device)
    torch.cumsum(torch.bincount(cols, minlength=n_cols), 0,
                 out=colptr[1:])
    return slot, colptr.to(torch.int32)


def padding_mask(val: torch.Tensor, col_idx: torch.Tensor,
                 row_in_strip: torch.Tensor | None = None) -> torch.Tensor:
    """The slots of a blocked (pJDS / SELL / CMRS) operand that hold
    more than padding: the rule of ``ops.sell_warp_len`` /
    ``ops.cmrs_strip_nnz``."""
    real = (val != 0) | (col_idx != PAD_COL)
    if row_in_strip is not None:
        real |= row_in_strip != 0
    return real


def _fn():
    fn = _build.load("transpose_spmv").transpose_spmv
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def transpose_matvec_kernel_call(val: torch.Tensor, slot: torch.Tensor,
                                 colptr: torch.Tensor, y: torch.Tensor, *,
                                 width: int, n_rows: int,
                                 base: torch.Tensor | None = None,
                                 row_in_strip: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """z = A^T y through K7.

    val: the stored (rows, width) values, f32 or bf16; slot / colptr:
    :func:`slot_index`; base: (rows,) int32 row block or strip of each
    row of ``val`` (None for ELLPACK-R); row_in_strip: CMRS's int8 row
    ids (``val``'s shape) or None; y: (n_rows,) or (n_rows, k) on the
    same card, in the basis the stored rows index (pJDS / SELL: sorted;
    ELLPACK-R / CMRS: original, padded).  Returns z: (n_cols,) or
    (n_cols, k) float32.  Raises on any operand the kernel does not
    take, and on a refused launch."""
    if y.device.type != "cuda":
        raise ValueError(f"K7 needs a CUDA tensor; y is on {y.device}")
    if val.dim() != 2 or val.shape[1] != width:
        raise ValueError(f"val must be 2-D with rows of {width}; got "
                         f"{tuple(val.shape)}")
    if val.dtype not in VALUE_DTYPES:
        raise TypeError(f"stored values must be float32 or bfloat16; got "
                        f"{val.dtype}")
    if y.dim() not in (1, 2) or y.shape[0] != n_rows:
        raise ValueError(f"y must be ({n_rows},) or ({n_rows}, k); got "
                         f"{tuple(y.shape)}")
    if slot.dtype != torch.int32 or colptr.dtype != torch.int32 \
            or slot.dim() != 1 or colptr.dim() != 1:
        raise ValueError("slot and colptr must be 1-D int32")
    if base is not None and (base.dtype != torch.int32
                             or base.shape != (val.shape[0],)):
        raise ValueError(f"base must be int32 of shape ({val.shape[0]},)")
    if row_in_strip is not None and (row_in_strip.dtype != torch.int8
                                     or row_in_strip.shape != val.shape):
        raise ValueError("row_in_strip must be int8 of val's shape")
    for name, t in (("val", val), ("slot", slot), ("colptr", colptr),
                    ("base", base), ("row_in_strip", row_in_strip)):
        if t is None:
            continue
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_cols = colptr.shape[0] - 1
    k = 1 if y.dim() == 1 else y.shape[1]
    yc = y.float().contiguous()
    z = torch.empty((n_cols,) + tuple(y.shape[1:]), dtype=torch.float32,
                    device=y.device)
    if k == 0 or n_cols == 0:
        return z.zero_()
    rc = _fn()(val.data_ptr(), VALUE_DTYPES.index(val.dtype),
               slot.data_ptr(), colptr.data_ptr(),
               None if base is None else base.data_ptr(),
               None if row_in_strip is None else row_in_strip.data_ptr(),
               width, yc.data_ptr(), z.data_ptr(), n_cols, k, stream_of(y))
    _build.check("transpose_spmv", rc, "transpose_spmv launch")
    _build.count_launch(transpose_matvec_kernel_call)
    return z


transpose_matvec_kernel_call.launches = 0
