"""K7: the transpose product z = A^T y over the stored layout,
hand-written for Hopper.

The reference has no Pallas kernel here: its transposes are
``segment_sum`` scatters in jnp (``repro/kernels/ref.py:108-180``,
reached from ``repro/kernels/ops.py:606-650``).  Ported directly they
would be ``index_add_`` on the card, whose float atomics add in an order
that changes from run to run.  The CUDA source is
``csrc/transpose_spmv.cu``: each column's products are added in
ascending slot order and z is written once, so the sum repeats bit for
bit and equals the plain version's (``ref.*_rmatvec_ref``, which adds in
the same order) for a finite y.

It needs per-operand arrays, built once on the device from the stored
arrays and kept by the operand (the values are read where they are
stored: no copy of the matrix is made):

* the **slot index** (:func:`slot_index`): the flat positions of the
  slots that hold more than padding, sorted stably by column (int32, 4
  bytes per non-zero), and a column pointer (``n_cols + 1`` int32);
* for pJDS, SELL and CMRS, **y's row of each slot** (:func:`slot_rows`,
  int32, 4 bytes per non-zero, original basis): ELLPACK-R's row is the
  slot's position, so y goes in as the operator holds it, unpadded and
  unpermuted (the kernel reads a row past y as 0);
* the **tile plans** (:func:`tile_plan`): the first column of each
  CTA's tile of whole columns (int32).  At k = 1 (:func:`staged`) a
  tile's slots fit a 16 KB buffer: the CTA stages their products with
  coalesced slot reads, then sums each column in slot order from shared
  memory.  At k > 1 a tile is up to 256 columns, one thread each, which
  walks its column with several slots' loads in flight, or one long
  column, which the CTA stages through the same buffer in chunks.

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

__all__ = ["slot_index", "slot_rows", "staged", "tile_slots",
           "buffer_slots", "tile_plan",
           "padding_mask", "transpose_matvec_kernel_call"]

# Shared memory a CTA stages products in; the right-hand sides one CTA
# takes (``kMaxK`` in the CUDA source); the columns of a walked tile
# (``kThreads``: one thread each) and of a staged one at most; the
# length above which a walked plan's column is staged by a CTA of its
# own.
TILE_BYTES = 16 * 1024
MAX_K_PER_CTA = 8
TILE_COLS = 256
STAGE_COLS = 1024
LONG_SLOTS = 128
# Entries the slot index and its rows hold past their end (and the
# alignment of their start): a thread reads its column's entries as
# aligned int4s, up to 15 past the last.
INDEX_PAD = 16


def slot_index(val: torch.Tensor, col_idx: torch.Tensor, real: torch.Tensor,
               n_cols: int) -> tuple:
    """The slot index of a stored operand: ``(slot, colptr)``.

    ``real`` is the boolean mask (``val``'s shape) of the slots that
    hold more than padding.  ``slot`` (nnz,) int32 are their flat
    positions, ordered by column and, within a column, by position (a
    stable sort); ``colptr`` (n_cols + 1,) int32 bounds each column's
    run.  ``slot``'s storage holds ``INDEX_PAD`` zeros past its end
    (the kernel reads aligned int4s).  Deterministic on the card (no
    atomics on floats)."""
    if val.numel() >= 2 ** 31:
        raise ValueError(f"{val.numel()} stored slots do not fit the "
                         f"index's int32 positions")
    pos = real.reshape(-1).nonzero().squeeze(1)
    cols = col_idx.reshape(-1)[pos].long()
    cols, order = torch.sort(cols, stable=True)
    slot = _padded(pos[order].to(torch.int32))
    colptr = torch.zeros(n_cols + 1, dtype=torch.int64, device=val.device)
    torch.cumsum(torch.bincount(cols, minlength=n_cols), 0,
                 out=colptr[1:])
    return slot, colptr.to(torch.int32)


def staged(k: int) -> bool:
    """Whether K7 stages every tile (k = 1) or walks a column per thread
    (k > 1, where a thread keeps a column's k sums in registers and
    staging pays a serial shared-memory pass per (column, j): 1.2-1.5 x
    slower on sAMG in ``kernel_ab.py --k7``)."""
    return k == 1


def tile_slots(k: int) -> int:
    """S: the slots a CTA stages at once for ``k`` right-hand sides
    (``TILE_BYTES`` of float32 products, at most ``MAX_K_PER_CTA`` of
    them per slot): 4096 at k = 1, 1024 at k = 4, 512 from k = 8.
    Every CTA of a launch that stages reserves it (:func:`buffer_slots`)."""
    return max(2, TILE_BYTES // (4 * min(max(k, 1), MAX_K_PER_CTA)))


def buffer_slots(k: int, longest: int) -> int:
    """The staging buffer, in slots, that a launch for ``k`` right-hand
    sides reserves when the longest column holds ``longest`` slots:
    :func:`tile_slots` where it stages (k = 1, or a column longer than
    ``LONG_SLOTS``), else none: every CTA then leaves that shared
    memory to the L1 cache (3-7 % at k = 4 on sAMG, ``kernel_ab.py
    --k7``)."""
    return tile_slots(k) if staged(k) or longest > LONG_SLOTS else 0


def tile_plan(colptr: torch.Tensor, slots: int = 0) -> torch.Tensor:
    """The CTA tiles of K7: (n_tiles + 1,) int32, the first column of
    each tile and ``n_cols`` last.  A tile holds whole consecutive
    columns.  A staged plan (``slots`` > 0: its buffer S) cuts the
    columns where a column starts past a multiple of S / 2 slots and
    every ``STAGE_COLS`` columns, and gives a column longer than S / 2 a
    tile of its own, so every tile of several columns fits S (a column
    longer than S is staged in chunks).  A walked plan (``slots`` 0)
    takes runs of at most ``TILE_COLS`` columns that start at a multiple
    of it, and gives a column longer than ``LONG_SLOTS`` a tile of its
    own (staged in chunks of :func:`tile_slots`)."""
    if slots < 0 or (slots and slots < 2):
        raise ValueError(f"bad tile plan buffer {slots}")
    n_cols = colptr.numel() - 1
    dev = colptr.device
    if n_cols <= 0:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    start = colptr[:-1].long()
    lens = colptr[1:].long() - start
    cols = torch.arange(n_cols, device=dev)
    if slots:
        h = slots // 2
        long_ = lens > h
        key = start // h
        grp = cols // STAGE_COLS
    else:
        long_ = lens > LONG_SLOTS
        key = grp = cols // TILE_COLS
    new = torch.ones(n_cols, dtype=torch.bool, device=dev)
    new[1:] = ((key[1:] != key[:-1]) | (grp[1:] != grp[:-1])
               | long_[1:] | long_[:-1])
    first = new.nonzero().squeeze(1).to(torch.int32)
    return torch.cat([first, first.new_full((1,), n_cols)])


def slot_rows(slot: torch.Tensor, n_rows: int, *, width: int,
              base: torch.Tensor | None = None,
              row_in_strip: torch.Tensor | None = None,
              row_map: torch.Tensor | None = None) -> torch.Tensor:
    """y's row of every slot of the index (int32, original basis, -1
    where the stored row is padding, i.e. maps to no row below
    ``n_rows``), from the slot's flat position ``p`` in the (rows,
    width) value array: ``(base[p // width] * width if base else 0) +
    (row_in_strip[p] if row_in_strip else p % width)``, then through
    ``row_map`` (the stored row's row of y) where given -- CMRS:
    ``base`` = strip_map and ``row_in_strip``; pJDS / SELL: ``base`` =
    row_block and ``row_map``.  Computed once, so that K7 reads it in
    place of those gathers (4 bytes per non-zero)."""
    p = slot.long()
    d = torch.div(p, width, rounding_mode="floor")
    r = (base.long()[d] * width if base is not None else 0) + (
        row_in_strip.reshape(-1).long()[p] if row_in_strip is not None
        else p - d * width)
    if row_map is not None:
        r = row_map.long()[r]
    return _padded(torch.where((r >= 0) & (r < n_rows), r, -1)
                   .to(torch.int32))


def _padded(t: torch.Tensor) -> torch.Tensor:
    """``t`` (1-D int32) in a fresh buffer of ``INDEX_PAD`` more zeros;
    the view of its first ``t.numel()`` entries."""
    buf = torch.zeros(t.numel() + INDEX_PAD, dtype=t.dtype, device=t.device)
    buf[: t.numel()] = t
    return buf[: t.numel()]


def _is_padded(t: torch.Tensor) -> bool:
    """Whether ``t`` starts 16-byte aligned and its storage holds
    ``INDEX_PAD`` entries past its end (:func:`_padded`)."""
    size = t.untyped_storage().nbytes() // t.element_size()
    return (t.data_ptr() % 16 == 0
            and t.storage_offset() + t.numel() + INDEX_PAD <= size)


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
        fn.argtypes = [p, i, p, p, p, p, i, i, i, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def transpose_matvec_kernel_call(val: torch.Tensor, slot: torch.Tensor,
                                 colptr: torch.Tensor, y: torch.Tensor, *,
                                 width: int, n_rows: int,
                                 rows: torch.Tensor | None = None,
                                 plan: torch.Tensor | None = None,
                                 longest: int | None = None
                                 ) -> torch.Tensor:
    """z = A^T y through K7.

    val: the stored (rows, width) values, f32 or bf16; slot / colptr:
    :func:`slot_index`; rows: y's row of each slot (:func:`slot_rows`),
    or None for ELLPACK-R, whose row is the slot's position ``p %
    width``; y: (n_rows,) or (n_rows, k) on the same card, in the
    operator's own row basis, unpadded (a row past ``n_rows`` reads as
    0); plan: :func:`tile_plan` of ``colptr`` for the mode
    :func:`staged` picks (the operand keeps it; built here when None;
    either plan gives the same bits); longest: the longest column's
    slot count (the operand keeps it; read here when None), which sets
    :func:`buffer_slots`.  Returns z: (n_cols,) or (n_cols, k) float32.
    Raises on any operand the kernel does not take, and on a refused
    launch."""
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
    if rows is not None and (rows.dtype != torch.int32
                             or rows.shape != slot.shape):
        raise ValueError(f"rows must be int32 of shape {tuple(slot.shape)}")
    if not all(_is_padded(t) for t in (slot, rows) if t is not None):
        raise ValueError(f"slot and rows must be 16-byte aligned with "
                         f"{INDEX_PAD} entries of storage past their end "
                         f"(slot_index, slot_rows)")
    k = 1 if y.dim() == 1 else y.shape[1]
    stage = staged(k)
    if plan is None:
        plan = tile_plan(colptr, tile_slots(k) if stage else 0)
    if plan.dtype != torch.int32 or plan.dim() != 1 or plan.numel() < 1:
        raise ValueError("plan must be 1-D int32 (tile_plan)")
    for name, t in (("val", val), ("slot", slot), ("colptr", colptr),
                    ("rows", rows), ("plan", plan)):
        if t is None:
            continue
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_cols = colptr.shape[0] - 1
    yc = y.float().contiguous()
    z = torch.empty((n_cols,) + tuple(y.shape[1:]), dtype=torch.float32,
                    device=y.device)
    if k == 0 or n_cols == 0:
        return z.zero_()
    if longest is None:
        longest = int((colptr[1:] - colptr[:-1]).max())
    rc = _fn()(val.data_ptr(), VALUE_DTYPES.index(val.dtype),
               slot.data_ptr(), None if rows is None else rows.data_ptr(),
               colptr.data_ptr(), plan.data_ptr(), plan.numel() - 1, width,
               n_rows, yc.data_ptr(), z.data_ptr(), k,
               buffer_slots(k, longest), int(stage),
               stream_of(y))
    _build.check("transpose_spmv", rc, "transpose_spmv launch")
    _build.count_launch(transpose_matvec_kernel_call)
    return z


transpose_matvec_kernel_call.launches = 0
