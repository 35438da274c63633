"""Device containers, the per-format products and the dispatch layer.

Port of ``repro/kernels/ops.py``:

* **Containers** -- ``to_device_{ell,pjds,sell,cmrs,csr}`` move a host
  format (``core.formats``) onto a device as plain dataclasses of
  tensors, with the kernel metadata computed once: the per-block (per
  strip) offsets ``block_start`` / ``strip_start`` that the kernels loop
  over, the block (strip) id per stored row that the plain versions
  segment-sum by, the largest stored column (checked against x), and
  for K1-K3, K5 and K6 how far the stored slots hold more than padding
  (``sell_warp_len`` / ``cmrs_strip_nnz``, derived on the device).
* **Products** -- ``ell_matvec`` (K4), ``pjds_matvec`` (K1),
  ``sell_matvec`` (K2), ``cmrs_matvec`` (K6) and ``pjds_matmat`` (K5)
  launch their kernel for a CUDA tensor and take the plain version for a
  CPU tensor; ``csr_matvec`` is plain torch everywhere, as in the
  reference (it has no kernel).
* **Dispatch** -- ``select_format`` prices the candidate formats with
  ``core.perf_model`` exactly as the reference does (same decision under
  the same spec; the port's default spec is the H100), and ``as_device``
  converts once, caches, and wraps the result in a :class:`SparseDevice`
  whose ``matvec`` / ``matmat`` work in the ORIGINAL basis.

Storage widths follow the reference: host float64 values are stored as
f32 (or bf16 with ``dtype=``), column indices as int32, or int16 when
the span fits (``index_dtype="auto"``).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import weakref
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch._todo import not_ported
from repro_torch.core import formats as F
from repro_torch.core import perf_model as PM
from . import ref as R
from ._backend import host_tensor, resolve_backend, resolve_device, value_dtype
from .cmrs_spmv import cmrs_matvec_kernel_call
from .ellr_spmv import ell_matvec_kernel_call
from .pjds_spmm import pjds_matmat_kernel_call
from .pjds_spmv import pjds_matvec_kernel_call
from .sell_spmv import sell_matvec_kernel_call, window_blocks

__all__ = [
    "ELLDevice",
    "PJDSDevice",
    "SELLDevice",
    "CMRSDevice",
    "CSRDevice",
    "SparseDevice",
    "to_device_ell",
    "to_device_pjds",
    "to_device_sell",
    "to_device_cmrs",
    "to_device_csr",
    "pjds_container",
    "sell_container",
    "cmrs_container",
    "sell_warp_len",
    "cmrs_strip_nnz",
    "stored_warp_len",
    "stored_strip_nnz",
    "ell_matvec",
    "pjds_matvec",
    "pjds_matmat",
    "sell_matvec",
    "cmrs_matvec",
    "csr_matvec",
    "select_format",
    "choose_x_tiles",
    "as_device",
    "clear_device_cache",
]


@dataclasses.dataclass(frozen=True)
class ELLDevice:
    """Device-resident ELLPACK-R operand, rows in ORIGINAL order:
    ``val`` / ``col_idx`` (max_nzr, n_rows_pad) jagged-diagonal-major,
    ``rowlen`` (n_rows_pad,) int32 (every entry <= max_nzr, checked at
    conversion), ``max_col`` the largest stored column index."""

    val: torch.Tensor
    col_idx: torch.Tensor
    rowlen: torch.Tensor
    max_col: int

    @property
    def n_rows_pad(self) -> int:
        return self.val.shape[1]


@dataclasses.dataclass(frozen=True)
class PJDSDevice:
    """Device-resident pJDS operand (permuted basis).  ``val`` is the f32
    or bf16 value stream, ``col_idx`` the int32 or int16 index stream,
    both (total_jds, b_r); ``block_start`` (n_blocks + 1,) int32 bounds
    each row block's diagonals for the kernels; ``warp_len``
    (n_blocks * ceil(b_r / 32),) int32 is the diagonals K1 and K5 walk
    for each 32 lanes of a block (:func:`sell_warp_len`); ``row_block``
    (total_jds,) int32 is the block of each diagonal for the plain
    version; ``max_col`` the largest stored column index."""

    val: torch.Tensor
    col_idx: torch.Tensor
    row_block: torch.Tensor
    block_start: torch.Tensor
    warp_len: torch.Tensor
    n_blocks: int
    b_r: int
    chunk_l: int
    max_col: int

    @property
    def n_rows_pad(self) -> int:
        return self.n_blocks * self.b_r


@dataclasses.dataclass(frozen=True)
class SELLDevice:
    """Device-resident SELL-C-sigma operand: the pJDS layout plus the
    window-local inverse permutation ``inv_perm`` (n_blocks * b_r,)
    int32 that K2/K3 apply inside each window, and ``warp_len``
    (n_blocks * ceil(b_r / 32),) int32, the diagonals K2, K3 and K5
    walk for each 32 lanes of a block (:func:`sell_warp_len`)."""

    val: torch.Tensor
    col_idx: torch.Tensor
    row_block: torch.Tensor
    block_start: torch.Tensor
    inv_perm: torch.Tensor
    warp_len: torch.Tensor
    n_blocks: int
    b_r: int
    chunk_l: int
    sigma: int
    max_col: int

    @property
    def n_rows_pad(self) -> int:
        return self.n_blocks * self.b_r


@dataclasses.dataclass(frozen=True)
class CMRSDevice:
    """Device-resident CMRS operand (``formats.CMRSMatrix``): strips of
    ``b_r`` original-order rows, nonzeros packed densely with an int8
    ``row_in_strip`` routing stream, all (total_su, b_r);
    ``strip_start`` (n_strips + 1,) int32 bounds each strip's tile rows
    for K6; ``strip_nnz`` (n_strips,) int32 is the slots K6 walks in
    each strip (:func:`cmrs_strip_nnz`); ``strip_map`` (total_su,) int32
    is the strip of each tile row for the plain version."""

    val: torch.Tensor
    col_idx: torch.Tensor
    row_in_strip: torch.Tensor
    strip_map: torch.Tensor
    strip_start: torch.Tensor
    strip_nnz: torch.Tensor
    n_strips: int
    b_r: int
    max_col: int

    @property
    def n_rows_pad(self) -> int:
        return self.n_strips * self.b_r


@dataclasses.dataclass(frozen=True)
class CSRDevice:
    """Device-resident CSR as flat nnz streams (gather + index_add_; the
    reference has no kernel for it either)."""

    data: torch.Tensor
    indices: torch.Tensor
    row_ids: torch.Tensor
    n_rows: int


def _blocked_parts(p: F.PJDSMatrix, chunk_l: int, dtype, device) -> dict:
    if np.any(p.block_len % chunk_l):
        raise ValueError(
            f"chunk_l={chunk_l} must divide every block length; rebuild the "
            f"matrix with diag_align a multiple of chunk_l")
    row_block = np.repeat(np.arange(p.n_blocks, dtype=np.int32),
                          p.block_len)
    return dict(
        val=host_tensor(p.val, device, value_dtype(dtype)),
        col_idx=host_tensor(p.col_idx, device),
        row_block=host_tensor(row_block, device),
        block_start=host_tensor(p.block_start, device),
        n_blocks=p.n_blocks, b_r=p.b_r, chunk_l=chunk_l,
        max_col=int(p.col_idx.max(initial=0)))


def check_rowlen(rowlen: np.ndarray, max_nzr: int, n_rows_pad: int) -> None:
    """K4 walks row i to ``rowlen[i]``: every entry must be <= max_nzr."""
    if rowlen.shape != (n_rows_pad,) or int(rowlen.max(initial=0)) > max_nzr:
        raise ValueError("rowlen must hold n_rows_pad lengths <= max_nzr")


def check_row_in_strip(ris: np.ndarray, b_r: int) -> None:
    """K6 accumulates by row id in a b_r-entry shared-memory array: every
    id must lie in [0, b_r)."""
    if ris.size and (int(ris.min()) < 0 or int(ris.max()) >= b_r):
        raise ValueError("row_in_strip values must lie in [0, b_r)")


# K1, K2, K3, K5 and K6 walk only the stored slots that hold more than
# padding.  How far that is comes from the stored arrays alone, by one
# reduction on the device, so a container carried across from the
# reference gets the same lengths as one built here.  A slot is padding when it is exactly
# what the builders pad with: val == 0 and col == PAD_COL (and, for
# CMRS, row id 0).  A stored explicit 0 at column 0 at the end of a row
# looks the same and is skipped too; that is harmless, since its
# product is the same 0 * x[0] that the kernels add once for skipped
# padding.


def sell_warp_len(val: torch.Tensor, col_idx: torch.Tensor,
                  row_block: torch.Tensor, block_start: torch.Tensor,
                  n_blocks: int) -> torch.Tensor:
    """K1's, K2's, K3's and K5's walk lengths (the pJDS layout they
    share), (n_blocks * ceil(b_r / 32),) int32: for each 32 lanes of a
    row block, the diagonals up to and including the last one in which
    any of them holds a non-padding slot (0 if none)."""
    total, b_r = val.shape
    w = -(-b_r // 32)
    real = (val != 0) | (col_idx != F.PAD_COL)
    if w * 32 != b_r:
        real = torch.cat([real, real.new_zeros(total, w * 32 - b_r)], 1)
    real = real.view(total, w, 32).any(dim=2)
    rb = row_block.long()
    # 1-based position of each stored diagonal inside its block
    j = (torch.arange(1, total + 1, dtype=torch.int32, device=val.device)
         - block_start[rb])
    out = torch.zeros((n_blocks, w), dtype=torch.int32, device=val.device)
    out.scatter_reduce_(0, rb[:, None].expand(total, w), j[:, None] * real,
                        "amax")
    return out.reshape(-1)


def cmrs_strip_nnz(val: torch.Tensor, col_idx: torch.Tensor,
                   row_in_strip: torch.Tensor, strip_map: torch.Tensor,
                   strip_start: torch.Tensor, n_strips: int) -> torch.Tensor:
    """K6's walk lengths, (n_strips,) int32: for each strip, the slots up
    to and including its last non-padding one, counted row-major from
    the strip's first slot (0 for an empty strip)."""
    total, b_r = val.shape
    real = (val != 0) | (col_idx != F.PAD_COL) | (row_in_strip != 0)
    sm = strip_map.long()
    tile = (torch.arange(total, dtype=torch.int32, device=val.device)
            - strip_start[sm])
    k = tile[:, None] * b_r + torch.arange(1, b_r + 1, dtype=torch.int32,
                                           device=val.device)
    last = (k * real).amax(dim=1)
    out = torch.zeros(n_strips, dtype=torch.int32, device=val.device)
    return out.scatter_reduce_(0, sm, last, "amax")


def stored_warp_len(block_start: torch.Tensor, b_r: int) -> torch.Tensor:
    """K1 / K2 / K3 / K5 lengths that walk every stored diagonal (a
    timing baseline)."""
    return (block_start[1:] - block_start[:-1]).repeat_interleave(
        -(-b_r // 32)).contiguous()


def stored_strip_nnz(strip_start: torch.Tensor, b_r: int) -> torch.Tensor:
    """K6 lengths that walk every stored slot (a timing baseline)."""
    return ((strip_start[1:] - strip_start[:-1]) * b_r).contiguous()


def to_device_ell(e: F.ELLMatrix, dtype=None, device=None) -> ELLDevice:
    """The reference's ``to_device_ell`` minus its TPU tile plumbing
    (``tile_chunks`` / ``chunk_l`` / ``tile_r``): K4 walks each row to
    its own ``rowlen``."""
    check_rowlen(e.rowlen, e.max_nzr, e.n_rows_pad)
    dev = resolve_device(device)
    return ELLDevice(val=host_tensor(e.val, dev, value_dtype(dtype)),
                     col_idx=host_tensor(e.col_idx, dev),
                     rowlen=host_tensor(e.rowlen.astype(np.int32), dev),
                     max_col=int(e.col_idx.max(initial=0)))


def to_device_cmrs(c: F.CMRSMatrix, dtype=None,
                   device=None) -> CMRSDevice:
    """The reference's ``to_device_cmrs`` minus its TPU tile plumbing
    (``chunk_l``): K6 walks each strip's slots as one flat run, whatever
    the strip's length."""
    check_row_in_strip(c.row_in_strip, c.b_r)
    dev = resolve_device(device)
    strip_map = np.repeat(np.arange(c.n_strips, dtype=np.int32),
                          c.strip_len)
    return cmrs_container(
        val=host_tensor(c.val, dev, value_dtype(dtype)),
        col_idx=host_tensor(c.col_idx, dev),
        row_in_strip=host_tensor(c.row_in_strip, dev),
        strip_map=host_tensor(strip_map, dev),
        strip_start=host_tensor(c.strip_start, dev),
        n_strips=c.n_strips, b_r=c.b_r,
        max_col=int(c.col_idx.max(initial=0)))


def cmrs_container(**fields) -> CMRSDevice:
    """A ``CMRSDevice`` from its stored tensors, with ``strip_nnz``
    derived from them (:func:`cmrs_strip_nnz`)."""
    nnz = cmrs_strip_nnz(fields["val"], fields["col_idx"],
                         fields["row_in_strip"], fields["strip_map"],
                         fields["strip_start"], fields["n_strips"])
    return CMRSDevice(strip_nnz=nnz, **fields)


def _fields_warp_len(fields: dict) -> torch.Tensor:
    return sell_warp_len(fields["val"], fields["col_idx"],
                         fields["row_block"], fields["block_start"],
                         fields["n_blocks"])


def pjds_container(**fields) -> PJDSDevice:
    """A ``PJDSDevice`` from its stored tensors, with ``warp_len``
    derived from them (:func:`sell_warp_len`)."""
    return PJDSDevice(warp_len=_fields_warp_len(fields), **fields)


def sell_container(**fields) -> SELLDevice:
    """A ``SELLDevice`` from its stored tensors, with ``warp_len``
    derived from them (:func:`sell_warp_len`)."""
    return SELLDevice(warp_len=_fields_warp_len(fields), **fields)


def to_device_pjds(p: F.PJDSMatrix, chunk_l: int = 8, dtype=None,
                   device=None) -> PJDSDevice:
    return pjds_container(**_blocked_parts(p, chunk_l, dtype,
                                           resolve_device(device)))


def to_device_sell(s: F.SELLMatrix, chunk_l: int = 8, dtype=None,
                   device=None) -> SELLDevice:
    p = s.pjds
    # K2/K3 index their shared-memory slab with inv_perm: every row must
    # stay inside its output window (true by construction; checked so a
    # corrupt operand raises here instead of reading out of bounds).
    span = window_blocks(s.sigma, p.b_r, p.n_blocks) * p.b_r
    rows = np.arange(p.n_rows_pad)
    if np.any(p.inv_perm // span != rows // span):
        raise ValueError("inv_perm moves rows across sigma windows")
    dev = resolve_device(device)
    return sell_container(inv_perm=host_tensor(p.inv_perm, dev),
                          sigma=s.sigma,
                          **_blocked_parts(p, chunk_l, dtype, dev))


def to_device_csr(m: F.CSRMatrix, dtype=None, device=None) -> CSRDevice:
    dev = resolve_device(device)
    row_ids = np.repeat(np.arange(m.n_rows, dtype=np.int32),
                        m.row_lengths())
    return CSRDevice(
        data=host_tensor(m.data, dev, value_dtype(dtype)),
        indices=host_tensor(m.indices, dev),
        row_ids=host_tensor(row_ids, dev),
        n_rows=m.n_rows,
    )


def pjds_matvec(a: PJDSDevice, x: torch.Tensor, backend: str = "auto",
                x_tiles: int = 1) -> torch.Tensor:
    """y = A x in the permuted basis; y has n_rows_pad entries.  K1 for
    a CUDA tensor, the plain version for a CPU tensor.  ``x_tiles`` is
    accepted for parity and changes nothing."""
    del x_tiles
    if resolve_backend(x, backend) == "kernel":
        return pjds_matvec_kernel_call(a.val, a.col_idx, a.block_start,
                                       a.warp_len, x, n_blocks=a.n_blocks,
                                       max_col=a.max_col)
    return R.pjds_matvec_ref(a.val, a.col_idx, a.row_block, x, a.n_blocks)


def pjds_matmat(a: PJDSDevice, x: torch.Tensor,
                backend: str = "auto") -> torch.Tensor:
    """Y = A X in the permuted basis; X (>= n_cols, k) -> (n_rows_pad, k).
    K5 for a CUDA tensor, the plain version for a CPU tensor.  Takes a
    ``SELLDevice`` too: its storage is the pJDS layout."""
    if resolve_backend(x, backend) == "kernel":
        return pjds_matmat_kernel_call(a.val, a.col_idx, a.block_start,
                                       a.warp_len, x, n_blocks=a.n_blocks,
                                       max_col=a.max_col)
    return R.pjds_matmat_ref(a.val, a.col_idx, a.row_block, x, a.n_blocks)


def _by_column(kernel, x: torch.Tensor, n_out: int) -> torch.Tensor:
    """A single-vector kernel applied to x (n,) or, one column at a time,
    to a block X (n, k).  The reference has no multi-RHS kernel for
    ELLPACK-R and CMRS and takes their plain versions with a 2-D x; on
    the card the port runs K4 / K6 once per column instead, so no plain
    version sits on the card's path."""
    if x.dim() == 1:
        return kernel(x)
    if x.shape[1] == 0:
        return torch.zeros((n_out, 0), dtype=torch.float32, device=x.device)
    return torch.stack([kernel(x[:, j].contiguous())
                        for j in range(x.shape[1])], dim=1)


def ell_matvec(a: ELLDevice, x: torch.Tensor,
               backend: str = "auto") -> torch.Tensor:
    """y = A x, ORIGINAL row order, n_rows_pad entries; x (n,) or a block
    (n, k).  K4 for a CUDA tensor, the plain version for a CPU tensor."""
    if resolve_backend(x, backend) == "kernel":
        return _by_column(lambda v: ell_matvec_kernel_call(
            a.val, a.col_idx, a.rowlen, v, max_col=a.max_col), x,
            a.n_rows_pad)
    return R.ell_matvec_ref(a.val, a.col_idx, a.rowlen, x)


def cmrs_matvec(a: CMRSDevice, x: torch.Tensor,
                backend: str = "auto") -> torch.Tensor:
    """y = A x, ORIGINAL row order, n_rows_pad entries; x (n,) or a block
    (n, k).  K6 for a CUDA tensor, the plain version for a CPU tensor."""
    if resolve_backend(x, backend) == "kernel":
        return _by_column(lambda v: cmrs_matvec_kernel_call(
            a.val, a.col_idx, a.row_in_strip, a.strip_start, a.strip_nnz, v,
            n_strips=a.n_strips, max_col=a.max_col), x, a.n_rows_pad)
    return R.cmrs_matvec_ref(a.val, a.col_idx, a.row_in_strip, a.strip_map,
                             x, a.n_strips)


def sell_matvec(a: SELLDevice, x: torch.Tensor, backend: str = "auto",
                x_tiles: int = 1) -> torch.Tensor:
    """y = A x with rows back in the ORIGINAL order; n_rows_pad entries.
    K2 for a CUDA tensor, the plain version for a CPU tensor."""
    del x_tiles
    if resolve_backend(x, backend) == "kernel":
        return sell_matvec_kernel_call(a.val, a.col_idx, a.block_start,
                                       a.inv_perm, a.warp_len, x,
                                       n_blocks=a.n_blocks, sigma=a.sigma,
                                       max_col=a.max_col)
    return R.sell_matvec_ref(a.val, a.col_idx, a.row_block, a.inv_perm, x,
                             a.n_blocks)


def csr_matvec(a: CSRDevice, x: torch.Tensor,
               backend: str = "auto") -> torch.Tensor:
    # No kernel for CSR in the reference either: the plain version IS
    # the implementation on every device.
    del backend
    return R.csr_matvec_ref(a.data, a.indices, a.row_ids, x, a.n_rows)


# --------------------------------------------------------------------------
# Unified dispatch
# --------------------------------------------------------------------------
_CSR_MIN_ROWS_FACTOR = 2       # below 2*b_r rows, block padding dominates
_CSR_IRREGULAR_FACTOR = 4.0    # scalar gather stream can't saturate HBM
_ELL_OVERHEAD_TOL = 0.05       # near-constant rows: skip sorting entirely


def _itemsize(dt) -> int:
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    if dt == "bfloat16":         # numpy knows the name only via ml_dtypes
        return 2
    return np.dtype(dt).itemsize


def select_format(
    m: F.CSRMatrix,
    *,
    b_r: int = 128,
    diag_align: int = 8,
    sigma: Optional[int] = None,
    spec: PM.TPUSpec = PM.H100,
    value_dtype=None,
    index_dtype="auto",
    x_tiles: int = 1,
) -> str:
    """Pick a storage format from row-length statistics alone -- the
    reference's rule, unchanged: price each candidate's predicted
    memory-bound spMVM time (stored widths as they will be stored, the
    RHS/LHS at the >= f32 vector width, plus the out-of-kernel
    permutation cost), then take the first minimum in the order
    ellpack_r < sell < pjds < cmrs.  CSR wins only for degenerate inputs.
    Values are priced at the host array's width (8 bytes for a float64
    matrix, though the device stores f32), as in the reference, so the
    decision stays the reference's."""
    n = m.n_rows
    if m.nnz == 0 or n < _CSR_MIN_ROWS_FACTOR * b_r:
        return "csr"
    rl = m.row_lengths()
    n_nzr = m.n_nzr
    if sigma is None:
        sigma = 8 * b_r
    vb = _itemsize(value_dtype) if value_dtype is not None \
        else m.data.dtype.itemsize
    vecb = max(4, m.data.dtype.itemsize)
    ib = F.resolve_index_dtype(index_dtype, m.shape[1]).itemsize
    n_row_blocks = -(-n // b_r)

    ell_elems = F.estimate_storage_elements(rl, "ellpack_r", b_r, diag_align)
    if x_tiles <= 1 and ell_elems / m.nnz - 1.0 <= _ELL_OVERHEAD_TOL:
        return "ellpack_r"    # rows (nearly) constant: no sort, no perm

    candidates = {
        "ellpack_r": PM.predicted_spmv_seconds(
            ell_elems, n, n_nzr, spec=spec, value_bytes=vb, index_bytes=ib,
            vec_bytes=vecb, fmt="ellpack_r"),
        "sell": PM.predicted_spmv_seconds(
            F.estimate_storage_elements(rl, "sell", b_r, diag_align, sigma),
            n, n_nzr,
            perm_bytes=PM.perm_traffic_bytes(n, vecb, window_local=True),
            spec=spec, value_bytes=vb, index_bytes=ib, vec_bytes=vecb,
            x_tiles=x_tiles, n_row_blocks=n_row_blocks, fmt="sell"),
        "pjds": PM.predicted_spmv_seconds(
            F.estimate_storage_elements(rl, "pjds", b_r, diag_align),
            n, n_nzr,
            perm_bytes=PM.perm_traffic_bytes(n, vecb, window_local=False),
            spec=spec, value_bytes=vb, index_bytes=ib, vec_bytes=vecb,
            x_tiles=x_tiles, n_row_blocks=n_row_blocks, fmt="pjds"),
    }
    cmrs_elems = F.estimate_storage_elements(rl, "cmrs", b_r, diag_align)
    candidates["cmrs"] = max(
        PM.predicted_spmv_seconds(
            cmrs_elems, n, n_nzr, spec=spec, value_bytes=vb,
            index_bytes=ib + PM.CMRS_RIS_BYTES, vec_bytes=vecb,
            x_tiles=x_tiles, n_row_blocks=n_row_blocks, fmt="cmrs"),
        PM.cmrs_reduce_seconds(cmrs_elems * x_tiles, b_r, spec))
    if x_tiles > 1:
        candidates.pop("ellpack_r")   # its kernel keeps x resident
    return min(candidates, key=candidates.get)


def choose_x_tiles(n_cols_pad: int, itemsize: int,
                   vmem_limit: Optional[int] = None) -> int:
    """The reference's column-tile count, kept as a dispatch decision:
    the smallest power of two whose x tile fits a quarter of the TPU
    v5e's VMEM (``perf_model.TPU_V5E``), 1 while x fits whole.  It
    decides the format pick (``select_format`` drops ELLPACK-R past 1)
    and fused eligibility exactly as in the reference; the CUDA kernels
    read x whole through L2 and ignore it."""
    if vmem_limit is None:
        vmem_limit = PM.TPU_V5E.vmem_bytes // 4
    t = 1
    while n_cols_pad * itemsize > t * vmem_limit and t < 4096:
        t *= 2
    return t


@dataclasses.dataclass
class SparseDevice:
    """A matrix ready for ``y = A x``: one chosen format, converted once.
    Whatever the inner format, ``matvec`` consumes x and returns y in the
    ORIGINAL basis (length ``shape[0]``)."""

    fmt: str
    shape: Tuple[int, int]
    dev: Union[ELLDevice, PJDSDevice, SELLDevice, CMRSDevice, CSRDevice]
    # pJDS only: the first n_rows entries of the inverse global row sort
    inv_perm: Optional[torch.Tensor]
    x_tiles: int = 1
    # SELL / pJDS on the card: K5's row map, built at the first matmat
    _out_row: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    # SELL: the fused solvers' pass and device loops, per backend, built
    # at the first fused solve (``api._fused_dots_of``)
    fused: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def values(self) -> torch.Tensor:
        return self.dev.data if self.fmt == "csr" else self.dev.val

    def storage_elements(self) -> int:
        """Stored value elements, padding included (the paper's measure)."""
        return self.values.numel()

    def stored_rows(self) -> torch.Tensor:
        """SELL / pJDS: the stored row of each original row."""
        return (self.dev.inv_perm[: self.n_rows] if self.fmt == "sell"
                else self.inv_perm)

    def row_map(self) -> torch.Tensor:
        """SELL / pJDS: K5's row map, the original row of each stored row
        (-1 for padding), the inverse of :meth:`stored_rows`; built once."""
        if self._out_row is None:
            inv = self.stored_rows()
            rows = torch.full((self.dev.n_rows_pad,), -1, dtype=torch.int32,
                              device=inv.device)
            rows[inv.long()] = torch.arange(self.n_rows, dtype=torch.int32,
                                            device=inv.device)
            if int((rows >= 0).sum()) != self.n_rows:
                raise ValueError("the row permutation is not a bijection")
            self._out_row = rows
        return self._out_row

    def _check_x(self, x: torch.Tensor) -> None:
        if x.shape[0] < self.shape[1]:
            raise ValueError(
                f"x has {x.shape[0]} entries; matrix has {self.shape[1]} "
                f"columns")
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}; the operand on "
                             f"{self.device}")

    def matvec(self, x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
        """y = A x, original basis, length shape[0]; a 2-D x goes to
        :meth:`matmat`."""
        if x.dim() == 2:
            return self.matmat(x, backend)
        if x.dim() != 1:
            raise ValueError(f"x must be 1-D; got shape {tuple(x.shape)}")
        self._check_x(x)
        if self.fmt == "csr":
            return csr_matvec(self.dev, x, backend)
        if self.fmt == "ellpack_r":
            return ell_matvec(self.dev, x, backend)[: self.n_rows]
        if self.fmt == "sell":
            return sell_matvec(self.dev, x, backend)[: self.n_rows]
        if self.fmt == "pjds":
            y_p = pjds_matvec(self.dev, x, backend)
            return y_p.index_select(0, self.inv_perm)
        if self.fmt == "cmrs":
            return cmrs_matvec(self.dev, x, backend)[: self.n_rows]
        raise ValueError(f"unknown format {self.fmt!r}")

    def matmat(self, x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
        """Y = A X for a block of right-hand sides, original basis:
        X (shape[1], k) -> (shape[0], k).

        SELL and pJDS run their pJDS layout through K5, which stores
        each row straight at its original position (the row map of
        :meth:`row_map`); the plain version unpermutes afterwards (SELL
        by its window-local ``inv_perm``, pJDS by the global one).
        ELLPACK-R and CMRS run K4 / K6 once per column on the card
        (``_by_column``); CSR is plain everywhere."""
        if x.dim() != 2:
            raise ValueError(f"X must be 2-D; got shape {tuple(x.shape)}")
        self._check_x(x)
        d = self.dev
        if self.fmt == "csr":
            return csr_matvec(d, x, backend)
        if self.fmt in ("sell", "pjds"):
            if resolve_backend(x, backend) == "kernel":
                return pjds_matmat_kernel_call(
                    d.val, d.col_idx, d.block_start, d.warp_len, x,
                    n_blocks=d.n_blocks, max_col=d.max_col,
                    out_row=self.row_map(), n_out=self.n_rows)
            return pjds_matmat(d, x, backend).index_select(
                0, self.stored_rows())
        if self.fmt == "ellpack_r":
            return ell_matvec(d, x, backend)[: self.n_rows]
        if self.fmt == "cmrs":
            return cmrs_matvec(d, x, backend)[: self.n_rows]
        raise ValueError(f"unknown format {self.fmt!r}")


# Conversion cache: host matrix -> device representation, keyed by the
# host object's id and the build parameters; a weakref callback evicts
# the entry when the host matrix is garbage-collected.
_DEVICE_CACHE: dict = {}

# Dense ndarray inputs get a small content-addressed LRU, so equal
# content maps to the same CSRMatrix object and the id-keyed cache hits.
_DENSE_CSR_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_DENSE_CSR_CACHE_MAX = 16


def _dense_to_csr_cached(a: np.ndarray) -> F.CSRMatrix:
    key = (a.shape, a.dtype.str,
           hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest())
    hit = _DENSE_CSR_CACHE.get(key)
    if hit is not None:
        _DENSE_CSR_CACHE.move_to_end(key)
        return hit
    m = F.csr_from_dense(a)
    _DENSE_CSR_CACHE[key] = m
    while len(_DENSE_CSR_CACHE) > _DENSE_CSR_CACHE_MAX:
        _DENSE_CSR_CACHE.popitem(last=False)
    return m


def clear_device_cache() -> None:
    _DEVICE_CACHE.clear()
    _DENSE_CSR_CACHE.clear()


def _cache_put(key, m, dev) -> None:
    try:
        ref = weakref.ref(m, lambda _unused, k=key: _DEVICE_CACHE.pop(k, None))
    except TypeError:            # not weakref-able: skip caching
        return
    _DEVICE_CACHE[key] = (ref, dev)


def as_device(
    a: Union[F.CSRMatrix, np.ndarray, SparseDevice],
    format: str = "auto",
    *,
    b_r: int = 128,
    diag_align: int = 8,
    sigma: Optional[int] = None,
    chunk_l: int = 16,
    dtype=None,
    index_dtype="auto",
    x_tiles: Union[int, str] = "auto",
    tune: str = "off",
    validate: str = "off",
    reorder: str = "off",
    device=None,
) -> SparseDevice:
    """Wrap a matrix as a :class:`SparseDevice`, converting at most once.

    ``a`` may be a host CSRMatrix, a dense ndarray, or an existing
    SparseDevice (returned unchanged).  ``device`` defaults to the
    current CUDA card and raises when there is none; pass
    ``device="cpu"`` for the plain versions.  ``dtype`` sets the stored
    value dtype (f32 or bf16), ``index_dtype`` the stored index dtype
    (``"auto"``: int16 when the column span fits).  ``x_tiles`` is the
    reference's column tiling (``"auto"``: :func:`choose_x_tiles`); it
    steers the format pick and fused eligibility as there, and the
    kernels ignore it.

    ``tune="auto"`` asks the autotuner (``repro_torch.tune.autotune``)
    for measured-best statics on ``device`` -- a hit in its persistent
    cache measures nothing -- and builds exactly ``best.build_kwargs()``
    (which own ``diag_align``, so a caller's ``diag_align`` is ignored);
    an explicit ``format`` restricts the search to it.  ``"force"``
    re-measures and never serves a conversion-cache hit.  ``reorder``
    other than ``"off"`` is not ported yet and raises
    ``NotImplementedError``.
    """
    if isinstance(a, SparseDevice):
        if format not in ("auto", a.fmt):
            raise ValueError(
                f"matrix already converted to {a.fmt!r}; asked for {format!r}")
        if device is not None and resolve_device(device) != a.device:
            raise ValueError(f"operand lives on {a.device}, not {device}")
        return a
    if isinstance(a, np.ndarray):
        a = _dense_to_csr_cached(a)
    if not isinstance(a, F.CSRMatrix):
        raise TypeError(f"cannot dispatch on {type(a)}")

    if validate not in ("off", "check", "repair"):
        raise ValueError(f"validate must be 'off', 'check' or 'repair'; "
                         f"got {validate!r}")
    if tune not in ("off", "auto", "force"):
        raise ValueError(f"tune must be 'off', 'auto' or 'force'; "
                         f"got {tune!r}")
    if reorder not in ("off", "auto", "rcm"):
        raise ValueError(f"reorder must be 'off', 'auto' or 'rcm'; "
                         f"got {reorder!r}")
    if reorder != "off":
        raise not_ported(f"reorder={reorder!r}", "reorder")
    dev = resolve_device(device)
    if validate != "off":
        a, _report = F.validate_csr(a, repair=(validate == "repair"))

    # Sized by the runtime vector width (>= f32), not the stored value
    # width, as in the reference.
    if x_tiles == "auto":
        x_tiles = choose_x_tiles(a.shape[1], max(4, a.data.dtype.itemsize))
    x_tiles = int(x_tiles)
    if x_tiles < 1:
        raise ValueError(f"x_tiles must be >= 1; got {x_tiles}")

    vdt = value_dtype(dtype)
    key = (id(a), format, b_r, diag_align, sigma, chunk_l,
           None if vdt is None else str(vdt),
           "auto" if index_dtype == "auto" else np.dtype(index_dtype).name,
           x_tiles, str(dev), tune)
    if tune != "force":      # force must re-measure, never serve a hit
        hit = _DEVICE_CACHE.get(key)
        if hit is not None and hit[0]() is a:
            return hit[1]

    if tune != "off":
        from repro_torch import tune as T   # deferred: tune imports ops
        best = T.autotune(a, format=format, dtype=dtype,
                          index_dtype=index_dtype, force=(tune == "force"),
                          device=dev).best
        # Rebuild with EXACTLY the geometry the tuner measured
        # (Candidate.build_kwargs owns diag_align).
        sd = as_device(a, dtype=dtype, index_dtype=index_dtype, tune="off",
                       device=dev, **best.build_kwargs())
        if tune != "force":
            _cache_put(key, a, sd)
        return sd

    # The kernels need diag_align % chunk_l == 0; raise it once here so
    # the selection pricing sees the same padding the converters produce.
    da = max(diag_align, chunk_l)
    fmt = format
    if fmt == "auto":
        fmt = select_format(a, b_r=b_r, diag_align=da, sigma=sigma,
                            value_dtype=vdt, index_dtype=index_dtype,
                            x_tiles=x_tiles)

    inv_perm = None
    if fmt == "csr":
        d = to_device_csr(a, dtype=vdt, device=dev)
    elif fmt == "sell":
        s = F.csr_to_sell(a, c=b_r, sigma=sigma, diag_align=da,
                          permuted_cols=False, index_dtype=index_dtype)
        d = to_device_sell(s, chunk_l=chunk_l, dtype=vdt, device=dev)
    elif fmt == "pjds":
        p = F.csr_to_pjds(a, b_r=b_r, diag_align=da, permuted_cols=False,
                          index_dtype=index_dtype)
        d = to_device_pjds(p, chunk_l=chunk_l, dtype=vdt, device=dev)
        inv_perm = host_tensor(p.inv_perm[: a.n_rows], dev)
    elif fmt == "ellpack_r":
        e = F.csr_to_ell(a, row_align=b_r, diag_align=da,
                         index_dtype=index_dtype)
        d = to_device_ell(e, dtype=vdt, device=dev)
    elif fmt == "cmrs":
        c = F.csr_to_cmrs(a, b_r=b_r, diag_align=da,
                          index_dtype=index_dtype)
        d = to_device_cmrs(c, dtype=vdt, device=dev)
    else:
        raise ValueError(f"unknown format {fmt!r}")

    sd = SparseDevice(fmt=fmt, shape=a.shape, dev=d, inv_perm=inv_perm,
                      x_tiles=x_tiles)
    _cache_put(key, a, sd)
    return sd
