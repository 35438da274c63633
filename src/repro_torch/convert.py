"""Carry device state across from the JAX package.

The reference's device containers (``ELLDevice`` / ``PJDSDevice`` /
``SELLDevice`` / ``CMRSDevice`` / ``CSRDevice`` and the ``SparseDevice``
around them) hand over as numpy arrays plus their static fields;
:func:`sparse_device` rebuilds the port's containers from exactly those
arrays, so both packages then compute the same ``y`` from the same
stored bits.  Fields that are Pallas grid plumbing (``chunk_map``,
``max_chunks``, ``max_win_chunks``, ``tile_chunks``, ``tile_r``) are
ignored; the port derives its per-block (per-strip) offsets from
``row_block`` (``strip_map``).  A bf16 value stream keeps its bit
patterns (numpy's bfloat16 comes across through a 16-bit view).
CMRS's ``chunk_l`` is TPU tile plumbing as well, and is ignored.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels._backend import resolve_device

__all__ = ["tensor_from_numpy", "blocked_device", "ell_device",
           "cmrs_device", "csr_device", "sparse_device"]


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype and bits (bfloat16
    included, which ``torch.from_numpy`` does not take directly)."""
    a = np.array(a, copy=True, order="C")   # owned and writable
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _block_start(row_block: np.ndarray, n_blocks: int) -> np.ndarray:
    counts = np.bincount(row_block.astype(np.int64), minlength=n_blocks)
    start = np.zeros(n_blocks + 1, dtype=np.int32)
    np.cumsum(counts, out=start[1:])
    return start


def blocked_device(arrays: Mapping[str, np.ndarray], statics: Mapping,
                   device=None):
    """``PJDSDevice`` (or ``SELLDevice`` when ``arrays`` holds
    ``inv_perm`` and ``statics`` ``sigma``) from the reference
    container's arrays ``val``, ``col_idx``, ``row_block`` and statics
    ``n_blocks``, ``b_r``, ``chunk_l``."""
    dev = resolve_device(device)
    row_block = np.asarray(arrays["row_block"])
    col = np.asarray(arrays["col_idx"])
    n_blocks = int(statics["n_blocks"])
    common = dict(
        val=tensor_from_numpy(np.asarray(arrays["val"]), dev),
        col_idx=tensor_from_numpy(col, dev),
        row_block=tensor_from_numpy(row_block.astype(np.int32), dev),
        block_start=tensor_from_numpy(_block_start(row_block, n_blocks),
                                      dev),
        n_blocks=n_blocks, b_r=int(statics["b_r"]),
        chunk_l=int(statics["chunk_l"]),
        max_col=int(col.max(initial=0)))
    if "inv_perm" in arrays:
        inv = np.asarray(arrays["inv_perm"]).astype(np.int32)
        return ops.sell_container(inv_perm=tensor_from_numpy(inv, dev),
                                  sigma=int(statics["sigma"]), **common)
    return ops.pjds_container(**common)


def ell_device(arrays: Mapping[str, np.ndarray], device=None
               ) -> ops.ELLDevice:
    """``ELLDevice`` from the reference container's ``val``, ``col_idx``
    and ``rowlen``."""
    dev = resolve_device(device)
    val = np.asarray(arrays["val"])
    col = np.asarray(arrays["col_idx"])
    rowlen = np.asarray(arrays["rowlen"]).astype(np.int32)
    ops.check_rowlen(rowlen, val.shape[0], val.shape[1])
    return ops.ELLDevice(val=tensor_from_numpy(val, dev),
                         col_idx=tensor_from_numpy(col, dev),
                         rowlen=tensor_from_numpy(rowlen, dev),
                         max_col=int(col.max(initial=0)))


def cmrs_device(arrays: Mapping[str, np.ndarray], statics: Mapping,
                device=None) -> ops.CMRSDevice:
    """``CMRSDevice`` from the reference container's ``val``,
    ``col_idx``, ``row_in_strip``, ``strip_map`` and statics
    ``n_strips``, ``b_r``."""
    dev = resolve_device(device)
    strip_map = np.asarray(arrays["strip_map"])
    col = np.asarray(arrays["col_idx"])
    ris = np.asarray(arrays["row_in_strip"])
    n_strips, b_r = int(statics["n_strips"]), int(statics["b_r"])
    ops.check_row_in_strip(ris, b_r)
    return ops.cmrs_container(
        val=tensor_from_numpy(np.asarray(arrays["val"]), dev),
        col_idx=tensor_from_numpy(col, dev),
        row_in_strip=tensor_from_numpy(ris.astype(np.int8), dev),
        strip_map=tensor_from_numpy(strip_map.astype(np.int32), dev),
        strip_start=tensor_from_numpy(_block_start(strip_map, n_strips),
                                      dev),
        n_strips=n_strips, b_r=b_r,
        max_col=int(col.max(initial=0)))


def csr_device(arrays: Mapping[str, np.ndarray], statics: Mapping,
               device=None) -> ops.CSRDevice:
    """``CSRDevice`` from the reference container's ``data``,
    ``indices``, ``row_ids`` and static ``n_rows``."""
    dev = resolve_device(device)
    return ops.CSRDevice(
        data=tensor_from_numpy(np.asarray(arrays["data"]), dev),
        indices=tensor_from_numpy(np.asarray(arrays["indices"]), dev),
        row_ids=tensor_from_numpy(np.asarray(arrays["row_ids"]), dev),
        n_rows=int(statics["n_rows"]))


def sparse_device(fmt: str, shape: Tuple[int, int],
                  arrays: Mapping[str, np.ndarray], statics: Mapping, *,
                  inv_perm: Optional[np.ndarray] = None, x_tiles: int = 1,
                  pre_perm: Optional[np.ndarray] = None,
                  pre_inv: Optional[np.ndarray] = None,
                  device=None) -> ops.SparseDevice:
    """The port's ``SparseDevice`` from a reference ``SparseDevice``
    handed over as its format name, shape, inner container arrays and
    statics, (pJDS) its global ``inv_perm``, and the preprocessing
    permutation ``pre_perm`` / ``pre_inv`` when it has one."""
    if fmt == "csr":
        inner = csr_device(arrays, statics, device)
    elif fmt in ("pjds", "sell"):
        inner = blocked_device(arrays, statics, device)
    elif fmt == "ellpack_r":
        inner = ell_device(arrays, device)
    elif fmt == "cmrs":
        inner = cmrs_device(arrays, statics, device)
    else:
        raise ValueError(f"unknown format {fmt!r}")
    inv = None
    if fmt == "pjds":
        if inv_perm is None:
            raise ValueError("a pJDS operand needs its inv_perm")
        inv = tensor_from_numpy(
            np.asarray(inv_perm)[: shape[0]].astype(np.int32),
            inner.val.device)
    on = (inner.data if fmt == "csr" else inner.val).device
    pre = {name: tensor_from_numpy(np.asarray(v).astype(np.int32), on)
           for name, v in (("pre_perm", pre_perm), ("pre_inv", pre_inv))
           if v is not None}
    return ops.SparseDevice(fmt=fmt, shape=tuple(shape), dev=inner,
                            inv_perm=inv, x_tiles=int(x_tiles), **pre)
