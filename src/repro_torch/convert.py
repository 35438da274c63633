"""Carry device state across from the JAX package.

The reference's device containers (``PJDSDevice`` / ``SELLDevice`` /
``CSRDevice`` and the ``SparseDevice`` around them) hand over as numpy
arrays plus their static fields; :func:`sparse_device` rebuilds the
port's containers from exactly those arrays, so both packages then
compute the same ``y`` from the same stored bits.  Fields that are
Pallas grid plumbing (``chunk_map``, ``max_chunks``,
``max_win_chunks``) are ignored; the port derives its per-block
diagonal offsets from ``row_block``.  A bf16 value stream keeps its bit
patterns (numpy's bfloat16 comes across through a 16-bit view).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels._backend import resolve_device

__all__ = ["tensor_from_numpy", "blocked_device", "csr_device",
           "sparse_device"]


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
        return ops.SELLDevice(inv_perm=tensor_from_numpy(inv, dev),
                              sigma=int(statics["sigma"]), **common)
    return ops.PJDSDevice(**common)


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
                  device=None) -> ops.SparseDevice:
    """The port's ``SparseDevice`` from a reference ``SparseDevice``
    handed over as its format name, shape, inner container arrays and
    statics, and (pJDS) its global ``inv_perm``."""
    if fmt == "csr":
        inner = csr_device(arrays, statics, device)
    elif fmt in ("pjds", "sell"):
        inner = blocked_device(arrays, statics, device)
    else:
        raise ValueError(f"format {fmt!r} has no container in this slice")
    inv = None
    if fmt == "pjds":
        if inv_perm is None:
            raise ValueError("a pJDS operand needs its inv_perm")
        inv = tensor_from_numpy(
            np.asarray(inv_perm)[: shape[0]].astype(np.int32),
            inner.row_ids.device if fmt == "csr" else inner.val.device)
    return ops.SparseDevice(fmt=fmt, shape=tuple(shape), dev=inner,
                            inv_perm=inv, x_tiles=int(x_tiles))
