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

:func:`model_params` carries a model's param tree across (numpy arrays,
bits kept), one block per layer; :func:`sparse_linear` a reference
``SparseLinear``: its operand through :func:`sparse_device`, plus its
static fields.  :func:`adamw_state` carries a reference ``AdamWState``
across: ``m``, ``v`` and ``master`` share the params' structure, so
each goes through :func:`model_params`; the tests lay a ``jax.grad``
tree beside the port's ``.grad``s the same way.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.operator import DeviceOperator
from repro_torch.kernels import ops
from repro_torch.kernels._backend import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import param
from repro_torch.sparse.sparse_ffn import SparseLinear
from repro_torch.train.optimizer import AdamWState, trainable

__all__ = ["tensor_from_numpy", "blocked_device", "ell_device",
           "cmrs_device", "csr_device", "sparse_device", "sparse_linear",
           "param_tree", "model_params", "adamw_state"]


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


def sparse_linear(fmt: str, shape: Tuple[int, int],
                  arrays: Mapping[str, np.ndarray], statics: Mapping, *,
                  n_out: int, n_in_pad: int, sigma: int, density: float,
                  inv_perm: Optional[np.ndarray] = None, x_tiles: int = 1,
                  device=None) -> SparseLinear:
    """The port's ``SparseLinear`` of a reference one: its operand's
    ``SparseDevice`` handed over as :func:`sparse_device` takes it, and
    the layer's static fields."""
    sd = sparse_device(fmt, shape, arrays, statics, inv_perm=inv_perm,
                       x_tiles=x_tiles, device=device)
    return SparseLinear(DeviceOperator(sd), n_out, n_in_pad, sigma, density)


def param_tree(t: Mapping, dev) -> nn.Module:
    """A reference param dict (numpy leaves) as the port's modules: a
    dict of dicts becomes an ``nn.ModuleDict``, a dict holding arrays an
    ``nn.ParameterDict`` (its sub-dicts as modules inside it, as in a
    Mamba or MoE layer); a module (a ``SparseLinear``) stays."""
    if isinstance(t, nn.Module):
        return t
    if all(isinstance(v, (Mapping, nn.Module)) for v in t.values()):
        return nn.ModuleDict({k: param_tree(v, dev) for k, v in t.items()})
    out = nn.ParameterDict()
    for k, v in t.items():
        out[k] = (param_tree(v, dev) if isinstance(v, (Mapping, nn.Module))
                  else param(tensor_from_numpy(np.asarray(v), dev)))
    return out


def _layer(t, i: int):
    """Layer ``i`` of a tree whose arrays are stacked over layers."""
    if isinstance(t, Mapping):
        return {k: _layer(v, i) for k, v in t.items()}
    return np.asarray(t)[i]


def _unstack(stack: Mapping, plan) -> list:
    """A reference stack (``prefix``, ``periods`` -- each period
    position's blocks stacked over a leading layer axis -- and
    ``suffix``) as one block per layer, in the stack's order."""
    blocks = list(stack["prefix"])
    for i in range(plan.n_periods):
        blocks += [_layer(stack["periods"][f"b{j}"], i)
                   for j in range(len(plan.period_kinds))]
    return blocks + list(stack["suffix"])


def model_params(params: Mapping, cfg, device=None) -> nn.ModuleDict:
    """The port's params from the reference's ``Model.init`` tree, its
    leaves numpy arrays (``jax.device_get``).  Every array keeps its
    dtype and bits (bf16 included).  The decoder stack ``dec`` and an
    encoder-decoder's ``enc`` are unstacked into one block per layer, in
    the stack's order: prefix, periods x period kinds, suffix.  A leaf
    that is already a module (a :func:`sparse_linear`) is kept."""
    dev = resolve_device(device)
    plans = {"dec": T.make_plan(cfg, cfg.n_layers)}
    if cfg.is_encdec:
        plans["enc"] = T.make_plan(cfg, cfg.enc_layers,
                                   force_dense_pattern=True, moe_ok=False)
    out = nn.ModuleDict()
    for k, v in params.items():
        out[k] = (nn.ModuleList(param_tree(b, dev)
                                for b in _unstack(v, plans[k]))
                  if k in plans else param_tree(v, dev))
    return out


def adamw_state(state, cfg, params, device=None):
    """The port's ``AdamWState`` from the reference's (``step``, ``m``,
    ``v``, ``master``; numpy leaves), its moments and masters keyed and
    ordered as ``train.optimizer.trainable(params)`` orders the port's
    ``params``."""
    dev = resolve_device(device)

    def named(tree):
        t = dict(model_params(tree, cfg, dev).named_parameters())
        return {n: t[n].detach() for n in trainable(params)}

    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        m=named(state.m), v=named(state.v), master=named(state.master))
