"""Dense FFN (SiLU / GeLU, gated or plain) and the sparse-FFN hook.

Port of ``repro/models/ffn.py``.  ``ffn_apply`` also takes an FFN whose
``w1`` / ``w3`` / ``w2`` are :class:`~repro_torch.sparse.sparse_ffn.
SparseLinear` modules (``sparse.sparsify_ffn_params``): it then runs
:func:`~repro_torch.sparse.sparse_ffn.sparse_ffn_apply`, whose products
are ``op @ X`` over the pruned weights (K5 on the card).
"""
from __future__ import annotations

import torch
from torch import nn

from . import common as C
from .sharding import shard

__all__ = ["ffn_init", "ffn_apply"]


def ffn_init(gen: torch.Generator, cfg, dtype,
             d_ff: int | None = None) -> nn.ModuleDict:
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    col, row = (None, "model"), ("model", None)
    p = nn.ModuleDict({"w1": C.dense_init(gen, d, ff, dtype, spec=col)})
    if cfg.act in ("silu", "geglu"):
        p["w3"] = C.dense_init(gen, d, ff, dtype, spec=col)
    p["w2"] = C.dense_init(gen, ff, d, dtype, spec=row)
    return p


def ffn_apply(p, cfg, x: torch.Tensor) -> torch.Tensor:
    # (imported here: repro_torch.sparse imports this package)
    from repro_torch.sparse.sparse_ffn import SparseLinear, sparse_ffn_apply
    if isinstance(p["w1"], SparseLinear):
        # SparseLinear leaves: the operator's spMM path
        return shard(sparse_ffn_apply(p, cfg, x), "batch", None, None)
    act = C.activation(cfg.act)
    h = shard(C.dense_apply(p["w1"], x), "batch", None, "model")
    if "w3" in p:
        h = act(h) * C.dense_apply(p["w3"], x)
    else:
        h = act(h)
    return shard(C.dense_apply(p["w2"], h), "batch", None, None)
