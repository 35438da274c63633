"""Residual blocks: one init / apply pair per layer kind.

Port of ``repro/models/blocks.py`` for the attention kinds, ``global``
and ``local`` (attention + dense FFN, or the sparse FFN through
``ffn_apply``).  The rest raises naming its ROADMAP item: ``mamba`` and
``recurrent`` (1.25), MoE layers (1.24), and the parallel residual
block (1.28), which exists to share one all-reduce between attention
and MLP on a sharded model.  Cross-attention (1.26) has no parameter
here: its families raise in ``build_model``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch._todo import not_ported

from . import attention as A
from . import common as C
from . import ffn as FF

__all__ = ["check_kind", "block_init", "block_forward", "block_apply_train",
           "block_apply_decode", "block_cache_init"]


def check_kind(cfg, kind: str, *, use_moe: bool = False) -> None:
    """Raise for a layer this port does not run yet."""
    if cfg.parallel_block:
        raise not_ported("the parallel residual block", "multi_card")
    if kind in ("mamba", "recurrent"):
        raise not_ported(f"the {kind!r} layer kind", "ssm")
    if kind not in ("global", "local"):
        raise ValueError(f"unknown layer kind {kind!r}")
    if use_moe:
        raise not_ported("mixture-of-experts layers", "moe")


def block_init(gen: torch.Generator, cfg, kind: str, *, use_moe: bool,
               dtype) -> nn.ModuleDict:
    check_kind(cfg, kind, use_moe=use_moe)
    # MoE archs' dense layers use the wider combined width (deepseek)
    d_ff = cfg.d_ff * (cfg.top_k + cfg.n_shared_experts) \
        if cfg.n_experts else cfg.d_ff
    return nn.ModuleDict({
        "ln1": C.rmsnorm_init(cfg.d_model, dtype, gen.device),
        "attn": A.attn_init(gen, cfg, dtype),
        "ln2": C.rmsnorm_init(cfg.d_model, dtype, gen.device),
        "mlp": FF.ffn_init(gen, cfg, dtype, d_ff=d_ff),
    })


def _mix_ffn(p, cfg, x: torch.Tensor):
    """(FFN output, auxiliary loss): the loss is MoE's, 0 here."""
    if "moe" in p:
        raise not_ported("mixture-of-experts layers", "moe")
    return (FF.ffn_apply(p["mlp"], cfg, x),
            x.new_zeros((), dtype=torch.float32))


def block_forward(p, cfg, kind: str, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True,
                  q_chunk: int = 512, k_chunk: int = 512):
    """Full-sequence block: (x_out, aux_loss, (k, v)), the attention's
    keys and values being what a prefill caches."""
    h = C.rmsnorm(p["ln1"], x, cfg.norm_eps)
    h, kv = A.attn_apply_train(p["attn"], cfg, h, positions,
                               is_local=(kind == "local"), causal=causal,
                               q_chunk=q_chunk, k_chunk=k_chunk)
    x = x + h
    h2, aux = _mix_ffn(p, cfg, C.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h2, aux, kv


def block_apply_train(p, cfg, kind: str, x: torch.Tensor,
                      positions: torch.Tensor, *, causal: bool = True,
                      q_chunk: int = 512, k_chunk: int = 512):
    """Full-sequence block.  Returns (x_out, aux_loss)."""
    x, aux, _ = block_forward(p, cfg, kind, x, positions, causal=causal,
                              q_chunk=q_chunk, k_chunk=k_chunk)
    return x, aux


def block_apply_decode(p, cfg, kind: str, x: torch.Tensor, cache: dict,
                       pos: torch.Tensor):
    """Single-token step; updates ``cache`` in place.  Returns (x_out,
    cache)."""
    h = C.rmsnorm(p["ln1"], x, cfg.norm_eps)
    h, cache = A.attn_apply_decode(p["attn"], cfg, h, cache, pos,
                                   is_local=(kind == "local"))
    x = x + h
    h2, _ = _mix_ffn(p, cfg, C.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h2, cache


def block_cache_init(cfg, kind: str, batch: int, max_len: int, *,
                     dtype, device=None) -> dict:
    check_kind(cfg, kind)
    return A.attn_cache_init(cfg, batch, max_len, is_local=(kind == "local"),
                             dtype=dtype, device=device)
