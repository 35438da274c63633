"""Residual blocks: one init / apply pair per layer kind.

Port of ``repro/models/blocks.py``.  Kinds: ``global`` and ``local``
(attention, then a dense FFN, the sparse FFN through ``ffn_apply``, or
MoE), ``recurrent`` (RG-LRU, then the FFN) and ``mamba`` (the fused
Mamba block).  ``cross=True`` adds encoder-decoder cross-attention
(``lnx``, ``xattn``) to an attention block.  ``cfg.parallel_block`` is
the PaLM-style parallel residual (attention and FFN read the same input,
``x + attn(ln1 x) + ffn(ln2 x)``; on a sharded model their partial sums
share one all-reduce): the reference's training forward honours it for
attention blocks without cross-attention, and the port's training,
prefill and decode all do (:func:`parallel`).  The reference's prefill
and decode ignore it (ROADMAP.md, queue 3).

Decode caches: an attention layer's ring buffer (``attention.py``), or
``{"self": ring, "xk", "xv"}`` with cross-attention, and ``{"conv",
"h"}`` for ``mamba`` and ``recurrent``.  Every decode step writes its
layer's cache in place.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as A
from . import common as C
from . import ffn as FF
from . import moe as MOE
from . import rglru as RG
from . import ssm as SSM

__all__ = ["KINDS", "check_kind", "parallel", "block_init",
           "block_apply_train", "block_apply_decode", "block_cache_init",
           "block_cache_specs", "cross_project", "cross_attend"]

KINDS = ("global", "local", "recurrent", "mamba")


def check_kind(cfg, kind: str) -> None:
    """Raise for an unknown layer kind."""
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")


def block_init(gen: torch.Generator, cfg, kind: str, *, use_moe: bool,
               cross: bool = False, dtype) -> nn.ModuleDict:
    check_kind(cfg, kind)
    dev = gen.device
    if kind == "mamba":
        return nn.ModuleDict({
            "ln": C.rmsnorm_init(cfg.d_model, dtype, dev),
            "mamba": SSM.mamba_init(gen, cfg, dtype)})
    p = nn.ModuleDict({"ln1": C.rmsnorm_init(cfg.d_model, dtype, dev)})
    if kind == "recurrent":
        p["rec"] = RG.rglru_init(gen, cfg, dtype)
    else:
        p["attn"] = A.attn_init(gen, cfg, dtype)
        if cross:
            p["lnx"] = C.rmsnorm_init(cfg.d_model, dtype, dev)
            p["xattn"] = A.attn_init(gen, cfg, dtype)
    p["ln2"] = C.rmsnorm_init(cfg.d_model, dtype, dev)
    if use_moe:
        p["moe"] = MOE.moe_init(gen, cfg, dtype)
    else:
        # MoE archs' dense layers use the wider combined width (deepseek)
        d_ff = cfg.d_ff * (cfg.top_k + cfg.n_shared_experts) \
            if cfg.n_experts else cfg.d_ff
        p["mlp"] = FF.ffn_init(gen, cfg, dtype, d_ff=d_ff)
    return p


def parallel(p, cfg, kind: str) -> bool:
    """Whether the block is a parallel residual one: an attention block
    without cross-attention of a ``parallel_block`` config."""
    return (cfg.parallel_block and kind in ("global", "local")
            and "xattn" not in p)


def _mix_ffn(p, cfg, x: torch.Tensor):
    """(FFN output, auxiliary loss): MoE's loss, or 0."""
    if "moe" in p:
        return MOE.moe_apply(p["moe"], cfg, x)
    return (FF.ffn_apply(p["mlp"], cfg, x),
            x.new_zeros((), dtype=torch.float32))


def cross_project(p, cfg, memory: torch.Tensor):
    """The encoder output's cross-attention keys and values (B, Se, Hkv,
    hd)."""
    hd = cfg.resolved_head_dim
    return (A._split_heads(C.dense_apply(p["xattn"]["wk"], memory),
                           cfg.n_kv_heads, hd),
            A._split_heads(C.dense_apply(p["xattn"]["wv"], memory),
                           cfg.n_kv_heads, hd))


def cross_attend(p, cfg, x: torch.Tensor, xk: torch.Tensor,
                 xv: torch.Tensor, *, decode: bool = False,
                 q_chunk: int = 512, k_chunk: int = 512) -> torch.Tensor:
    """x plus its cross-attention over (xk, xv): non-causal, no RoPE; a
    decode step (one token) attends through ``decode_attend``, as the
    reference's does through ``decode_attention``."""
    hx = C.rmsnorm(p["lnx"], x, cfg.norm_eps)
    b, s = hx.shape[:2]
    # constrained as the self-attention's packed q: a residual that
    # arrives split over the hidden dim would leave q a Partial sum, and
    # the attention would run every head on each rank
    qp = A.shard(C.dense_apply(p["xattn"]["wq"], hx), "batch", None, "model")
    q = A._split_heads(qp, cfg.n_heads, cfg.resolved_head_dim)
    if decode:      # every encoder position is valid
        s_enc = xk.shape[1]
        kv_pos = torch.arange(s_enc, dtype=torch.int32,
                              device=x.device).expand(b, s_enc)
        o = A.decode_attend(q, xk, xv, kv_pos,
                            torch.full((b,), s_enc, dtype=torch.int32,
                                       device=x.device))
    else:
        o = A.attend(q, xk, xv, causal=False, window=None, q_chunk=q_chunk,
                     k_chunk=k_chunk)
    return x + C.dense_apply(p["xattn"]["wo"], A.merge_heads(o))


def block_apply_train(p, cfg, kind: str, x: torch.Tensor,
                      positions: torch.Tensor, *, causal: bool = True,
                      memory: torch.Tensor | None = None,
                      q_chunk: int = 512, k_chunk: int = 512):
    """Full-sequence block.  ``memory``: the encoder output, for
    cross-attention.  Returns (x_out, aux_loss)."""
    if kind == "mamba":
        h, _ = SSM.mamba_apply_train(p["mamba"], cfg,
                                     C.rmsnorm(p["ln"], x, cfg.norm_eps))
        return x + h, x.new_zeros((), dtype=torch.float32)
    h = C.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "recurrent":
        h, _ = RG.rglru_apply_train(p["rec"], cfg, h)
    else:
        h, _ = A.attn_apply_train(p["attn"], cfg, h, positions,
                                  is_local=(kind == "local"), causal=causal,
                                  q_chunk=q_chunk, k_chunk=k_chunk)
        if parallel(p, cfg, kind):
            h2, aux = _mix_ffn(p, cfg, C.rmsnorm(p["ln2"], x, cfg.norm_eps))
            return x + h + h2, aux
    x = x + h
    if "xattn" in p and memory is not None:
        xk, xv = cross_project(p, cfg, memory)
        x = cross_attend(p, cfg, x, xk, xv, q_chunk=q_chunk,
                         k_chunk=k_chunk)
    h2, aux = _mix_ffn(p, cfg, C.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h2, aux


def block_apply_decode(p, cfg, kind: str, x: torch.Tensor, cache: dict,
                       pos: torch.Tensor):
    """Single-token step; updates ``cache`` in place.  Returns (x_out,
    cache)."""
    if kind == "mamba":
        h, _ = SSM.mamba_apply_decode(
            p["mamba"], cfg, C.rmsnorm(p["ln"], x, cfg.norm_eps), cache)
        return x + h, cache
    h = C.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "recurrent":
        h, _ = RG.rglru_apply_decode(p["rec"], cfg, h, cache)
    else:
        h, _ = A.attn_apply_decode(p["attn"], cfg, h, cache.get("self",
                                                                cache),
                                   pos, is_local=(kind == "local"))
        if parallel(p, cfg, kind):
            h2, _ = _mix_ffn(p, cfg, C.rmsnorm(p["ln2"], x, cfg.norm_eps))
            return x + h + h2, cache
    x = x + h
    if "xattn" in p and "xk" in cache:
        x = cross_attend(p, cfg, x, cache["xk"], cache["xv"], decode=True)
    h2, _ = _mix_ffn(p, cfg, C.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h2, cache


def block_cache_init(cfg, kind: str, batch: int, max_len: int, *,
                     cross: bool = False, dtype, device=None) -> dict:
    check_kind(cfg, kind)
    if kind == "mamba":
        return SSM.mamba_cache_init(cfg, batch, dtype, device)
    if kind == "recurrent":
        return RG.rglru_cache_init(cfg, batch, dtype, device)
    c = A.attn_cache_init(cfg, batch, max_len, is_local=(kind == "local"),
                          dtype=dtype, device=device)
    if not cross:
        return c
    shape = (batch, cfg.frontend_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"self": c,
            "xk": torch.zeros(shape, dtype=dtype, device=device),
            "xv": torch.zeros(shape, dtype=dtype, device=device)}


def block_cache_specs(cfg, kind: str, *, cross: bool = False) -> dict:
    """Logical specs of :func:`block_cache_init`'s cache, as the
    reference's."""
    if kind == "mamba":
        return SSM.mamba_cache_specs()
    if kind == "recurrent":
        return RG.rglru_cache_specs()
    c = A.attn_cache_specs(cfg, is_local=(kind == "local"))
    if not cross:
        return c
    xkv = ("batch", None, "model", None) if cfg.n_kv_heads % 16 == 0 \
        else ("batch", None, None, "model")
    return {"self": c, "xk": xkv, "xv": xkv}
