"""GQA attention: chunked online-softmax attention for prefill, cached
decode, sliding windows (``local`` layers), RoPE, qk-norm, QKV bias.

Port of ``repro/models/attention.py``, plain PyTorch as the reference
is plain JAX (no Pallas kernel stands behind it).  ``flash_attention``
keeps the reference's pair schedule -- the (q-chunk, kv-chunk) pairs
that can interact, from :func:`block_pairs` -- and its arithmetic: the
online softmax in float32, rows with no valid key kept at ``m = -inf``,
and ``acc / max(l, 1e-30)``.  ``scaled_dot_product_attention`` is not
used: parity needs the reference's masking and summation.  The
reference's ``use_attn_impl`` switch only picks another XLA schedule
with the same result; the port has the one schedule (ROADMAP.md).

The decode cache is the reference's ring buffer (``k``, ``v``, ``pos``,
``ins``), but :func:`attn_apply_decode` writes the new token into it in
place and returns the same dict: a slice of its batch rows (a view) is
then a cache of its own, which the LM engine uses to run one slot.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import common as C

__all__ = ["block_pairs", "flash_attention", "decode_attention",
           "attn_init", "attn_apply_train", "attn_apply_decode",
           "attn_cache_init", "attn_cache_from_prefill"]


def block_pairs(n_q: int, n_k: int, q_chunk: int, k_chunk: int,
                causal: bool, window: Optional[int],
                kv_offset: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Static list of interacting (q_chunk_idx, kv_chunk_idx) pairs.
    ``kv_offset`` shifts q positions relative to kv positions (q token i
    sits at absolute position kv_offset + i), for chunked prefill."""
    qi_l, ki_l = [], []
    for i in range(n_q):
        q_lo = kv_offset + i * q_chunk
        q_hi = kv_offset + (i + 1) * q_chunk - 1
        for j in range(n_k):
            k_lo = j * k_chunk
            k_hi = (j + 1) * k_chunk - 1
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_hi < q_lo - window + 1:
                continue
            qi_l.append(i)
            ki_l.append(j)
    return (np.asarray(qi_l, np.int32), np.asarray(ki_l, np.int32))


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap else s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: int = 512, k_chunk: int = 512,
                    kv_offset: int = 0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, Hq, D), k / v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's
    dtype.  Chunk sizes shrink to the largest divisors of the sequence
    lengths, as in the reference."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    q_chunk = next(c for c in range(min(q_chunk, sq), 0, -1) if sq % c == 0)
    k_chunk = next(c for c in range(min(k_chunk, sk), 0, -1) if sk % c == 0)
    nq, nk = sq // q_chunk, sk // k_chunk
    scale = 1.0 / math.sqrt(d)

    qs = q.reshape(b, nq, q_chunk, hkv, g, d)
    ks = k.reshape(b, nk, k_chunk, hkv, d)
    vs = v.reshape(b, nk, k_chunk, hkv, d)
    pairs_q, pairs_k = block_pairs(nq, nk, q_chunk, k_chunk, causal, window,
                                   kv_offset)

    # float32, or float64 for float64 inputs (gradcheck)
    f32, dev = torch.promote_types(q.dtype, torch.float32), q.device
    # each q chunk's running state, replaced (never written in place) so
    # that autograd keeps every value the backward needs
    acc = [torch.zeros((b, q_chunk, hkv, g, d), dtype=f32, device=dev)
           for _ in range(nq)]
    m = [torch.full((b, q_chunk, hkv, g), -math.inf, dtype=f32, device=dev)
         for _ in range(nq)]
    l = [torch.zeros((b, q_chunk, hkv, g), dtype=f32, device=dev)
         for _ in range(nq)]
    q_arange = torch.arange(q_chunk, device=dev)
    k_arange = torch.arange(k_chunk, device=dev)

    for qi, ki in zip(pairs_q.tolist(), pairs_k.tolist()):
        s = torch.einsum("bqhgd,bkhd->bqhgk", qs[:, qi].to(f32),
                         ks[:, ki].to(f32)) * scale
        s = _softcap(s, logit_softcap)
        qpos = kv_offset + qi * q_chunk + q_arange
        kpos = ki * k_chunk + k_arange
        ok = torch.ones((q_chunk, k_chunk), dtype=torch.bool, device=dev)
        if causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            ok &= qpos[:, None] - kpos[None, :] < window
        bad = ~ok[None, :, None, None, :]
        s = s.masked_fill(bad, -math.inf)

        m_old, l_old = m[qi], l[qi]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        # rows with no valid kv yet keep m = -inf; make exp well-defined
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None]).masked_fill(bad, 0.0)
        corr = torch.where(torch.isneginf(m_old), 0.0,
                           torch.exp(m_old - m_safe))
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p, vs[:, ki].to(f32))
        acc[qi] = acc[qi] * corr[..., None] + pv
        l[qi] = l_old * corr + p.sum(dim=-1)
        m[qi] = m_new

    out = torch.stack(acc, 1) / torch.clamp(torch.stack(l, 1),
                                             min=1e-30)[..., None]
    return out.reshape(b, sq, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     pos: torch.Tensor, *, window: Optional[int] = None,
                     logit_softcap: float = 0.0) -> torch.Tensor:
    """q (B, 1, Hq, D) against a cache (B, S_cache, Hkv, D) whose slots
    hold absolute positions ``kv_positions`` (B, S_cache), -1 = empty;
    ``pos`` (B,) is each row's current position."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    s = _softcap(s, logit_softcap)
    ok = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window is not None:
        ok &= pos[:, None] - kv_positions < window
    s = s.masked_fill(~ok[:, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


# --------------------------------------------------------------------------
# Attention block (params + apply)
# --------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg, dtype) -> nn.ModuleDict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    p = nn.ModuleDict({
        "wq": C.dense_init(gen, d, hq * hd, dtype, bias=cfg.qkv_bias),
        "wk": C.dense_init(gen, d, hkv * hd, dtype, bias=cfg.qkv_bias),
        "wv": C.dense_init(gen, d, hkv * hd, dtype, bias=cfg.qkv_bias),
        "wo": C.dense_init(gen, hq * hd, d, dtype),
    })
    if cfg.qk_norm:
        p["qn"] = C.rmsnorm_init(hd, dtype, gen.device)
        p["kn"] = C.rmsnorm_init(hd, dtype, gen.device)
    return p


def _project_qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    b, sq, _ = x.shape
    hd = cfg.resolved_head_dim
    q = C.dense_apply(p["wq"], x).reshape(b, sq, cfg.n_heads, hd)
    k = C.dense_apply(p["wk"], x).reshape(b, sq, cfg.n_kv_heads, hd)
    v = C.dense_apply(p["wv"], x).reshape(b, sq, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = C.rmsnorm(p["qn"], q, cfg.norm_eps)
        k = C.rmsnorm(p["kn"], k, cfg.norm_eps)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply_train(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                     is_local: bool, causal: bool = True, q_chunk: int = 512,
                     k_chunk: int = 512):
    """Full-sequence attention (prefill).  Returns (out, (k, v))."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    window = cfg.window if is_local else None
    out = flash_attention(q, k, v, causal=causal, window=window,
                          q_chunk=q_chunk, k_chunk=k_chunk,
                          logit_softcap=cfg.logit_softcap)
    b, sq = x.shape[:2]
    return C.dense_apply(p["wo"], out.reshape(b, sq, -1)), (k, v)


def attn_apply_decode(p, cfg, x: torch.Tensor, cache: dict,
                      pos: torch.Tensor, *, is_local: bool):
    """Single-token decode step.  Writes the token's k / v / position
    into ``cache`` (dict of k, v, pos, ins) at each row's ring slot, in
    place, and returns (out, cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None])
    size = cache["k"].shape[1]
    slot = (cache["ins"] % size).long()          # (B,) ring insertion point
    bi = torch.arange(b, device=x.device)
    cache["k"][bi, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][bi, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][bi, slot] = pos.to(cache["pos"].dtype)
    cache["ins"] += 1
    window = cfg.window if is_local else None
    out = decode_attention(q, cache["k"], cache["v"], cache["pos"], pos,
                           window=window, logit_softcap=cfg.logit_softcap)
    return C.dense_apply(p["wo"], out.reshape(b, 1, -1)), cache


def attn_cache_init(cfg, batch: int, max_len: int, *, is_local: bool,
                    dtype=torch.bfloat16, device=None) -> dict:
    """KV cache: a ring of ``window`` slots for local layers, ``max_len``
    for global ones."""
    size = min(cfg.window, max_len) if is_local else max_len
    hd = cfg.resolved_head_dim
    shape = (batch, size, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32,
                          device=device),
        "ins": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def attn_cache_from_prefill(cfg, k: torch.Tensor, v: torch.Tensor, *,
                            is_local: bool, max_len: int) -> dict:
    """A decode cache from prefill K/V of shape (B, S, Hkv, D)."""
    b, s_in = k.shape[:2]
    dev = k.device
    size = min(cfg.window, max_len) if is_local else max_len
    pos_keep = torch.arange(s_in, dtype=torch.int32, device=dev)
    if is_local and s_in > size:
        k, v, pos_keep = k[:, -size:], v[:, -size:], pos_keep[-size:]
    kept = k.shape[1]
    c = attn_cache_init(cfg, b, max_len, is_local=is_local, dtype=k.dtype,
                        device=dev)
    # ring layout: token at absolute position p lives in slot p % size
    slots = (pos_keep % size).long() if is_local else torch.arange(
        kept, device=dev)
    c["k"][:, slots] = k
    c["v"][:, slots] = v
    c["pos"][:, slots] = pos_keep.expand(b, kept)
    c["ins"].fill_(s_in)
    return c
