"""Mixture-of-experts FFN with sorted-token dispatch.

Port of ``repro/models/moe.py``.  The paper's pJDS row sort applied to
expert routing: tokens are sorted by the expert they are routed to, so
that each expert's tokens form one dense block for its GEMM, and each
block is padded to a fixed capacity ``C = ceil(T * top_k / E * cf)``,
as ELLPACK pads rows; an assignment past its expert's capacity is
dropped (Switch / GShard semantics).  ``T`` counts every token of the
call, so a token's output depends on the tokens routed beside it.

Three dispatches, as in the reference: the sorted one over the whole
token block (the reference's ``_sorted_dispatch``), the same per token
shard with capacity per shard (``_sorted_dispatch_sharded``, taken when
``cfg.moe_local_shards > 1`` divides T) -- one function here,
:func:`_sorted_dispatch`, the whole block being one shard -- and the
one-hot GShard baseline (``cfg.moe_dispatch == "onehot"``).  The
reference's ``shard(...)`` layout constraints have no counterpart on
one card.

**A deliberate difference.**  The reference combines the experts'
outputs with a scatter-add over the sorted assignments; on the card
``index_add_`` adds with atomics in no fixed order.  Here each sorted
contribution goes back to its (token, k) place and the k contributions
of a token are summed in a fixed order, so a run repeats bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import common as C
from . import ffn as FF

__all__ = ["moe_init", "moe_apply", "route", "capacity", "dispatch_shards",
           "dropped_assignments"]


def moe_init(gen: torch.Generator, cfg, dtype) -> nn.ParameterDict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = 1.0 / math.sqrt(d)
    p = nn.ParameterDict()
    p["router"] = C.dense_init(gen, d, e, torch.float32)
    p["w1"] = C.param(C.normal(gen, (e, d, ff), scale, dtype))
    if cfg.act in ("silu", "geglu"):
        p["w3"] = C.param(C.normal(gen, (e, d, ff), scale, dtype))
    p["w2"] = C.param(C.normal(gen, (e, ff, d), scale, dtype))
    if cfg.n_shared_experts:
        p["shared"] = FF.ffn_init(gen, cfg, dtype,
                                  d_ff=ff * cfg.n_shared_experts)
    return p


def route(p, cfg, xt: torch.Tensor):
    """Router over tokens xt (T, D), in float32.  Returns (probs (T, E),
    gates (T, k) renormalised, experts (T, k))."""
    logits = xt.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, experts


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for a block of ``tokens`` tokens."""
    return int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor))


def dispatch_shards(cfg, t: int) -> int:
    """How many token shards the sorted dispatch of T tokens sorts
    apart (1: the whole block)."""
    shards = cfg.moe_local_shards
    return shards if shards > 1 and t % shards == 0 else 1


def _positions(experts: torch.Tensor, shards: int):
    """Sort each shard's assignments by expert (stable).  Returns (order,
    sorted_expert, position of each sorted assignment in its expert's
    run), each (shards, T/shards * k)."""
    e_s = experts.reshape(shards, -1)
    order = torch.argsort(e_s, dim=1, stable=True)
    sorted_e = torch.gather(e_s, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, right=False)
    pos = torch.arange(e_s.shape[1], device=e_s.device)[None, :] - first
    return order, sorted_e, pos


def dropped_assignments(cfg, experts: torch.Tensor) -> int:
    """Assignments the sorted dispatch drops for this routing (T, k)."""
    t = experts.shape[0]
    shards = dispatch_shards(cfg, t)
    _, _, pos = _positions(experts, shards)
    return int((pos >= capacity(cfg, t // shards)).sum())


def _experts_ffn(p, cfg, buf: torch.Tensor) -> torch.Tensor:
    """Each expert's FFN over its block: buf (E, N, D) -> (E, N, D)."""
    act = C.activation(cfg.act)
    h = torch.bmm(buf, p["w1"].to(buf.dtype))
    if "w3" in p:
        h = act(h) * torch.bmm(buf, p["w3"].to(buf.dtype))
    else:
        h = act(h)
    return torch.bmm(h, p["w2"].to(buf.dtype))


def moe_apply(p, cfg, x: torch.Tensor):
    """x (B, S, D) -> (y (B, S, D), auxiliary loss)."""
    b, s_len, d = x.shape
    t = b * s_len
    xt = x.reshape(t, d)
    probs, gates, experts = route(p, cfg, xt)
    if cfg.moe_dispatch == "onehot":
        return _moe_onehot(p, cfg, x, xt, gates, experts, probs)
    y = _sorted_dispatch(p, cfg, xt, gates, experts,
                         dispatch_shards(cfg, t))
    if "shared" in p:
        y = y + FF.ffn_apply(p["shared"], cfg, x).reshape(t, d)
    y = y.reshape(b, s_len, d).to(x.dtype)
    return y, _aux_loss(probs, experts, cfg.n_experts)


def _sorted_dispatch(p, cfg, xt, gates, experts, shards: int):
    """Sorted (pJDS-style) dispatch of tokens xt (T, D), each of
    ``shards`` equal token shards sorted apart with a capacity of its
    own; the experts' GEMMs take every shard's blocks at once."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    tl = t // shards
    cap = capacity(cfg, tl)
    order, sorted_e, pos = _positions(experts, shards)  # (S, tl*k)
    keep = pos < cap
    token_of = order // k
    slot = torch.where(keep, sorted_e * cap + pos, e * cap)
    # scatter each shard's kept tokens into its (E, C, D) block buffer;
    # the last row of a shard is the overflow bin
    xt_s = xt.reshape(shards, tl, d)
    shard_of = torch.arange(shards, device=xt.device)[:, None].expand_as(slot)
    buf = xt.new_zeros((shards, e * cap + 1, d))
    buf[shard_of, slot] = xt_s[shard_of, token_of]
    buf = buf[:, :-1].reshape(shards, e, cap, d)
    # per-expert dense GEMMs over (E, shards * C, D)
    out = _experts_ffn(p, cfg, buf.transpose(0, 1).reshape(e, shards * cap,
                                                           d))
    out = out.reshape(e, shards, cap, d).transpose(0, 1).reshape(
        shards, e * cap, d)
    # combine: each sorted contribution back to its (token, k) place,
    # then the k of a token summed in order
    flat_gate = torch.gather(gates.reshape(shards, tl * k), 1, order)
    contrib = out[shard_of, torch.clamp(slot, max=e * cap - 1)]
    contrib = torch.where(keep[..., None], contrib, 0)
    contrib = contrib * flat_gate[..., None].to(contrib.dtype)
    placed = torch.empty_like(contrib)
    placed[shard_of, order] = contrib
    return placed.reshape(t, k, d).sum(dim=1)


def _moe_onehot(p, cfg, x, xt, gates, experts, probs):
    """The baseline dispatch: a dense one-hot (T, k, E, C) dispatch
    tensor (GShard-style einsums), the padded dispatch materialised even
    though only top_k entries per token are non-zero."""
    b, s_len, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s_len
    cap = capacity(cfg, t)
    onehot = F.one_hot(experts, e)                               # (T, k, E)
    flat = onehot.reshape(t * k, e)
    before = torch.cumsum(flat, dim=0) - flat                    # (T*k, E)
    pos_in_e = (before * flat).sum(-1).reshape(t, k)
    keep = pos_in_e < cap
    e_hot = onehot.to(xt.dtype)
    c_hot = (pos_in_e[..., None] == torch.arange(cap, device=x.device)).to(
        xt.dtype)
    disp = (e_hot[..., :, None] * c_hot[..., None, :]
            * keep[..., None, None].to(xt.dtype))                # (T,k,E,C)
    buf = torch.einsum("td,tkec->ecd", xt, disp)
    out = _experts_ffn(p, cfg, buf)
    combine = disp * gates[..., None, None].to(xt.dtype)
    y = torch.einsum("ecd,tkec->td", out, combine)
    if "shared" in p:
        y = y + FF.ffn_apply(p["shared"], cfg, x).reshape(t, d)
    y = y.reshape(b, s_len, d).to(x.dtype)
    return y, _aux_loss(probs, experts, e)


def _aux_loss(probs: torch.Tensor, experts: torch.Tensor,
              e: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum(mean router prob x
    fraction routed top-1)."""
    me = probs.mean(0)
    ce = F.one_hot(experts[:, 0], e).float().mean(0)
    return e * torch.sum(me * ce)
