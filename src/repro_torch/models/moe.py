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

Over DTensors (a sharded model) :func:`moe_apply` keeps the one-device
semantics -- capacity and the sort over every token of the call -- by
gathering the tokens over the data axes; routing runs replicated, and
each rank runs its own experts (``expert`` on the model axis: E
divides it) or its slice of every expert's d_ff (the other configs),
as rank-local bodies (``sharding.local_call``) whose outputs are
partial sums over the model axis.  The reference's per-shard
constraints are layout hints with the same result.

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
from .sharding import is_dtensor, local_call, local_offset, shard

__all__ = ["moe_init", "moe_apply", "route", "capacity", "dispatch_shards",
           "dropped_assignments"]


def moe_init(gen: torch.Generator, cfg, dtype) -> nn.ParameterDict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = 1.0 / math.sqrt(d)
    p = nn.ParameterDict()
    p["router"] = C.dense_init(gen, d, e, torch.float32, spec=(None, None))
    # expert-parallel when E divides the production model axis (16);
    # otherwise tensor-parallel inside each expert on the d_ff dim
    ep = e % 16 == 0
    up = ("expert", None, None) if ep else (None, None, "model")
    down = ("expert", None, None) if ep else (None, "model", None)
    p["w1"] = C.param(C.normal(gen, (e, d, ff), scale, dtype), up)
    if cfg.act in ("silu", "geglu"):
        p["w3"] = C.param(C.normal(gen, (e, d, ff), scale, dtype), up)
    p["w2"] = C.param(C.normal(gen, (e, ff, d), scale, dtype), down)
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
    if is_dtensor(x):
        return _moe_sharded(p, cfg, x)
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


def _moe_sharded(p, cfg, x):
    """:func:`moe_apply` over DTensors: every token gathered to every
    rank (the one-device capacity and sort), the routing and aux loss
    replicated, then each rank's experts (or d_ff slices) over all
    tokens; their partial sums meet in the closing ``shard``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    b, s_len, d = x.shape
    t, e = b * s_len, cfg.n_experts
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    xt = x.redistribute(mesh, rep).reshape(t, d)
    w_r = p["router"]["w"]

    def routed(xt_, w_):
        probs, gates, experts = route({"router": {"w": w_}}, cfg, xt_)
        return gates, experts, _aux_loss(probs, experts, e)

    gates, experts, aux = local_call(
        routed, mesh, (xt, w_r), (rep, rep), (rep, rep), (rep, rep, rep),
        out_shapes=((t, cfg.top_k), (t, cfg.top_k), ()))
    names = [k for k in ("w1", "w3", "w2") if k in p]
    ws = [p[k] for k in names]
    # each part's gradient is this rank's share of the sum over the
    # model axis: Partial where the weights are split
    split = [i for i, pl in enumerate(ws[0].placements)
             if isinstance(pl, Shard)]
    part = [Partial() if i in split else Replicate()
            for i in range(mesh.ndim)]

    def experts_body(xt_, gates_, experts_, *w_local):
        local = dict(zip(names, w_local))
        lo = local_offset(mesh, ws[0].placements, 0, e)

        def ffn(buf):
            n_loc = local["w1"].shape[0]
            out = _experts_ffn(local, cfg, buf[lo:lo + n_loc])
            if n_loc == e:
                return out
            z = buf.new_zeros
            return torch.cat([z((lo, *buf.shape[1:])), out,
                              z((e - lo - n_loc, *buf.shape[1:]))])

        if cfg.moe_dispatch == "onehot":
            return _onehot_dispatch(cfg, xt_, gates_, experts_, ffn)
        return _sorted_dispatch(local, cfg, xt_, gates_, experts_,
                                dispatch_shards(cfg, t), ffn=ffn)

    y = local_call(experts_body, mesh, (xt, gates, experts, *ws),
                   (rep, rep, rep, *[w.placements for w in ws]),
                   (part, part, None, *[w.placements for w in ws]),
                   (part,), out_shapes=((t, d),))
    if "shared" in p:
        y = y + FF.ffn_apply(p["shared"], cfg, x).reshape(t, d)
    y = y.reshape(b, s_len, d).to(x.dtype)
    return shard(y, "batch", None, None), aux


def _sorted_dispatch(p, cfg, xt, gates, experts, shards: int, ffn=None):
    """Sorted (pJDS-style) dispatch of tokens xt (T, D), each of
    ``shards`` equal token shards sorted apart with a capacity of its
    own; the experts' GEMMs take every shard's blocks at once (through
    ``ffn``, (E, N, D) -> (E, N, D), default every expert of ``p``)."""
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
    ffn = ffn or (lambda blk: _experts_ffn(p, cfg, blk))
    out = ffn(buf.transpose(0, 1).reshape(e, shards * cap, d))
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
    t = b * s_len
    y = _onehot_dispatch(cfg, xt, gates, experts,
                         lambda buf: _experts_ffn(p, cfg, buf))
    if "shared" in p:
        y = y + FF.ffn_apply(p["shared"], cfg, x).reshape(t, d)
    y = y.reshape(b, s_len, d).to(x.dtype)
    return y, _aux_loss(probs, experts, cfg.n_experts)


def _onehot_dispatch(cfg, xt, gates, experts, ffn):
    """The one-hot dispatch and combine of tokens xt (T, D) around
    ``ffn`` (E, C, D) -> (E, C, D)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    onehot = F.one_hot(experts, e)                               # (T, k, E)
    flat = onehot.reshape(t * k, e)
    before = torch.cumsum(flat, dim=0) - flat                    # (T*k, E)
    pos_in_e = (before * flat).sum(-1).reshape(t, k)
    keep = pos_in_e < cap
    e_hot = onehot.to(xt.dtype)
    c_hot = (pos_in_e[..., None] == torch.arange(cap, device=xt.device)).to(
        xt.dtype)
    disp = (e_hot[..., :, None] * c_hot[..., None, :]
            * keep[..., None, None].to(xt.dtype))                # (T,k,E,C)
    buf = torch.einsum("td,tkec->ecd", xt, disp)
    out = ffn(buf)
    combine = disp * gates[..., None, None].to(xt.dtype)
    return torch.einsum("ecd,tkec->td", out, combine)


def _aux_loss(probs: torch.Tensor, experts: torch.Tensor,
              e: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum(mean router prob x
    fraction routed top-1)."""
    me = probs.mean(0)
    ce = F.one_hot(experts[:, 0], e).float().mean(0)
    return e * torch.sum(me * ce)
