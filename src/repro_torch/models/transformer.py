"""The block stack: a plan of layer kinds, and the stack as one module
per layer.

Port of ``repro/models/transformer.py``.  :func:`make_plan` is the
reference's (a prefix of layers that break the pattern, then periods of
the layer pattern, then the remainder).  The reference stacks each
period position's params over periods and scans; here the stack is an
``nn.ModuleList`` of one block per layer in the reference's order --
prefix, then periods x period kinds, then suffix -- walked by a Python
loop, and the decode cache is a list of one cache dict per layer in the
same order (``blocks.block_cache_init``).  :func:`stack_apply_train` is
the forward without caches (training, and an encoder's at prefill):
with ``remat`` each period's layers run under
``torch.utils.checkpoint`` and are recomputed in the backward, as the
reference checkpoints its scan body.  :func:`chunked_xent` is the loss
over sequence chunks, each chunk's float32 logits recomputed in the
backward, so that one chunk's logits are held at a time.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import blocks as B
from . import common as C
from . import rglru as RG
from . import ssm as SSM
from .sharding import (is_dtensor, local_call, local_offset, reduce_from,
                       split_axes)

__all__ = ["StackPlan", "make_plan", "layer_kinds", "stack_init",
           "stack_apply_train", "stack_apply_prefill", "stack_apply_decode",
           "stack_cache_init", "stack_cache_specs", "chunked_xent"]


@dataclasses.dataclass(frozen=True)
class StackPlan:
    prefix_kinds: tuple          # unrolled leading layers (absolute kinds)
    prefix_moe: tuple
    period_kinds: tuple          # one period
    period_moe: tuple
    n_periods: int
    suffix_kinds: tuple
    suffix_moe: tuple


def make_plan(cfg, n_layers: int, *, force_dense_pattern: bool = False,
              moe_ok: bool = True) -> StackPlan:
    pat = ("global",) if force_dense_pattern else cfg.layer_pattern
    k = len(pat)
    kinds = [pat[i % k] for i in range(n_layers)]
    moe = [bool(cfg.n_experts) and moe_ok and i >= cfg.first_k_dense
           for i in range(n_layers)]
    prefix = cfg.first_k_dense if (cfg.n_experts and moe_ok) else 0
    n_scan = n_layers - prefix
    n_periods = n_scan // k
    rem = n_scan % k
    return StackPlan(
        prefix_kinds=tuple(kinds[:prefix]),
        prefix_moe=tuple(moe[:prefix]),
        period_kinds=tuple(kinds[prefix:prefix + k]),
        period_moe=tuple(moe[prefix:prefix + k]),
        n_periods=n_periods,
        suffix_kinds=tuple(kinds[n_layers - rem:]),
        suffix_moe=tuple(moe[n_layers - rem:]),
    )


def layer_kinds(plan: StackPlan) -> List[tuple]:
    """(kind, use_moe) of every layer, in the stack's order."""
    return (list(zip(plan.prefix_kinds, plan.prefix_moe))
            + list(zip(plan.period_kinds, plan.period_moe)) * plan.n_periods
            + list(zip(plan.suffix_kinds, plan.suffix_moe)))


def stack_init(gen: torch.Generator, cfg, plan: StackPlan, *,
               cross: bool = False, dtype) -> nn.ModuleList:
    return nn.ModuleList(
        B.block_init(gen, cfg, kind, use_moe=moe, cross=cross, dtype=dtype)
        for kind, moe in layer_kinds(plan))


def stack_apply_train(layers, cfg, plan: StackPlan, x: torch.Tensor,
                      positions: torch.Tensor, *, causal: bool = True,
                      memory: torch.Tensor | None = None, remat: bool = True,
                      q_chunk: int = 512, k_chunk: int = 512):
    """Full-sequence forward.  Returns (x, summed auxiliary loss).  With
    ``remat`` each period's layers are recomputed in the backward; the
    prefix and suffix layers are not, as in the reference.  ``remat``
    changes no value: the auxiliary losses are summed per period either
    way."""
    kinds = [kind for kind, _ in layer_kinds(plan)]

    def run(lo: int, hi: int, x: torch.Tensor):
        aux = x.new_zeros((), dtype=torch.float32)
        for i in range(lo, hi):
            x, a = B.block_apply_train(layers[i], cfg, kinds[i], x,
                                       positions, causal=causal,
                                       memory=memory, q_chunk=q_chunk,
                                       k_chunk=k_chunk)
            aux = aux + a
        return x, aux

    n_pre, k = len(plan.prefix_kinds), len(plan.period_kinds)
    spans = ([(i, i + 1, False) for i in range(n_pre)]
             + [(n_pre + j * k, n_pre + (j + 1) * k, remat)
                for j in range(plan.n_periods)]
             + [(i, i + 1, False)
                for i in range(n_pre + plan.n_periods * k, len(kinds))])
    aux_total = x.new_zeros((), dtype=torch.float32)
    for lo, hi, rematerialise in spans:
        if rematerialise:
            x, aux = checkpoint(run, lo, hi, x, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = run(lo, hi, x)
        aux_total = aux_total + aux
    return x, aux_total


def stack_apply_prefill(layers, cfg, plan: StackPlan, x: torch.Tensor,
                        positions: torch.Tensor, *, max_len: int,
                        memory: torch.Tensor | None = None, cache_dtype,
                        q_chunk: int = 512, k_chunk: int = 512):
    """Forward over the prompt, building the decode caches.  Returns (x,
    list of per-layer caches)."""
    cache = []
    for p, (kind, _) in zip(layers, layer_kinds(plan)):
        x, c = _block_prefill(p, cfg, kind, x, positions, max_len=max_len,
                              memory=memory, cache_dtype=cache_dtype,
                              q_chunk=q_chunk, k_chunk=k_chunk)
        cache.append(c)
    return x, cache


def _block_prefill(p, cfg, kind: str, x: torch.Tensor,
                   positions: torch.Tensor, *, max_len: int, memory,
                   cache_dtype, q_chunk: int, k_chunk: int):
    """One block over the prompt and its decode cache: the recurrent
    kinds' final state (conv tail cast to ``cache_dtype``, h float32),
    or the attention ring buffer (plus the cross-attention keys and
    values of ``memory``)."""
    if kind == "mamba":
        h, st = SSM.mamba_apply_train(p["mamba"], cfg,
                                      C.rmsnorm(p["ln"], x, cfg.norm_eps))
        return x + h, {"conv": st["conv"].to(cache_dtype), "h": st["h"]}
    h = C.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "recurrent":
        h, st = RG.rglru_apply_train(p["rec"], cfg, h)
        c = {"conv": st["conv"].to(cache_dtype), "h": st["h"]}
        x = x + h
    else:
        h, (k, v) = A.attn_apply_train(p["attn"], cfg, h, positions,
                                       is_local=(kind == "local"),
                                       causal=True, q_chunk=q_chunk,
                                       k_chunk=k_chunk)
        c = A.cache_from_prefill(cfg, k.to(cache_dtype), v.to(cache_dtype),
                                 is_local=(kind == "local"), max_len=max_len)
        if B.parallel(p, cfg, kind):
            h2, _ = B._mix_ffn(p, cfg, C.rmsnorm(p["ln2"], x, cfg.norm_eps))
            return x + h + h2, c
        x = x + h
        if "xattn" in p and memory is not None:
            xk, xv = B.cross_project(p, cfg, memory)
            x = B.cross_attend(p, cfg, x, xk, xv, q_chunk=q_chunk,
                               k_chunk=k_chunk)
            c = {"self": c, "xk": xk.to(cache_dtype),
                 "xv": xv.to(cache_dtype)}
    h2, _ = B._mix_ffn(p, cfg, C.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h2, c


def stack_apply_decode(layers, cfg, plan: StackPlan, x: torch.Tensor,
                       cache: list, pos: torch.Tensor):
    """One decode step through the stack; each layer's cache is updated
    in place.  Returns (x, cache)."""
    for p, c, (kind, _) in zip(layers, cache, layer_kinds(plan)):
        x, _ = B.block_apply_decode(p, cfg, kind, x, c, pos)
    return x, cache


def stack_cache_init(cfg, plan: StackPlan, batch: int, max_len: int, *,
                     cross: bool = False, dtype, device=None) -> list:
    return [B.block_cache_init(cfg, kind, batch, max_len, cross=cross,
                               dtype=dtype, device=device)
            for kind, _ in layer_kinds(plan)]


def stack_cache_specs(cfg, plan: StackPlan, *, cross: bool = False) -> list:
    """Logical specs of :func:`stack_cache_init`'s caches, one per
    layer (the reference's per period position, without the stacked
    layer axis)."""
    return [B.block_cache_specs(cfg, kind, cross=cross)
            for kind, _ in layer_kinds(plan)]


# --------------------------------------------------------------------------
# Loss head
# --------------------------------------------------------------------------
def _pick_chunk(t: int, target: int) -> int:
    """Largest divisor of t that is <= target."""
    for c in range(min(target, t), 0, -1):
        if t % c == 0:
            return c
    return 1


def _xent_chunk(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                vocab: int | None):
    """(sum of the masked nll, count of scored labels) of one chunk: x
    (B, c, D), w (V_pad, D) float32, labels (B, c), -1 masked."""
    logits = torch.einsum("bcd,vd->bcv", x.float(), w)
    if vocab and vocab < w.shape[0]:      # mask the padded vocab tail
        pad = torch.arange(w.shape[0], device=w.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_xent(x: torch.Tensor, embed_w: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512,
                 vocab: int | None = None) -> torch.Tensor:
    """Mean cross-entropy without holding the full logits.

    x: (B, T, D) final hiddens of the scored positions; labels: (B, T)
    integer, -1 masked; embed_w: (V_pad, D), cast to float32 once;
    ``vocab`` masks the padded tail to -1e30.  T is cut into chunks of
    the largest divisor of T up to ``chunk``; each chunk's logits are
    recomputed in the backward (``torch.utils.checkpoint``), so at most
    one chunk's (B, chunk, V_pad) float32 logits are held.  The chunk
    sums are added in order, as the reference's scan adds them."""
    b, t, _ = x.shape
    chunk = _pick_chunk(t, chunk)
    if is_dtensor(x):
        return _chunked_xent_sharded(x, embed_w, labels, chunk, vocab)
    w = embed_w.float()
    labels = labels.long()
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for lo in range(0, t, chunk):
        s, c = checkpoint(_xent_chunk, x[:, lo:lo + chunk], w,
                          labels[:, lo:lo + chunk], vocab,
                          use_reentrant=False, preserve_rng_state=False)
        tot = tot + s
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def _chunked_xent_sharded(x, embed_w, labels, chunk: int,
                          vocab: int | None):
    """:func:`chunked_xent` over DTensors: x and labels batch-sharded,
    the table vocab-sharded (``("model", None)``).  Each chunk's logits
    stay on the rank that holds their vocab slice: the max, the sum of
    exponentials and the target logit are all-reduced over the model
    axis (``sharding.reduce_from``), so no rank holds a chunk's full
    (B, chunk, V_pad) logits.  Each rank's sums over its batch rows are
    partial over the data axes, reduced once at the end."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    w = embed_w.float()
    v_axes = split_axes(w.placements, mesh, 0)
    x_pl = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in x.placements]
    lab_pl = list(x_pl)
    w_pl = [Shard(0) if i in v_axes else Replicate()
            for i in range(mesh.ndim)]
    # gradients: x's is partial over the vocab axes, the table's over
    # the batch axes; the sums are partial over the batch axes
    x_grad = [Partial() if i in v_axes else pl for i, pl in enumerate(x_pl)]
    w_grad = [Partial() if isinstance(x_pl[i], Shard) else pl
              for i, pl in enumerate(w_pl)]
    sums = [Partial() if isinstance(pl, Shard) else Replicate()
            for pl in x_pl]
    v_pad = w.shape[0]
    v_lo = local_offset(mesh, w_pl, 0, v_pad)   # this rank's first row

    def body(xc, w_loc, lab):
        if not v_axes:      # the whole vocab here: the one-device chunk
            return _xent_chunk(xc, w_loc, lab, vocab)
        logits = torch.einsum("bcd,vd->bcv", xc.float(), w_loc)
        if vocab and vocab < v_pad:
            pad = torch.arange(v_lo, v_lo + w_loc.shape[0],
                               device=w_loc.device) >= vocab
            logits = logits.masked_fill(pad, -1e30)
        m = logits.amax(dim=-1)
        for i in v_axes:
            m = reduce_from(m, mesh, names[i], "max")
        se = torch.exp(logits - m.detach()[..., None]).sum(-1)
        rel = lab - v_lo
        mine = (rel >= 0) & (rel < w_loc.shape[0])
        gold = torch.gather(logits, -1, torch.clamp(rel, 0, max(
            w_loc.shape[0] - 1, 0))[..., None])[..., 0]
        gold = torch.where(mine, gold, 0.0)
        for i in v_axes:
            se = reduce_from(se, mesh, names[i])
            gold = reduce_from(gold, mesh, names[i])
        lse = m.detach() + torch.log(se)
        mask = (lab >= 0).float()
        return ((lse - gold) * mask).sum(), mask.sum()

    labels = labels.long()
    tot = cnt = None
    for lo in range(0, x.shape[1], chunk):
        def one(xc, lab, w_=w):
            return local_call(body, mesh, (xc, w_, lab),
                              (x_pl, w_pl, lab_pl), (x_grad, w_grad, None),
                              (sums, sums), out_shapes=((), ()))
        s, c = checkpoint(one, x[:, lo:lo + chunk], labels[:, lo:lo + chunk],
                          use_reentrant=False, preserve_rng_state=False)
        tot = s if tot is None else tot + s
        cnt = c if cnt is None else cnt + c
    rep = [Replicate()] * mesh.ndim
    tot, cnt = tot.redistribute(mesh, rep), cnt.redistribute(mesh, rep)
    return tot / torch.clamp(cnt, min=1.0)