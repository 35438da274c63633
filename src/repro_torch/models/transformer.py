"""The block stack: a plan of layer kinds, and the stack as one module
per layer.

Port of ``repro/models/transformer.py``.  :func:`make_plan` is the
reference's (a prefix of layers that break the pattern, then periods of
the layer pattern, then the remainder).  The reference stacks each
period position's params over periods and scans; here the stack is an
``nn.ModuleList`` of one block per layer in the reference's order --
prefix, then periods x period kinds, then suffix -- walked by a Python
loop, and the decode cache is a list of one ring-buffer dict per layer
in the same order.  ``chunked_xent`` (the loss) belongs to training
(ROADMAP 1.27).
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
from torch import nn

from . import attention as A
from . import blocks as B

__all__ = ["StackPlan", "make_plan", "layer_kinds", "stack_init",
           "stack_apply_prefill", "stack_apply_decode", "stack_cache_init"]


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
               dtype) -> nn.ModuleList:
    return nn.ModuleList(
        B.block_init(gen, cfg, kind, use_moe=moe, dtype=dtype)
        for kind, moe in layer_kinds(plan))


def stack_apply_prefill(layers, cfg, plan: StackPlan, x: torch.Tensor,
                        positions: torch.Tensor, *, max_len: int,
                        cache_dtype, q_chunk: int = 512, k_chunk: int = 512):
    """Forward over the prompt, building the decode caches.  Returns (x,
    list of per-layer caches)."""
    cache = []
    for p, (kind, _) in zip(layers, layer_kinds(plan)):
        x, _, (k, v) = B.block_forward(p, cfg, kind, x, positions,
                                       q_chunk=q_chunk, k_chunk=k_chunk)
        cache.append(A.attn_cache_from_prefill(
            cfg, k.to(cache_dtype), v.to(cache_dtype),
            is_local=(kind == "local"), max_len=max_len))
    return x, cache


def stack_apply_decode(layers, cfg, plan: StackPlan, x: torch.Tensor,
                       cache: list, pos: torch.Tensor):
    """One decode step through the stack; each layer's cache is updated
    in place.  Returns (x, cache)."""
    for p, c, (kind, _) in zip(layers, cache, layer_kinds(plan)):
        x, _ = B.block_apply_decode(p, cfg, kind, x, c, pos)
    return x, cache


def stack_cache_init(cfg, plan: StackPlan, batch: int, max_len: int, *,
                     dtype, device=None) -> list:
    return [B.block_cache_init(cfg, kind, batch, max_len, dtype=dtype,
                               device=device)
            for kind, _ in layer_kinds(plan)]
