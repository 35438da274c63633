"""AdamW with float32 master weights.

Port of ``repro/train/optimizer.py``: the reference's formula -- global
norm clipping, bias-corrected moments, decoupled weight decay applied to
the float32 master -- not ``torch.optim.AdamW``.  The state holds one
float32 ``m``, ``v`` and master per trained parameter, keyed by the
parameter's name in ``params.named_parameters()`` and in that order.
:meth:`AdamW.init` picks the trained parameters -- every floating one
-- and switches their ``requires_grad`` on (the model builds them off,
as serving wants).  :meth:`AdamW.update` writes ``m``, ``v``, the
master and each parameter (the master cast to its dtype) in place, and
reads nothing back to the host.

The reference's ZeRO-1 helpers (``zero1_axis``, ``zero1_specs``) shard
the state across a data axis; they come with the model across cards
(ROADMAP 1.28) and raise until then.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import torch

from repro_torch._todo import not_ported

__all__ = ["AdamW", "AdamWState", "trainable", "global_norm", "zero1_axis",
           "zero1_specs"]


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar on the params' device
    m: dict
    v: dict
    master: dict


def trainable(params) -> dict:
    """The floating parameters of ``params`` (a module), by name."""
    return {n: p for n, p in params.named_parameters()
            if p.is_floating_point()}


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr_fn: object                 # step tensor -> float32 lr tensor
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        """Zero moments and float32 masters for every floating parameter
        of ``params``, whose ``requires_grad`` this switches on."""
        named = trainable(params)
        if not named:
            raise ValueError("no floating parameter to train")
        with torch.no_grad():
            master = {n: p.detach().to(torch.float32, copy=True)
                      for n, p in named.items()}
        for p in named.values():
            p.requires_grad_(True)
        dev = next(iter(master.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={n: torch.zeros_like(w) for n, w in master.items()},
            v={n: torch.zeros_like(w) for n, w in master.items()},
            master=master)

    @torch.no_grad()
    def update(self, grads: Mapping, state: AdamWState, params):
        """One step from ``grads`` (name -> gradient, None read as zero)
        over the state's parameters.  Returns (params, the new state,
        {"grad_norm", "lr"}), the metrics float32 device scalars."""
        named = trainable(params)
        gnorm = global_norm(g for g in grads.values() if g is not None)
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        step = state.step + 1
        lr = self.lr_fn(step)
        s = step.float()
        b1c = 1 - torch.pow(self.b1, s)
        b2c = 1 - torch.pow(self.b2, s)
        for n, w in state.master.items():
            g = grads.get(n)
            g = (torch.zeros_like(w) if g is None else g.float()) * scale
            m, v = state.m[n], state.v[n]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(self.eps))
            upd.add_(w, alpha=self.weight_decay).mul_(lr)
            w.sub_(upd)
            named[n].copy_(w)
        return params, state._replace(step=step), {"grad_norm": gnorm,
                                                   "lr": lr}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    if isinstance(tensors, Mapping):
        tensors = tensors.values()
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def zero1_axis(*args, **kwargs):
    raise not_ported("train.optimizer.zero1_axis (ZeRO-1 state sharding)",
                     "multi_card")


def zero1_specs(*args, **kwargs):
    raise not_ported("train.optimizer.zero1_specs (ZeRO-1 state sharding)",
                     "multi_card")
