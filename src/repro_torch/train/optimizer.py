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

ZeRO-1.  On a sharded model (DTensor params) the state takes the
placements ``init`` is given (``train.step.train_state_shardings``:
:func:`zero1_specs`, the params' tensor-parallel spec plus the data
axes on the largest dimension still free).  ``update`` redistributes
each gradient to its state's placements -- a reduce-scatter of the
partial sums over the data axes -- takes the global norm over those
shards (so it equals the one-device norm), updates each rank's shard of
m, v and master, casts the new master to the param's dtype and
redistributes it to the param's placements (the all-gather).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import torch

from repro_torch.models.sharding import is_dtensor, logical_to_pspec

__all__ = ["AdamW", "AdamWState", "trainable", "global_norm", "zero1_axis",
           "mesh_shape", "zero1_specs"]


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

    def init(self, params, shardings: AdamWState | None = None
             ) -> AdamWState:
        """Zero moments and float32 masters for every floating parameter
        of ``params``, whose ``requires_grad`` this switches on.  For
        DTensor params, ``shardings`` (an ``AdamWState`` of placements,
        ``train.step.train_state_shardings``) lays out m, v and master;
        without it they take their param's placements."""
        named = trainable(params)
        if not named:
            raise ValueError("no floating parameter to train")

        def master_of(n, p):
            p = p.detach()
            if is_dtensor(p) and shardings is not None:
                p = p.redistribute(p.device_mesh, shardings.master[n])
            return p.to(torch.float32, copy=True)

        with torch.no_grad():
            master = {n: master_of(n, p) for n, p in named.items()}
        for p in named.values():
            p.requires_grad_(True)
        w0 = next(iter(named.values()))
        dev = w0.to_local().device if is_dtensor(w0) else w0.device
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
        # each gradient on its state's layout (ZeRO-1: reduce-scattered)
        gs = {n: _like_state(grads.get(n), w)
              for n, w in state.master.items()}
        gnorm = global_norm(g for g in gs.values() if g is not None)
        if is_dtensor(gnorm):
            gnorm = gnorm.full_tensor()
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        step = state.step + 1
        lr = self.lr_fn(step)
        s = step.float()
        b1c = 1 - torch.pow(self.b1, s)
        b2c = 1 - torch.pow(self.b2, s)
        for n, w_ in state.master.items():
            w, m, v = _local(w_), _local(state.m[n]), _local(state.v[n])
            g = gs[n]
            g = (torch.zeros_like(w) if g is None else _local(g).float()) \
                * scale
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(self.eps))
            upd.add_(w, alpha=self.weight_decay).mul_(lr)
            w.sub_(upd)
            p = named[n]
            if is_dtensor(p):       # cast, then all-gather to the param
                _local(p).copy_(_local(w_.to(p.dtype).redistribute(
                    p.device_mesh, p.placements)))
            else:
                p.copy_(w)
        return params, state._replace(step=step), {"grad_norm": gnorm,
                                                   "lr": lr}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    if isinstance(tensors, Mapping):
        tensors = tensors.values()
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage), or ``t``."""
    return t.to_local() if is_dtensor(t) else t


def _like_state(g, w):
    """Gradient ``g`` on master ``w``'s placements (None stays)."""
    if g is None or not is_dtensor(w):
        return g
    if tuple(g.placements) == tuple(w.placements):
        return g
    return g.redistribute(w.device_mesh, w.placements)


# ----------------------------------------------------------------- ZeRO-1
def zero1_axis(shape, pspec_axes, mesh_axes_free, mesh_shape) -> tuple:
    """Pick the largest dim of ``shape`` not already sharded and assign the
    free (data[, pod]) axes to it if divisible; returns new axes tuple."""
    axes = list(pspec_axes) + [None] * (len(shape) - len(pspec_axes))
    free = [a for a in mesh_axes_free]
    if not free:
        return tuple(axes)
    needed = 1
    for a in free:
        needed *= mesh_shape[a]
    # largest unsharded, divisible dim
    cands = sorted(
        (i for i in range(len(shape)) if axes[i] is None
         and shape[i] % needed == 0 and shape[i] >= needed),
        key=lambda i: -shape[i])
    if not cands:
        return tuple(axes)
    i = cands[0]
    axes[i] = tuple(free)
    return tuple(axes)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (a mapping passes through)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def zero1_specs(param_specs: Mapping, param_shapes: Mapping, mesh,
                data_axes=("data",)) -> dict:
    """The optimizer state's physical specs, by param name: the param's
    spec under the installed rules plus the data (and pod) axes on its
    largest replicated dimension.  ``param_shapes`` maps each name to a
    shape (or a tensor); ``mesh`` is a DeviceMesh or {axis: size}."""
    shape_of = dict(mesh_shape(mesh))
    out = {}
    for n, spec_axes in param_specs.items():
        shp = param_shapes[n]
        shp = tuple(shp.shape) if hasattr(shp, "shape") else tuple(shp)
        p = logical_to_pspec(spec_axes)
        phys = list(p) + [None] * (len(shp) - len(p))
        free = [a for a in data_axes if a in shape_of]
        out[n] = zero1_axis(shp, phys, free, shape_of)
    return out
