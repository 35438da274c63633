"""Logical-axis sharding rules, carried by DTensor over a DeviceMesh.

Port of ``repro/models/sharding.py``.  Params and activations are
annotated with LOGICAL axis names; the launcher installs a mapping to
the mesh's axes.  With no rules installed (one device, the tests of a
single model) every annotation is a no-op, as in the reference.

Logical axes:
  batch   -> ("pod", "data") on the multi-pod mesh, ("data",) single-pod
  model   -> ("model",)   tensor-parallel dim (heads / d_ff / vocab / experts)
  expert  -> ("model",)   expert-parallel dim for MoE stacks
  seq     -> None         (sequence kept unsharded)
  kvseq   -> None, or the data axes for a decode batch they do not divide
  None    -> replicated

Where the reference hands a ``PartitionSpec`` to GSPMD, the port turns
the same spec into DTensor placements (:func:`placements`): a mesh axis
named by a tensor dim's entry becomes ``Shard(dim)`` on that mesh dim,
every other mesh dim ``Replicate()``.  :func:`shard` is the counterpart
of ``with_sharding_constraint``: ``redistribute`` to the spec's
placements, which is where a row-parallel product's partial sums are
all-reduced.  :func:`place` lays a full tensor out by slicing this
rank's part (no communication: every rank holds the same full tensor),
and :func:`local_call` runs a body on local shards with the
collectives at its boundary, for bodies that a sharded dim makes
rank-local (attention over sharded heads, the experts, the vocab-
parallel loss).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch

__all__ = ["DEFAULT_SINGLE_POD", "DEFAULT_MULTI_POD", "rules_for",
           "set_rules", "get_rules", "use_rules", "logical_to_pspec",
           "pspec_placements", "placements", "is_dtensor", "mesh_of",
           "shard", "split_axes", "local_offset", "local_part", "place",
           "local_call", "reduce_from", "sharded_region", "lay_out_cache"]

_RULES: Optional[dict] = None

DEFAULT_SINGLE_POD = {
    "batch": ("data",),
    "model": ("model",),
    "expert": ("model",),
    "seq": None,
    "kvseq": None,
}

DEFAULT_MULTI_POD = {
    "batch": ("pod", "data"),
    "model": ("model",),
    "expert": ("model",),
    "seq": None,
    "kvseq": None,
}


def rules_for(shape_kind: str, global_batch: int, mesh_shape: dict) -> dict:
    """Logical -> mesh rules for a (shape, mesh) cell.  Context
    parallelism for a decode batch the data axes do not divide: the KV
    cache's sequence dim takes the data axes instead of the batch."""
    multi = "pod" in mesh_shape
    rules = dict(DEFAULT_MULTI_POD if multi else DEFAULT_SINGLE_POD)
    data_ways = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    if shape_kind == "decode" and global_batch % data_ways != 0:
        rules["batch"] = None
        rules["kvseq"] = ("pod", "data") if multi else ("data",)
    return rules


def set_rules(rules: Optional[dict]) -> None:
    global _RULES
    _RULES = rules


def get_rules() -> Optional[dict]:
    return _RULES


@contextlib.contextmanager
def use_rules(rules: Optional[dict]):
    global _RULES
    prev = _RULES
    _RULES = rules
    try:
        yield
    finally:
        _RULES = prev


def logical_to_pspec(axes: Sequence[Optional[str]],
                     rules: Optional[dict] = None) -> tuple:
    """The reference's PartitionSpec as a tuple: per dim a tuple of mesh
    axis names, or None.  No rules: the empty spec."""
    rules = rules if rules is not None else _RULES
    if rules is None:
        return ()
    out = []
    for a in axes:
        r = rules.get(a) if a else None
        out.append(tuple(r) if r else None)
    return tuple(out)


def pspec_placements(pspec: Sequence, mesh) -> list:
    """DTensor placements of a PartitionSpec (tuple per dim of mesh-axis
    names, a bare name, or None) over ``mesh``.  A dim over several mesh
    axes is split over them in mesh order, as GSPMD splits it."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) if a in names else None for a in axes]
        if None in idx:
            raise ValueError(f"spec {tuple(pspec)} names a mesh axis not in "
                             f"the mesh {tuple(names)}")
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(pspec)}: mesh axes out of mesh "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {tuple(pspec)} uses mesh axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(dim)
    return out


def placements(axes: Sequence[Optional[str]], mesh,
               rules: Optional[dict] = None) -> list:
    """DTensor placements of a logical spec under ``rules`` (default:
    the installed ones)."""
    return pspec_placements(logical_to_pspec(axes, rules), mesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_of(tree) -> object:
    """The device mesh of the first DTensor among ``tree``'s params (a
    module) or values, or None."""
    it = tree.parameters() if hasattr(tree, "parameters") else tree
    for t in it:
        if is_dtensor(t):
            return t.device_mesh
    return None


def shard(x, *axes: Optional[str]):
    """Constrain an activation to the logical axes ``axes``: a no-op
    without rules or for a plain tensor, else ``x.redistribute`` to the
    spec's placements (Partial sums are all-reduced, Shard to Replicate
    all-gathered, Replicate to Shard sliced)."""
    if _RULES is None or not is_dtensor(x):
        return x
    want = placements(axes, x.device_mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def local_part(t: torch.Tensor, mesh, pls) -> torch.Tensor:
    """This rank's part of the full tensor ``t`` under placements
    ``pls`` (``torch.chunk`` splits, as DTensor's ``Shard`` splits)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            parts = torch.chunk(t, mesh.size(i), dim=p.dim)
            t = parts[coord[i]] if coord[i] < len(parts) \
                else t.narrow(p.dim, 0, 0)
    return t


def split_axes(pls, mesh, dim: int) -> list:
    """The mesh dims that split tensor dim ``dim`` under ``pls`` over
    more than one rank (a mesh dim of one rank splits nothing)."""
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(pls)
            if isinstance(p, Shard) and p.dim == dim and mesh.size(i) > 1]


def local_offset(mesh, pls, dim: int, size: int) -> int:
    """Global index of this rank's first element along tensor dim
    ``dim`` (of global ``size``) under placements ``pls``."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    lo = 0
    for i, p in enumerate(pls):
        if isinstance(p, Shard) and p.dim == dim:
            step = -(-size // mesh.size(i))
            lo += min(coord[i] * step, size)
            size = max(0, min(step, size - coord[i] * step))
    return lo


def place(t: torch.Tensor, mesh, pls, *, copy: bool = True):
    """A DTensor of the full tensor ``t`` (the same on every rank) laid
    out by ``pls``: this rank keeps its slice, with no communication;
    with ``copy`` the slice is copied so that ``t`` can be freed."""
    from torch.distributed.tensor import DTensor
    local = local_part(t, mesh, pls)
    if copy:
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def lay_out_cache(cache: list, specs: list, mesh) -> list:
    """Lay out a decode cache (a list of per-layer dicts of tensors or
    dicts, as ``Model.prefill`` returns it) by its logical specs
    (``Model.cache_specs()``) under the installed rules: each DTensor
    leaf redistributed, each plain one placed.  One layer at a time, in
    place of the list's entry, so that only one layer's old layout is
    alive beside the new one.  Returns ``cache``."""
    def laid(t, spec):
        if isinstance(t, dict):
            return {k: laid(v, spec[k]) for k, v in t.items()}
        pls = placements(spec, mesh)
        if not is_dtensor(t):
            return place(t, mesh, pls)
        return t if tuple(t.placements) == tuple(pls) \
            else t.redistribute(mesh, pls)
    for i, spec in enumerate(specs):
        cache[i] = laid(cache[i], spec)
    return cache


def local_call(fn: Callable, mesh, inputs: Sequence, in_placements: Sequence,
               grad_placements: Sequence, out_placements: Sequence,
               out_shapes: Sequence | None = None):
    """Run ``fn`` on local shards.  Each DTensor input is redistributed
    to its ``in_placements`` entry (None: as it is) and handed over as its
    local tensor, whose gradient goes back with ``grad_placements``'s
    layout (None: the forward's); a plain tensor counts as replicated
    (this rank's part of it is handed over), anything else passes.  ``fn``'s
    outputs (a tensor or a tuple) become DTensors over ``mesh`` with
    ``out_placements`` (global shapes ``out_shapes`` where a split is
    uneven)."""
    from torch.distributed.tensor import DTensor
    local = []
    for x, pl, gpl in zip(inputs, in_placements, grad_placements):
        if is_dtensor(x):
            if pl is not None and tuple(x.placements) != tuple(pl):
                x = x.redistribute(mesh, pl)
            x = x.to_local(grad_placements=gpl if gpl is not None
                           else x.placements)
        elif isinstance(x, torch.Tensor) and pl is not None:
            x = local_part(x, mesh, pl)     # a plain tensor is replicated
        local.append(x)
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    shapes = out_shapes or [None] * len(outs)
    res = tuple(
        o if pl is None else DTensor.from_local(
            o, mesh, pl, run_check=False, shape=shp,
            stride=_contiguous_stride(shp) if shp is not None else None)
        for o, pl, shp in zip(outs, out_placements, shapes))
    return res[0] if single else res


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _wait(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result, waited for (under a fake tensor
    mode it is a plain fake tensor)."""
    return t.wait() if hasattr(t, "wait") else t


class _ReduceFrom(torch.autograd.Function):
    """All-reduce in the forward, the identity in the backward: the sum
    over a mesh axis of parts whose downstream use is replicated there
    (Megatron's reduce-from-model-parallel region)."""

    @staticmethod
    def forward(ctx, x, group, op):
        import torch.distributed._functional_collectives as funcol
        return _wait(funcol.all_reduce(x, op, group))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_from(x: torch.Tensor, mesh, axis: str, op: str = "sum"):
    """All-reduce local ``x`` over mesh axis ``axis`` (``"sum"`` or
    ``"max"``; the max carries no gradient)."""
    import torch.distributed._functional_collectives as funcol
    group = mesh.get_group(axis)
    if op == "max":
        return _wait(funcol.all_reduce(x.detach(), "max", group))
    return _ReduceFrom.apply(x, group, "sum")


@contextlib.contextmanager
def sharded_region(params):
    """Inside a model entry point: when ``params`` are DTensors, plain
    tensors the model makes (positions, masks, zeros) count as
    replicated beside them."""
    if mesh_of(params) is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield
