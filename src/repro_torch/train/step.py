"""The train step, and the layout of its state over a mesh.

Port of ``repro/train/step.py``.  ``make_train_step`` is one function
for one device and for a mesh: with DTensor params (from
:func:`init_sharded` or :func:`shard_params`) the batch is laid out
``Shard(0)`` over the data axes (:func:`place_batch`), the loss and its
backward run over DTensors, and ``AdamW.update`` reduce-scatters the
gradients onto the ZeRO-1 state and all-gathers the new params.

The reference's helpers become placements: :func:`specs_to_shardings`
maps a tree of logical specs to a tree of DTensor placements over a
mesh, :func:`train_state_shardings` gives the params' placements and
the optimizer state's (``zero1_specs``), and :func:`batch_shardings`
the batch's.  A sharded init never holds the whole model on one card:
each rank draws every full leaf in the one-device order from the same
generator, keeps its slice and frees the rest, so the sharded model is
the one-device model bit for bit and a rank's peak is its shard plus
the largest leaf.
"""
from __future__ import annotations

from typing import Mapping

from repro_torch.models import common as C
from repro_torch.models import sharding as S

from .optimizer import AdamW, AdamWState, trainable, zero1_specs

__all__ = ["make_train_step", "specs_to_shardings", "train_state_shardings",
           "batch_shardings", "init_sharded", "shard_params", "place_batch",
           "plain"]


def plain(t):
    """A replicated DTensor as a plain tensor on this rank (no
    communication for a replicated one); a plain tensor as it is."""
    return t.full_tensor() if S.is_dtensor(t) else t


def make_train_step(model, opt: AdamW, *, remat: bool = True,
                    q_chunk: int = 512, k_chunk: int = 512):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``model.loss`` (with ``remat``, ``q_chunk``,
    ``k_chunk``), its backward into the params' ``.grad``, then
    ``opt.update``, which writes the params in place; the grads are
    dropped after it.  ``opt_state`` comes from ``opt.init(params)``,
    which switched the params' ``requires_grad`` on.  ``metrics``:
    ``loss``, ``nll``, ``aux``, ``grad_norm`` and ``lr``, float32 scalars
    on the device; nothing is read back to the host.  With DTensor
    params the logical rules must be installed (``sharding.use_rules``):
    a plain batch is laid out by :func:`place_batch`, and the metrics
    come back as plain tensors on this rank."""
    def train_step(params, opt_state: AdamWState, batch):
        mesh = S.mesh_of(params)
        if mesh is not None:
            batch = place_batch(batch, mesh)
        loss, aux = model.loss(params, batch, remat=remat, q_chunk=q_chunk,
                               k_chunk=k_chunk)
        with S.sharded_region(params):
            loss.backward()
        named = trainable(params)
        grads = {n: named[n].grad for n in opt_state.master}
        params, opt_state, info = opt.update(grads, opt_state, params)
        for p in named.values():
            p.grad = None
        metrics = {"loss": plain(loss.detach()),
                   **{k: plain(v.detach()) for k, v in aux.items()}, **info}
        return params, opt_state, metrics
    return train_step


def _map_specs(fn, tree):
    """``fn`` over the leaves of a spec tree (a leaf is a tuple)."""
    if isinstance(tree, tuple):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def specs_to_shardings(spec_tree, mesh, rules: dict):
    """Logical-axes tuples -> a tree of DTensor placements over
    ``mesh``."""
    return _map_specs(lambda axes: S.placements(axes, mesh, rules),
                      spec_tree)


def train_state_shardings(model, mesh, rules: dict):
    """(param placements, ``AdamWState`` of placements) for ``mesh``, by
    param name: the params' logical specs under ``rules``, and m / v /
    master on ``zero1_specs`` over the mesh's data (and pod) axes."""
    pspecs = model.param_specs()
    pshapes = {n: p.shape for n, p in
               model.param_shapes().named_parameters()}
    param_sh = specs_to_shardings(pspecs, mesh, rules)
    data_axes = tuple(a for a in ("pod", "data")
                      if a in mesh.mesh_dim_names)
    with S.use_rules(rules):
        z1 = zero1_specs(pspecs, pshapes, mesh, data_axes=data_axes)
    state_sh = {n: S.pspec_placements(axes, mesh) for n, axes in z1.items()}
    scalar = S.pspec_placements((), mesh)
    return param_sh, AdamWState(step=scalar, m=state_sh, v=state_sh,
                                master=state_sh)


def batch_shardings(batch_specs, mesh, rules: dict):
    return specs_to_shardings(batch_specs, mesh, rules)


def init_sharded(model, generator, mesh, rules: dict):
    """``model.init(generator)`` with every param laid out on ``mesh`` by
    its logical spec under ``rules`` as soon as it is drawn: the
    one-device model's values, each rank holding its slices."""
    def placer(t, spec):
        return S.place(t, mesh, S.placements(spec, mesh, rules))
    with C.placing(placer):
        return model.init(generator)


def shard_params(params, mesh, rules: dict, specs: Mapping):
    """Lay out full params (the same on every rank; e.g. carried by
    ``convert.model_params``) on ``mesh`` by ``specs`` (name -> logical
    axes, ``Model.param_specs()``), in place; returns ``params``."""
    def placed(name, p):
        return S.place(p.detach(), mesh, S.placements(specs[name], mesh,
                                                      rules))
    C.replace_params(params, placed)
    for name, p in params.named_parameters():
        p.logical_axes = tuple(specs[name])
    return params


def place_batch(batch: Mapping, mesh, rules: dict | None = None) -> dict:
    """Each full batch leaf (the same on every rank) as a DTensor split
    over the batch axes (``("batch", None, ...)``) under ``rules``
    (default: the installed ones); DTensors stay."""
    rules = rules if rules is not None else S.get_rules()
    if rules is None:
        raise RuntimeError("laying out a batch needs the logical rules "
                           "(sharding.use_rules)")
    pls = batch_shardings({k: ("batch",) + (None,) * (v.dim() - 1)
                           for k, v in batch.items()}, mesh, rules)
    return {k: v if S.is_dtensor(v) else S.place(v, mesh, pls[k],
                                                   copy=False)
            for k, v in batch.items()}
