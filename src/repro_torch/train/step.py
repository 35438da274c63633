"""The train step: loss, backward, AdamW.

Port of ``repro/train/step.py``'s ``make_train_step``.  The reference's
sharding helpers (``specs_to_shardings``, ``train_state_shardings``,
``batch_shardings``) lay the state over a mesh; they come with the model
across cards (ROADMAP 1.28) and raise until then.
"""
from __future__ import annotations

from repro_torch._todo import not_ported

from .optimizer import AdamW, AdamWState, trainable

__all__ = ["make_train_step", "specs_to_shardings", "train_state_shardings",
           "batch_shardings"]


def make_train_step(model, opt: AdamW, *, remat: bool = True,
                    q_chunk: int = 512, k_chunk: int = 512):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``model.loss`` (with ``remat``, ``q_chunk``,
    ``k_chunk``), its backward into the params' ``.grad``, then
    ``opt.update``, which writes the params in place; the grads are
    dropped after it.  ``opt_state`` comes from ``opt.init(params)``,
    which switched the params' ``requires_grad`` on.  ``metrics``:
    ``loss``, ``nll``, ``aux``, ``grad_norm`` and ``lr``, float32 scalars
    on the device; nothing is read back to the host."""
    def train_step(params, opt_state: AdamWState, batch):
        loss, aux = model.loss(params, batch, remat=remat, q_chunk=q_chunk,
                               k_chunk=k_chunk)
        loss.backward()
        named = trainable(params)
        grads = {n: named[n].grad for n in opt_state.master}
        params, opt_state, info = opt.update(grads, opt_state, params)
        for p in named.values():
            p.grad = None
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **info}
        return params, opt_state, metrics
    return train_step


def specs_to_shardings(*args, **kwargs):
    raise not_ported("train.step.specs_to_shardings", "multi_card")


def train_state_shardings(*args, **kwargs):
    raise not_ported("train.step.train_state_shardings", "multi_card")


def batch_shardings(*args, **kwargs):
    raise not_ported("train.step.batch_shardings", "multi_card")
