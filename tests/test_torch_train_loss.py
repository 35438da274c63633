"""The port's training forward (``Model.loss``, ``chunked_xent``,
``stack_apply_train(remat=...)``) and its gradients, side by side with
the reference's on the CPU.

The dense smoke configs (float32; 2-6 layers) and qwen2.5-14b with a
padded vocab -- the other families in ``test_torch_train_loss_families.py``
through the same checks -- params carried across with
``convert.model_params``, one batch of 2 x 24 tokens (some labels -1),
q / k chunks of 8 and a loss chunk of 10 (which does not divide 24):
loss, nll and aux within LOSS_TOL relative; every parameter's gradient
within GRAD_TOL * max|g_ref| against ``jax.grad`` of the reference's
loss, the reference's gradient tree carried across the same way; in the
port, ``remat=True`` and ``remat=False`` equal bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as TCFG
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.train.optimizer import trainable

from test_torch_models import _close, carry

LOSS_TOL = 1e-5       # |loss - loss_ref| <= LOSS_TOL * |loss_ref|
GRAD_TOL = 1e-4       # max|g - g_ref| <= GRAD_TOL * max|g_ref|, per leaf
XENT_TOL = 1e-6       # chunked_xent, relative
B, S = 2, 24
KW = dict(q_chunk=8, k_chunk=8, loss_chunk=10)
DENSE = ["minicpm-2b", "qwen2.5-14b", "starcoder2-15b", "gemma3-4b",
         "qwen2.5-14b:vocab500"]


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs
    return jax, jnp, configs


def _cfg(arch):
    _, _, configs = _jax()
    if arch == "qwen2.5-14b:vocab500":      # a padded vocab tail to mask
        return dataclasses.replace(configs.smoke("qwen2.5-14b"), vocab=500)
    return configs.smoke(arch)


def train_batch(cfg, seed=5, b=B, s=S):
    """tokens and labels (a few -1), with frames or patches: numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.is_encdec:
        batch["enc_frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["frontend"] = rng.standard_normal(
            (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return batch


def port_loss_and_grads(tm, tp, batch, **kw):
    """(loss, {"nll", "aux"}, name -> grad) of the port."""
    named = trainable(tp)
    for p in named.values():
        p.requires_grad_(True)
        p.grad = None
    loss, aux = tm.loss(tp, {k: torch.from_numpy(v) for k, v in
                             batch.items()}, **kw)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in named.items()}
    for p in named.values():
        p.grad = None
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def reference_and_port(arch):
    """cfg, the port's model and params, the batch, and the reference's
    loss, aux and gradients carried into the port's names."""
    jax, jnp, _ = _jax()
    cfg = _cfg(arch)
    jm, jp, tm, tp = carry(cfg)
    batch = train_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, remat=True, **KW), has_aux=True))(jp)
    g = dict(convert.model_params(jax.device_get(jg), cfg,
                                  device="cpu").named_parameters())
    ref = {"loss": float(jl), "nll": float(jaux["nll"]),
           "aux": float(jaux["aux"]), "grads": g}
    return cfg, tm, tp, batch, ref


def check_loss(both):
    cfg, tm, tp, batch, ref = both
    loss, aux, _ = port_loss_and_grads(tm, tp, batch, **KW)
    assert loss.dtype == torch.float32 and loss.shape == ()
    for got, want, what in ((float(loss), ref["loss"], "loss"),
                            (float(aux["nll"]), ref["nll"], "nll"),
                            (float(aux["aux"]), ref["aux"], "aux")):
        assert abs(got - want) <= LOSS_TOL * max(abs(want), 1e-30), \
            (cfg.name, what, got, want)
    assert (cfg.n_experts > 0) == (ref["aux"] > 0)


def check_grads(both):
    cfg, tm, tp, batch, ref = both
    _, _, grads = port_loss_and_grads(tm, tp, batch, **KW)
    assert sorted(grads) == sorted(ref["grads"])
    for n, g in grads.items():
        _close(g.numpy(), ref["grads"][n].detach().numpy(), GRAD_TOL,
               f"{cfg.name} grad {n}")


def check_remat(both):
    cfg, tm, tp, batch, _ = both
    on = port_loss_and_grads(tm, tp, batch, remat=True, **KW)
    off = port_loss_and_grads(tm, tp, batch, remat=False, **KW)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(on[1][k], off[1][k]) for k in on[1])
    assert all(torch.equal(on[2][n], off[2][n]) for n in on[2])


@pytest.fixture(scope="module", params=DENSE)
def both(request):
    return reference_and_port(request.param)


def test_loss_matches_reference(both):
    check_loss(both)


def test_grads_match_reference(both):
    check_grads(both)


def test_remat_changes_no_bit(both):
    check_remat(both)


@pytest.mark.parametrize("t,chunk,vocab,v_pad",
                         [(24, 10, 500, 512), (24, 512, 500, 512),
                          (21, 5, 384, 384), (7, 3, 130, 256)])
def test_chunked_xent_matches_reference(t, chunk, vocab, v_pad):
    """Padded vocab tails, -1 labels, chunks that do not divide T; the
    chunk picked is the reference's."""
    jax, jnp, _ = _jax()
    from repro.models import transformer as JT
    rng = np.random.default_rng(t + chunk)
    x = rng.standard_normal((3, t, 16)).astype(np.float32)
    w = (rng.standard_normal((v_pad, 16)) * 0.5).astype(np.float32)
    labels = rng.integers(0, vocab, (3, t)).astype(np.int32)
    labels[1, ::4] = -1
    assert TT._pick_chunk(t, chunk) == JT._pick_chunk(t, chunk)
    want = JT.chunked_xent(jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(labels), chunk=chunk, vocab=vocab)
    got = TT.chunked_xent(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(labels), chunk=chunk, vocab=vocab)
    assert abs(float(got) - float(want)) <= XENT_TOL * abs(float(want))


def test_chunked_xent_grad_matches_reference():
    jax, jnp, _ = _jax()
    from repro.models import transformer as JT
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 21, 16)).astype(np.float32)
    w = (rng.standard_normal((384, 16)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 300, (2, 21)).astype(np.int32)
    labels[0, 5:9] = -1
    gx, gw = jax.grad(lambda a, b: JT.chunked_xent(
        a, b, jnp.asarray(labels), chunk=5, vocab=300), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    TT.chunked_xent(tx, tw, torch.from_numpy(labels), chunk=5,
                    vocab=300).backward()
    _close(tx.grad.numpy(), gx, GRAD_TOL, "d/dx")
    _close(tw.grad.numpy(), gw, GRAD_TOL, "d/dw")
    assert float(tw.grad[300:].abs().max()) == 0.0   # the masked tail
    assert float(tx.grad[0, 5:9].abs().max()) == 0.0   # the masked labels


def test_chunked_xent_holds_one_chunk_of_logits():
    """The backward graph keeps no chunk's (B, chunk, V) logits: every
    tensor saved for the backward is smaller than one chunk's."""
    b, t, d, v, chunk = 2, 32, 8, 1024, 8
    x = torch.randn(b, t, d, requires_grad=True)
    w = torch.randn(v, d, requires_grad=True)
    labels = torch.randint(0, v, (b, t))
    saved = []

    def pack(tensor):
        saved.append(tensor.numel())
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = TT.chunked_xent(x, w, labels, chunk=chunk)
    assert max(saved) < b * chunk * v
    loss.backward()
    assert torch.isfinite(w.grad).all()


def test_loss_runs_without_grad_switched_on():
    """Serving's params (requires_grad off) still give a loss."""
    cfg = TCFG.smoke("minicpm-2b")
    from repro_torch.models.api import build_model
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    loss, aux = m.loss(p, train_batch(cfg), **KW)
    assert torch.isfinite(loss) and float(aux["aux"]) == 0.0
    assert not loss.requires_grad
