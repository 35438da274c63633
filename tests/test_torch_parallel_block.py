"""The parallel residual block (``cfg.parallel_block``, PaLM-style:
``x + attn(ln1 x) + ffn(ln2 x)``) against the reference, and the port's
deliberate difference (ROADMAP queue 3).

The reference honours the flag in its training forward
(``repro/models/blocks.py:70-79``) but not in its prefill
(``transformer._block_prefill``) nor in its decode step
(``blocks.block_apply_decode``), which both run the sequential block:
its serving and its training disagree on such a model.  The port
honours the flag in all three, so its prefill, its decode steps and
its loss are one model.  A JAX subprocess runs the reference on the
qwen2.5-14b smoke config (float32) with the flag on and off; the port
carries its params across (``convert.model_params``).
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs as TCFG
from repro_torch import convert
from repro_torch.models.api import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
S, B = 12, 2

_REF = textwrap.dedent("""
    import sys, pickle, dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from repro import configs
    from repro.models.api import build_model
    out_path = sys.argv[1]
    S, B = 12, 2
    base = dataclasses.replace(configs.smoke("qwen2.5-14b"),
                               param_dtype="float32",
                               activation_dtype="float32")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, base.vocab, (B, S + 1)).astype(np.int32)
    res = {}
    params = None
    for par in (True, False):
        m = build_model(dataclasses.replace(base, parallel_block=par))
        if params is None:
            params = m.init(jax.random.PRNGKey(0))
        loss, _ = m.loss(params, {"tokens": toks[:, :S],
                                  "labels": toks[:, 1:]},
                         q_chunk=4, k_chunk=4)
        _, pre = m.prefill(params, {"tokens": toks[:, :S]}, max_len=32,
                           q_chunk=4, k_chunk=4)
        c, _ = m.prefill(params, {"tokens": toks[:, :S - 1]}, max_len=32,
                         q_chunk=4, k_chunk=4)
        _, dec = m.decode_step(params, c, toks[:, S - 1:S],
                               jnp.full((B,), S - 1, jnp.int32))
        res[str(par)] = {"loss": float(loss),
                         "prefill": np.asarray(pre).tolist(),
                         "decode": np.asarray(dec).tolist()}
    with open(out_path, "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, params),
                     "toks": toks, "res": res}, f)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF, str(out)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _port(ref, par: bool):
    cfg = dataclasses.replace(TCFG.smoke("qwen2.5-14b"),
                              param_dtype="float32",
                              activation_dtype="float32",
                              parallel_block=par)
    model = build_model(cfg, device="cpu")
    return model, convert.model_params(ref["params"], cfg, "cpu")


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("par", [True, False])
def test_loss_matches_reference(ref, par):
    model, params = _port(ref, par)
    toks = ref["toks"]
    loss, _ = model.loss(params, {"tokens": toks[:, :S],
                                  "labels": toks[:, 1:]},
                         q_chunk=4, k_chunk=4)
    want = ref["res"][str(par)]["loss"]
    assert abs(float(loss) - want) <= TOL * abs(want)


def test_reference_prefill_and_decode_ignore_the_flag(ref):
    """The reference's serving runs the sequential block either way,
    while its loss changes with the flag."""
    on, off = ref["res"]["True"], ref["res"]["False"]
    assert np.array_equal(on["prefill"], off["prefill"])
    assert np.array_equal(on["decode"], off["decode"])
    assert abs(on["loss"] - off["loss"]) > 1e-4


def test_port_serving_is_its_training_model(ref):
    """The port's prefill with the flag differs from the sequential one
    (the reference's), its prefill of S - 1 tokens plus a decode step
    equals its prefill of S, and its last logits give its loss's nll at
    the last position."""
    model, params = _port(ref, True)
    seq_model, _ = _port(ref, False)
    toks = ref["toks"]
    _, pre = model.prefill(params, {"tokens": toks[:, :S]}, max_len=32,
                           q_chunk=4, k_chunk=4)
    _, pre_seq = seq_model.prefill(params, {"tokens": toks[:, :S]},
                                   max_len=32, q_chunk=4, k_chunk=4)
    _close(pre_seq, ref["res"]["False"]["prefill"], "sequential prefill")
    assert float((pre - pre_seq).abs().max()) > 1e-3
    c, _ = model.prefill(params, {"tokens": toks[:, :S - 1]}, max_len=32,
                         q_chunk=4, k_chunk=4)
    _, dec = model.decode_step(params, c, toks[:, S - 1:S],
                               np.full(B, S - 1, np.int32))
    _close(dec.numpy(), pre.numpy(), "prefill + decode vs longer prefill")
    # the loss with only the last label kept is the nll of those logits
    labels = np.full((B, S), -1, np.int64)
    labels[:, -1] = toks[:, S]
    nll, _ = model.loss(params, {"tokens": toks[:, :S], "labels": labels},
                        q_chunk=4, k_chunk=4)
    lp = torch.log_softmax(pre[:, -1].double(), -1)
    want = -lp[torch.arange(B), torch.as_tensor(toks[:, S])].mean()
    assert abs(float(nll) - float(want)) <= TOL * abs(float(want))


def test_reference_decode_differs_from_its_training_forward(ref):
    """On a parallel-block model the reference's decode step (after its
    prefill) does not give the logits its own training forward implies:
    the port's prefill, which is the port's training forward and equals
    the reference's loss, differs from the reference's decode."""
    model, params = _port(ref, True)
    toks = ref["toks"]
    _, pre = model.prefill(params, {"tokens": toks[:, :S]}, max_len=32,
                           q_chunk=4, k_chunk=4)
    dec_ref = np.asarray(ref["res"]["True"]["decode"])
    assert float(np.abs(pre.numpy() - dec_ref).max()) > 1e-3
