"""The port's cross-attention and modality frontends side by side with
the reference's: seamless-m4t-medium (an encoder over precomputed frame
embeddings, ``batch["enc_frames"]``, whose output the decoder
cross-attends) and llava-next-mistral-7b (precomputed patch embeddings,
``batch["frontend"]``, prepended to the text).

Same inputs, drawn from numpy seeds, through both packages on the CPU
in float32; the reference's params carried across with
``convert.param_tree`` / ``convert.model_params``.  Held: a
cross-attention block within 1e-5 * max; whole-model ``prefill`` /
``decode_step`` logits within 1e-4 * max and caches (the cross keys and
values included) within 1e-5; the port's prefill of S tokens plus one
decode step against its prefill of S + 1 in softmax within the
reference's own 5e-3 / 1e-2 (``tests/test_models_smoke.py``).
"""
import numpy as np
import pytest
import torch

import repro_torch.configs as TCFG
from repro_torch import convert
from repro_torch.models import blocks as TB
from repro_torch.models.api import build_model

from test_torch_models import (_close, _compare_caches, carry,
                               check_prefill_and_decode)

F32_TOL = 1e-5
CROSS = ["seamless-m4t-medium", "llava-next-mistral-7b"]


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs
    return jax, jnp, configs


def _inputs(cfg, b=2, seed=9):
    """The family's precomputed embeddings, and how many positions they
    take ahead of the text."""
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        return {"enc_frames": x}, 0
    return {"frontend": x}, cfg.frontend_seq


@pytest.fixture(scope="module", params=CROSS)
def carried(request):
    _, _, configs = _jax()
    cfg = configs.smoke(request.param)
    return (cfg, *carry(cfg))


def test_prefill_and_decode_match_reference(carried):
    cfg, jm, jp, tm, tp = carried
    inputs, n_front = _inputs(cfg)
    check_prefill_and_decode(cfg, jm, jp, tm, tp, inputs=inputs,
                             n_front=n_front)


def test_init_cache_matches_reference(carried):
    cfg, jm, _, tm, _ = carried
    _compare_caches(tm.init_cache(3, 40), jm.init_cache(3, 40), tm.plan,
                    "init_cache")


def test_encoder_params_carried_in_order(carried):
    cfg, _, jp, _, tp = carried
    if not cfg.is_encdec:
        assert "enc" not in tp
        return
    assert len(tp["enc"]) == cfg.enc_layers and "enc_ln" in tp
    want = np.asarray(jp["enc"]["periods"]["b0"]["attn"]["wq"]["w"])
    for i, blk in enumerate(tp["enc"]):
        np.testing.assert_array_equal(blk["attn"]["wq"]["w"].numpy(),
                                      want[i])
        assert "xattn" not in blk
    assert all("xattn" in blk for blk in tp["dec"])


def test_prefill_then_step_equals_longer_prefill(carried):
    """The port's counterpart of ``test_prefill_decode_consistency``."""
    cfg, _, _, tm, tp = carried
    inputs, n_front = _inputs(cfg)
    s = 12
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, s + 1))
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    max_len = n_front + s + 8
    cache, _ = tm.prefill(tp, {"tokens": toks[:, :s], **batch},
                          max_len=max_len, q_chunk=16, k_chunk=16)
    _, step = tm.decode_step(tp, cache, toks[:, s:], np.full(2, n_front + s,
                                                             np.int32))
    _, full = tm.prefill(tp, {"tokens": toks, **batch}, max_len=max_len + 1,
                         q_chunk=16, k_chunk=16)
    pa = torch.softmax(step[:, -1, :cfg.vocab], -1).numpy()
    pb = torch.softmax(full[:, -1, :cfg.vocab], -1).numpy()
    np.testing.assert_allclose(pa, pb, atol=5e-3, rtol=1e-2)


def test_other_frames_change_the_logits(carried):
    cfg, _, _, tm, tp = carried
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 8))
    outs = []
    for seed in (1, 2):
        inputs, n_front = _inputs(cfg, seed=seed)
        _, logits = tm.prefill(tp, {"tokens": toks, **inputs},
                               max_len=n_front + 16)
        outs.append(logits[..., :cfg.vocab])
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3 * float(
        outs[0].abs().max())


def test_cross_block_matches_reference():
    jax, jnp, configs = _jax()
    from repro.models import blocks as JB
    cfg = configs.smoke("seamless-m4t-medium")
    jp, _ = JB.block_init(jax.random.PRNGKey(5), cfg, "global",
                          use_moe=False, cross=True, dtype=jnp.float32)
    tp = convert.param_tree(jax.device_get(jp), torch.device("cpu"))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(24)[None, :]
    want, _ = JB.block_apply_train(jp, cfg, "global", jnp.asarray(x),
                                   jnp.asarray(pos), memory=jnp.asarray(mem),
                                   q_chunk=8, k_chunk=8)
    got, _ = TB.block_apply_train(tp, cfg, "global", torch.from_numpy(x),
                                  torch.from_numpy(pos),
                                  memory=torch.from_numpy(mem), q_chunk=8,
                                  k_chunk=8)
    _close(got.numpy(), want, F32_TOL, "cross block")


def test_published_widths():
    s = TCFG.get("seamless-m4t-medium")
    assert (s.enc_layers, s.n_layers, s.d_model, s.frontend_seq,
            s.vocab) == (12, 12, 1024, 1024, 256_206)
    v = TCFG.get("llava-next-mistral-7b")
    assert (v.n_layers, v.d_model, v.frontend_seq, v.vocab,
            v.frontend) == (32, 4096, 576, 32000, "vision")
    m = build_model(TCFG.smoke("seamless-m4t-medium"), device="cpu")
    assert m.enc_plan is not None and m.enc_plan.period_kinds == ("global",)
