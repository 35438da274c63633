"""The port's configs and dense decoder models (``repro_torch.configs``,
``repro_torch.models``) side by side with the reference's.

Same inputs, drawn from numpy seeds, through both packages on the CPU;
the reference's params carried across with ``convert.model_params``.
Held: every config field and ``n_params`` equal; norms, RoPE,
activations, attention within float32 round-off (stated per test);
``prefill`` and ``decode_step`` logits within 1e-4 * max|logit| and the
caches' k / v within 1e-5 * max|k|, positions and insertion counters
equal, for the four dense smoke configs (2-6 layers, float32); every
one of the ten smoke configs builds, prefills and decodes on the CPU.
``carry`` and ``check_prefill_and_decode`` serve the other families'
parity tests too (``test_torch_moe.py``, ``test_torch_ssm.py``,
``test_torch_cross.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as TCFG
from repro_torch import convert
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.models.api import build_model

DENSE = ["minicpm-2b", "qwen2.5-14b", "starcoder2-15b", "gemma3-4b"]
LOGIT_TOL = 1e-4        # max|dlogit| <= LOGIT_TOL * max|logit_ref|
CACHE_TOL = 1e-5        # max|dk| <= CACHE_TOL * max|k_ref|
F32_TOL = 1e-5          # elementwise pieces, relative to max|ref|


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs
    return jax, jnp, configs


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_configs_equal_reference(arch):
    _, _, configs = _jax()
    for get in ("get", "smoke"):
        port, ref = getattr(TCFG, get)(arch), getattr(configs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()
        assert port.resolved_head_dim == ref.resolved_head_dim


def test_config_registry_equals_reference():
    _, _, configs = _jax()
    assert TCFG.ARCH_IDS == configs.ARCH_IDS
    assert TCFG.list_archs() == configs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in TCFG.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}


def test_qwen_full_size_is_the_published_one():
    cfg = TCFG.get("qwen2.5-14b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab) == \
        (48, 5120, 40, 8, 128, 13824, 152064)
    assert cfg.qkv_bias and not cfg.tie_embeddings
    assert cfg.param_dtype == "bfloat16"
    assert cfg.n_params() == 14_769_192_960     # 29.5 GB in bf16


# ------------------------------------------------------------ common pieces
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    jax, jnp, _ = _jax()
    from repro.models import common as JC
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32) * 3
    g = rng.standard_normal(24).astype(np.float32)
    want = JC.rmsnorm({"g": jnp.asarray(g, dtype)},
                      jnp.asarray(x, dtype), 1e-6)
    got = TC.rmsnorm({"g": torch.from_numpy(g).to(TC.dtype_of(dtype))},
                     torch.from_numpy(x).to(TC.dtype_of(dtype)), 1e-6)
    assert got.dtype == TC.dtype_of(dtype)
    # bf16: the same f32 normalisation, rounded once more (one ulp)
    _close(got.float().numpy(), np.asarray(want, np.float32),
           F32_TOL if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("decode", [False, True])
def test_rope_matches(theta, decode):
    jax, jnp, _ = _jax()
    from repro.models import common as JC
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1 if decode else 7, 3, 16)).astype(
        np.float32)
    pos = (np.array([[5], [40]]) if decode
           else np.arange(7)[None, :]).astype(np.int32)
    want = JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got.numpy(), want, F32_TOL, "rope")


@pytest.mark.parametrize("name", ["silu", "gelu", "geglu"])
def test_activations_match(name):
    jax, jnp, _ = _jax()
    from repro.models import common as JC
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    _close(TC.activation(name)(torch.from_numpy(x)).numpy(),
           JC.activation(name)(jnp.asarray(x)), 1e-6, name)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-3, 3, 61)
    exact = torch.nn.functional.gelu(x)
    assert not torch.allclose(TC.activation("gelu")(x), exact, atol=1e-5)


def test_padded_vocab_matches():
    _, _, _ = _jax()
    from repro.models import common as JC
    for v in (1, 127, 128, 500, 152_064, 122_753):
        assert TC.padded_vocab(v) == JC.padded_vocab(v)


# ---------------------------------------------------------------- attention
FLASH_CASES = [
    # (sq, sk, hq, hkv, causal, window, softcap, q_chunk, k_chunk, offset)
    (24, 24, 4, 2, True, None, 0.0, 16, 16, 0),
    (24, 24, 4, 4, True, None, 0.0, 5, 7, 0),
    (24, 24, 6, 2, True, 7, 0.0, 10, 16, 0),
    (24, 24, 4, 1, False, None, 0.0, 16, 5, 0),
    (24, 24, 4, 2, False, 5, 0.0, 8, 8, 0),
    (24, 24, 4, 2, True, None, 4.0, 16, 16, 0),
    (24, 24, 4, 2, True, 9, 3.0, 7, 5, 0),
    (8, 24, 4, 2, True, None, 0.0, 8, 16, 16),
    (6, 30, 4, 2, True, 10, 0.0, 4, 7, 24),
    (20, 20, 2, 2, True, 4, 0.0, 3, 3, 0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_matches(case):
    jax, jnp, _ = _jax()
    from repro.models import attention as JA
    sq, sk, hq, hkv, causal, window, cap, qc, kc, off = case
    rng = np.random.default_rng(sq * 100 + sk + hq)
    q = rng.standard_normal((2, sq, hq, 8)).astype(np.float32)
    k = rng.standard_normal((2, sk, hkv, 8)).astype(np.float32)
    v = rng.standard_normal((2, sk, hkv, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, k_chunk=kc,
              kv_offset=off, logit_softcap=cap)
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw)
    got = TA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    _close(got.numpy(), want, F32_TOL, "flash")


def test_block_pairs_match():
    _, _, _ = _jax()
    from repro.models import attention as JA
    for args in [(4, 4, 8, 8, True, None, 0), (3, 5, 8, 4, True, 6, 8),
                 (4, 4, 8, 8, False, 9, 0), (2, 6, 4, 4, True, None, 16)]:
        for a, b in zip(TA.block_pairs(*args), JA.block_pairs(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window,cap", [(None, 0.0), (5, 0.0), (None, 2.5),
                                        (3, 4.0)])
def test_decode_attention_matches(window, cap):
    jax, jnp, _ = _jax()
    from repro.models import attention as JA
    rng = np.random.default_rng(7)
    b, s, hq, hkv, d = 3, 16, 4, 2, 8
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    kvp = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    kvp[0, 9:] = -1                      # empty ring slots
    # a ring of 16 slots that wrapped: slot i holds the p in 20..35 with
    # p % 16 == i
    kvp[2] = np.where(kvp[2] < 4, kvp[2] + 32, kvp[2] + 16)
    pos = np.array([8, 15, 35], np.int32)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(kvp),
                               jnp.asarray(pos), window=window,
                               logit_softcap=cap)
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(kvp),
                              torch.from_numpy(pos), window=window,
                              logit_softcap=cap)
    _close(got.numpy(), want, F32_TOL, "decode attention")


# ------------------------------------------------------------ whole models
def _index(tree, i):
    """Entry ``i`` of a tree stacked over a leading layer axis."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _ref_layers(cache, plan):
    """The reference's decode cache as the port's per-layer list."""
    out = list(cache["prefix"])
    for i in range(plan.n_periods):
        out += [_index(cache["periods"][f"b{j}"], i)
                for j in range(len(plan.period_kinds))]
    return out + list(cache["suffix"])


def _compare_tree(port, ref, what):
    """A layer's cache, nested dicts included: ring positions and
    insertion counters equal, every other tensor (k / v, cross keys and
    values, conv tails, recurrent states) within CACHE_TOL * max|ref|;
    every dtype the reference's."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), (what, sorted(port), sorted(ref))
        for k in port:
            _compare_tree(port[k], ref[k], f"{what} {k}")
        return
    assert str(port.dtype).removeprefix("torch.") == \
        np.asarray(ref).dtype.name, what
    if what.endswith((" pos", " ins")):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                      err_msg=what)
    else:
        _close(port.float().numpy(), np.asarray(ref, np.float32), CACHE_TOL,
               what)


def _compare_caches(port, ref_tree, plan, what):
    ref = _ref_layers(ref_tree, plan)
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        _compare_tree(p, r, f"{what} layer {i}")


def _compare_logits(got, want, vocab, what):
    got, want = got.numpy(), np.asarray(want)
    _close(got[..., :vocab], want[..., :vocab], LOGIT_TOL, what)
    np.testing.assert_array_equal(got[..., vocab:], want[..., vocab:])


def _cfg(arch):
    _, _, configs = _jax()
    if arch == "qwen2.5-14b:vocab500":    # a padded vocab tail to mask
        return dataclasses.replace(configs.smoke("qwen2.5-14b"), vocab=500)
    return configs.smoke(arch)


@pytest.fixture(scope="module", params=DENSE + ["qwen2.5-14b:vocab500"])
def carried(request):
    """(cfg, reference model and params, port model and params)."""
    cfg = _cfg(request.param)
    return (cfg, *carry(cfg))


def check_prefill_and_decode(cfg, jm, jp, tm, tp, *, inputs=None,
                             n_front=0, steps=3, seed=11):
    """Prefill 20 tokens (with ``inputs``: frames or patches as numpy),
    then ``steps`` decode steps, through both packages: logits and every
    cache within tolerance after each call."""
    jax, jnp, _ = _jax()
    rng = np.random.default_rng(seed)
    b, s = 2, 20
    max_len = 32 + n_front
    inputs = inputs or {}
    toks = rng.integers(0, cfg.vocab, (b, s + steps)).astype(np.int32)
    jcache, jlog = jax.jit(lambda p, t, x: jm.prefill(
        p, {"tokens": t, **x}, max_len=max_len, q_chunk=16, k_chunk=16))(
        jp, jnp.asarray(toks[:, :s]),
        {k: jnp.asarray(v) for k, v in inputs.items()})
    tcache, tlog = tm.prefill(
        tp, {"tokens": torch.from_numpy(toks[:, :s]),
             **{k: torch.from_numpy(v) for k, v in inputs.items()}},
        max_len=max_len, q_chunk=16, k_chunk=16)
    _compare_logits(tlog, jlog, cfg.vocab, "prefill logits")
    _compare_caches(tcache, jcache, tm.plan, "prefill cache")
    jstep = jax.jit(jm.decode_step)
    for i in range(steps):
        pos = np.full(b, n_front + s + i, np.int32)
        tok = toks[:, s + i:s + i + 1]
        jcache, jlog = jstep(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tcache, tlog = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        _compare_logits(tlog, jlog, cfg.vocab, f"decode logits {i}")
        _compare_caches(tcache, jcache, tm.plan, f"decode cache {i}")


def carry(cfg, seed=3):
    """(reference model and params, port model and params carried
    across) for ``cfg``."""
    jax, _, _ = _jax()
    from repro.models.api import build_model as jbuild
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    tp = convert.model_params(jax.device_get(jp), cfg, device="cpu")
    return jm, jp, tm, tp


def test_prefill_and_decode_match_reference(carried):
    cfg, jm, jp, tm, tp = carried
    check_prefill_and_decode(cfg, jm, jp, tm, tp)


def test_init_cache_matches_reference(carried):
    cfg, jm, _, tm, _ = carried
    _compare_caches(tm.init_cache(3, 24), jm.init_cache(3, 24), tm.plan,
                    "init_cache")


@pytest.mark.parametrize("kind", ["global", "local"])
def test_block_apply_train_matches(kind):
    jax, jnp, configs = _jax()
    from repro.models import blocks as JB
    cfg = configs.smoke("gemma3-4b")
    jp, _ = JB.block_init(jax.random.PRNGKey(5), cfg, kind, use_moe=False,
                          cross=False, dtype=jnp.float32)
    tp = convert.param_tree(jax.device_get(jp), torch.device("cpu"))
    x = np.random.default_rng(2).standard_normal((2, 24, cfg.d_model))
    x = x.astype(np.float32)
    pos = np.arange(24)[None, :]
    want, _ = JB.block_apply_train(jp, cfg, kind, jnp.asarray(x),
                                   jnp.asarray(pos), q_chunk=16, k_chunk=16)
    got, aux = TB.block_apply_train(tp, cfg, kind, torch.from_numpy(x),
                                    torch.from_numpy(pos), q_chunk=16,
                                    k_chunk=16)
    _close(got.numpy(), want, F32_TOL, f"{kind} block")
    assert float(aux) == 0.0


def test_stack_order_matches_plan():
    """One module per layer in the reference's order: prefix, periods x
    period kinds, suffix (gemma3: five local, one global; deepseek: one
    dense layer, then MoE), for every config and an encoder's plan."""
    _, _, configs = _jax()
    from repro.models import transformer as JT
    for arch in TCFG.ARCH_IDS:
        for get in (TCFG.get, TCFG.smoke):
            cfg = get(arch)
            plan = TT.make_plan(cfg, cfg.n_layers)
            assert dataclasses.asdict(plan) == dataclasses.asdict(
                JT.make_plan(cfg, cfg.n_layers))
            assert [k for k, _ in TT.layer_kinds(plan)] == \
                [cfg.pattern_at(i) for i in range(cfg.n_layers)]
            if cfg.is_encdec:
                kw = dict(force_dense_pattern=True, moe_ok=False)
                assert dataclasses.asdict(
                    TT.make_plan(cfg, cfg.enc_layers, **kw)) == \
                    dataclasses.asdict(JT.make_plan(cfg, cfg.enc_layers,
                                                    **kw))


def test_random_init_shapes_and_counts():
    cfg = TCFG.smoke("gemma3-4b")
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    assert len(p["dec"]) == cfg.n_layers
    assert p["embed"]["w"].shape == (TC.padded_vocab(cfg.vocab), cfg.d_model)
    assert not any(t.requires_grad for t in p.parameters())
    again = m.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                 again.parameters()))


def test_bf16_params_keep_their_bits():
    jax, jnp, configs = _jax()
    from repro.models.api import build_model as jbuild
    cfg = dataclasses.replace(configs.smoke("qwen2.5-14b"),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    jp = jax.device_get(jbuild(cfg).init(jax.random.PRNGKey(0)))
    tp = convert.model_params(jp, cfg, device="cpu")
    want = np.asarray(jp["dec"]["periods"]["b0"]["attn"]["wq"]["w"][1])
    got = tp["dec"][1]["attn"]["wq"]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


# ------------------------------------------------------------ every family
@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_every_family_builds_on_cpu(arch):
    """Every config of the registry builds, prefills (with its frames or
    patches) and decodes on the CPU: finite logits of the padded vocab,
    the padded tail masked, one cache per layer."""
    cfg = TCFG.smoke(arch)
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    assert len(p["dec"]) == cfg.n_layers
    assert ("enc" in p) == cfg.is_encdec
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 6))}
    n_front = 0
    if cfg.is_encdec:
        batch["enc_frames"] = rng.standard_normal(
            (2, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["frontend"] = rng.standard_normal(
            (2, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
        n_front = cfg.frontend_seq
    cache, logits = m.prefill(p, batch, max_len=32 + n_front)
    assert len(cache) == cfg.n_layers
    cache, step = m.decode_step(p, cache, np.zeros((2, 1), np.int32),
                                np.full(2, 6 + n_front, np.int32))
    v_pad = TC.padded_vocab(cfg.vocab)
    for out in (logits, step):
        assert out.shape == (2, 1, v_pad) and out.dtype == torch.float32
        assert bool(torch.isfinite(out[..., :cfg.vocab]).all())
        assert bool((out[..., cfg.vocab:] == -1e30).all())


def test_unported_pieces_raise_naming_their_item():
    """Training (1.27) and the model across cards (1.28) are ported:
    ``Model.loss`` runs, a parallel-block config builds and serves, and
    no ROADMAP item is left to raise under."""
    cfg = TCFG.smoke("qwen2.5-14b")
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    loss, aux = m.loss(p, {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                       q_chunk=4, k_chunk=4)
    assert bool(torch.isfinite(loss)) and sorted(aux) == ["aux", "nll"]
    pm = build_model(dataclasses.replace(cfg, parallel_block=True),
                     device="cpu")
    _, logits = pm.prefill(p, {"tokens": toks[:, :-1]}, max_len=16,
                           q_chunk=4, k_chunk=4)
    assert bool(torch.isfinite(logits).all())
    from repro_torch._todo import ROADMAP_ITEMS
    assert ROADMAP_ITEMS == {}


def test_model_refuses_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(TCFG.smoke("qwen2.5-14b"))
