"""The port's Mamba and RG-LRU layers (``repro_torch.models.ssm``,
``rglru``, ``scan_utils``) side by side with the reference's.

Same inputs, drawn from numpy seeds, through both packages on the CPU
in float32; the reference's params carried across with
``convert.param_tree`` / ``convert.model_params``.  Held: the chunked
scan and the causal conv within 1e-5 * max|ref| (the in-chunk scan
combines in another tree order than ``lax.associative_scan``);
each layer's prefill output and final state within 1e-5; the chunked
prefill against the same input streamed step by step within 1e-4 (the
reference's own ``test_*_train_matches_stepwise`` bound); whole-model
``prefill`` / ``decode_step`` logits within 1e-4 * max and caches
within 1e-5 for falcon-mamba-7b and recurrentgemma-2b (smoke).
"""
import numpy as np
import pytest
import torch

import repro_torch.configs as TCFG
from repro_torch import convert
from repro_torch.models import rglru as TR
from repro_torch.models import scan_utils as TS
from repro_torch.models import ssm as TM

from test_torch_models import _close, carry, check_prefill_and_decode

F32_TOL = 1e-5          # relative to max|ref|
STEP_TOL = 1e-4         # chunked prefill vs stepwise decode


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs
    return jax, jnp, configs


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("s,chunk", [(16, 1), (16, 4), (16, 16), (16, 0),
                                     (12, 5), (1, 0)])
@pytest.mark.parametrize("rest", [(6,), (3, 5)])
def test_chunked_linear_scan_matches(s, chunk, rest):
    jax, jnp, _ = _jax()
    from repro.models import scan_utils as JS
    rng = np.random.default_rng(s * 10 + chunk)
    a = rng.uniform(0.5, 1.0, (2, s, *rest)).astype(np.float32)
    b = rng.standard_normal((2, s, *rest)).astype(np.float32)
    h0 = rng.standard_normal((2, *rest)).astype(np.float32)
    want_all, want_last = JS.chunked_linear_scan(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), chunk=chunk)
    got_all, got_last = TS.chunked_linear_scan(_t(a), _t(b), _t(h0),
                                               chunk=chunk)
    _close(got_all.numpy(), want_all, F32_TOL, "h_all")
    _close(got_last.numpy(), want_last, F32_TOL, "h_last")


def test_pick_chunk_is_the_reference_rule():
    for s, chunk, want in [(16, 0, 16), (4096, 0, 1024), (3000, 0, 1000),
                           (12, 5, 4), (7, 4, 1), (16, 1, 1), (1, 0, 1)]:
        assert TS.pick_chunk(s, chunk) == want


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("width", [1, 4])
def test_causal_conv1d_matches(with_state, width):
    jax, jnp, _ = _jax()
    from repro.models import scan_utils as JS
    rng = np.random.default_rng(width)
    x = rng.standard_normal((2, 7, 5)).astype(np.float32)
    w = rng.standard_normal((width, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    st = (rng.standard_normal((2, width - 1, 5)).astype(np.float32)
          if with_state else None)
    want_y, want_st = JS.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        None if st is None else jnp.asarray(st))
    got_y, got_st = TS.causal_conv1d(_t(x), _t(w), _t(bias),
                                     None if st is None else _t(st))
    _close(got_y.numpy(), want_y, F32_TOL, "y")
    assert got_st.shape == want_st.shape
    if width > 1:
        _close(got_st.numpy(), want_st, F32_TOL, "state")


LAYERS = {
    "mamba": ("falcon-mamba-7b", "mamba_init", "mamba_apply_train",
              "mamba_apply_decode", "mamba_cache_init", TM),
    "rglru": ("recurrentgemma-2b", "rglru_init", "rglru_apply_train",
              "rglru_apply_decode", "rglru_cache_init", TR),
}


@pytest.fixture(scope="module", params=sorted(LAYERS))
def layer(request):
    """(name, cfg, reference module and params, port module and params)
    of one recurrent layer kind, random gates so every term is live."""
    jax, jnp, configs = _jax()
    import importlib
    arch, init, *_, port = LAYERS[request.param]
    ref = importlib.import_module(
        f"repro.models.{'ssm' if request.param == 'mamba' else 'rglru'}")
    cfg = configs.smoke(arch)
    jp, _ = getattr(ref, init)(jax.random.PRNGKey(0), cfg, jnp.float32)
    jp = jax.device_get(jp)
    rng = np.random.default_rng(4)
    for k in ("w_a", "b_a", "w_x", "b_x", "conv_b"):   # zeros at init
        if k in jp:
            jp[k] = rng.standard_normal(jp[k].shape).astype(np.float32)
    tp = convert.param_tree(jp, torch.device("cpu"))
    return request.param, cfg, ref, jp, port, tp


def _fns(name, mod):
    _, _, train, decode, cache_init, _ = LAYERS[name]
    return getattr(mod, train), getattr(mod, decode), getattr(mod, cache_init)


@pytest.mark.parametrize("chunk", [4, None])
def test_layer_prefill_matches_reference(layer, chunk):
    jax, jnp, _ = _jax()
    name, cfg, ref, jp, port, tp = layer
    x = np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    want, want_st = _fns(name, ref)[0](jp, cfg, jnp.asarray(x), chunk)
    got, got_st = _fns(name, port)[0](tp, cfg, _t(x), chunk)
    _close(got.numpy(), want, F32_TOL, f"{name} out")
    for k in ("conv", "h"):
        assert got_st[k].dtype == torch.float32
        _close(got_st[k].numpy(), want_st[k], F32_TOL, f"{name} {k}")


def test_layer_decode_matches_reference(layer):
    jax, jnp, _ = _jax()
    name, cfg, ref, jp, port, tp = layer
    _, jdec, jinit = _fns(name, ref)
    _, tdec, tinit = _fns(name, port)
    x = np.random.default_rng(6).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    jc = jinit(cfg, 2, jnp.float32)
    tc = tinit(cfg, 2, torch.float32)
    for t in range(x.shape[1]):
        want, jc = jdec(jp, cfg, jnp.asarray(x[:, t:t + 1]), jc)
        got, tc2 = tdec(tp, cfg, _t(x[:, t:t + 1]), tc)
        assert tc2 is tc
        _close(got.numpy(), want, F32_TOL, f"{name} step {t}")
        for k in ("conv", "h"):
            _close(tc[k].numpy(), jc[k], F32_TOL, f"{name} {k} step {t}")


def test_train_matches_stepwise(layer):
    """The port's counterpart of the reference's
    ``test_mamba_train_matches_stepwise`` / ``test_rglru_train_matches_
    stepwise``: the chunked scan (chunk 4) against decode steps."""
    name, cfg, _, _, port, tp = layer
    train, dec, init = _fns(name, port)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    y_train, st = train(tp, cfg, x, 4)
    cache = init(cfg, 2, torch.float32)
    y_step = torch.cat([dec(tp, cfg, x[:, t:t + 1], cache)[0]
                        for t in range(16)], dim=1)
    np.testing.assert_allclose(y_train.numpy(), y_step.numpy(),
                               atol=STEP_TOL, rtol=1e-3)
    for k in ("conv", "h"):
        np.testing.assert_allclose(st[k].numpy(), cache[k].numpy(),
                                   atol=STEP_TOL, rtol=1e-3)


def test_decode_writes_through_a_slot_view(layer):
    """A decode step on a batch-1 view of a cache's row updates that row
    of the cache, and no other (the engine's slot view)."""
    name, cfg, _, _, port, tp = layer
    _, dec, init = _fns(name, port)
    cache = init(cfg, 3, torch.float32)
    view = {k: v[1:2] for k, v in cache.items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 1, cfg.d_model)).astype(np.float32))
    for _ in range(2):
        dec(tp, cfg, x, view)
    alone = init(cfg, 1, torch.float32)
    for _ in range(2):
        dec(tp, cfg, x, alone)
    for k in ("conv", "h"):
        assert torch.equal(cache[k][1:2], alone[k])
        assert not bool(cache[k][0].any()) and not bool(cache[k][2].any())
        assert bool(cache[k][1].any())


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_prefill_and_decode_match_reference(arch):
    _, _, configs = _jax()
    cfg = configs.smoke(arch)
    check_prefill_and_decode(cfg, *carry(cfg))


def test_published_widths():
    f = TCFG.get("falcon-mamba-7b")
    assert (f.n_layers, f.d_model, f.d_inner, f.ssm_state, f.dt_rank,
            f.conv_width, f.vocab) == (64, 4096, 8192, 16, 256, 4, 65024)
    r = TCFG.get("recurrentgemma-2b")
    assert (r.n_layers, r.d_model, r.layer_pattern, r.window, r.vocab) == \
        (26, 2560, ("recurrent", "recurrent", "local"), 2048, 256_000)
