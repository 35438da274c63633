"""The port's mixture-of-experts layer (``repro_torch.models.moe``) side
by side with the reference's (``repro.models.moe``).

Same inputs, drawn from numpy seeds, through both packages on the CPU
in float32; the reference's params carried across with
``convert.param_tree`` / ``convert.model_params``.  Held, under the
sorted, the sharded (``moe_local_shards=4``) and the one-hot dispatch,
at a capacity factor that drops many assignments, at the published
1.25 and at one that drops none: the expert picks equal, y within 1e-5
* max|y|, the auxiliary loss within 1e-6; the sorted dispatch against a
float64 loop over tokens and their kept assignments; whole-model
``prefill`` / ``decode_step`` logits within 1e-4 * max and caches
within 1e-5 for deepseek-moe-16b and granite-moe-3b-a800m (smoke).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as TCFG
from repro_torch import convert
from repro_torch.models import ffn as TF
from repro_torch.models import moe as TMOE

from test_torch_models import _close, carry, check_prefill_and_decode

F32_TOL = 1e-5          # y, relative to max|y|
AUX_TOL = 1e-6
MOE = ["deepseek-moe-16b", "granite-moe-3b-a800m"]


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs
    return jax, jnp, configs


def _cfg(arch, dispatch, cf):
    _, _, configs = _jax()
    return dataclasses.replace(
        configs.smoke(arch), capacity_factor=cf,
        moe_dispatch="onehot" if dispatch == "onehot" else "sorted",
        moe_local_shards=4 if dispatch == "sharded" else 0)


@pytest.fixture(scope="module", params=MOE)
def layer(request):
    """(arch, reference params, port params) of one MoE layer."""
    jax, jnp, configs = _jax()
    from repro.models import moe as JMOE
    jp, _ = JMOE.moe_init(jax.random.PRNGKey(1), configs.smoke(
        request.param), jnp.float32)
    jp = jax.device_get(jp)
    return request.param, jp, convert.param_tree(jp, torch.device("cpu"))


def _x(cfg, t=32, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (2, t // 2, cfg.d_model)).astype(np.float32)


def _plain_f64(tp, cfg, x):
    """The semantics in float64, one token at a time: each token's top-k
    experts (the port's f32 router), an assignment kept when fewer than
    ``capacity`` earlier assignments of its shard (token-major order) went
    to the same expert, and y = sum of gate x expert FFN over the kept
    ones, plus the shared experts."""
    xt = torch.from_numpy(x.reshape(-1, cfg.d_model))
    t = xt.shape[0]
    _, gates, experts = TMOE.route(tp, cfg, xt)
    shards = TMOE.dispatch_shards(cfg, t)
    cap = TMOE.capacity(cfg, t // shards)
    act = {"silu": torch.nn.functional.silu}[cfg.act]
    w = {k: tp[k].double() for k in ("w1", "w3", "w2")}
    x64 = xt.double()
    y = torch.zeros_like(x64)
    dropped = 0
    for s in range(shards):
        seen = {}
        for i in range(s * t // shards, (s + 1) * t // shards):
            for j in range(cfg.top_k):
                e = int(experts[i, j])
                seen[e] = seen.get(e, 0) + 1
                if seen[e] > cap:
                    dropped += 1
                    continue
                h = act(x64[i] @ w["w1"][e]) * (x64[i] @ w["w3"][e])
                y[i] += float(gates[i, j]) * (h @ w["w2"][e])
    if "shared" in tp:
        sh = {k: tp["shared"][k]["w"].double() for k in ("w1", "w3", "w2")}
        y += (act(x64 @ sh["w1"]) * (x64 @ sh["w3"])) @ sh["w2"]
    return y, dropped


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("dispatch", ["sorted", "sharded", "onehot"])
def test_moe_apply_matches_reference(layer, dispatch, cf):
    jax, jnp, _ = _jax()
    from repro.models import moe as JMOE
    arch, jp, tp = layer
    cfg = _cfg(arch, dispatch, cf)
    x = _x(cfg)
    t = x.shape[0] * x.shape[1]
    xt = torch.from_numpy(x.reshape(t, -1))
    # the expert picks: the port's against jax.lax.top_k on the
    # reference's router probabilities
    probs = jax.nn.softmax(jnp.asarray(x.reshape(t, -1)) @ jp["router"]["w"],
                           axis=-1)
    _, want_e = jax.lax.top_k(probs, cfg.top_k)
    _, _, got_e = TMOE.route(tp, cfg, xt)
    p_sorted = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    margin = (p_sorted[:, cfg.top_k - 1] - p_sorted[:, cfg.top_k]).min()
    np.testing.assert_array_equal(
        got_e.numpy(), np.asarray(want_e),
        err_msg=f"top-k picks differ; smallest margin between the k-th "
                f"and (k+1)-th probability {margin}")
    want, want_aux = JMOE.moe_apply(jp, cfg, jnp.asarray(x))
    got, got_aux = TMOE.moe_apply(tp, cfg, torch.from_numpy(x))
    _close(got.numpy(), want, F32_TOL, f"{dispatch} y")
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL * max(
        1.0, abs(float(want_aux)))
    dropped = TMOE.dropped_assignments(cfg, got_e)
    if dispatch != "onehot":
        assert TMOE.dispatch_shards(cfg, t) == (4 if dispatch == "sharded"
                                                else 1)
    if cf == 0.5:
        assert dropped > 0
    if cf == 8.0:
        assert dropped == 0


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("dispatch", ["sorted", "sharded"])
def test_sorted_dispatch_matches_float64_loop(layer, dispatch, cf):
    arch, _, tp = layer
    cfg = _cfg(arch, dispatch, cf)
    x = _x(cfg, seed=3)
    got, _ = TMOE.moe_apply(tp, cfg, torch.from_numpy(x))
    want, dropped = _plain_f64(tp, cfg, x)
    _close(got.reshape(want.shape).numpy(), want.numpy(), F32_TOL,
           "sorted vs f64")
    _, _, experts = TMOE.route(tp, cfg, torch.from_numpy(
        x.reshape(-1, cfg.d_model)))
    assert TMOE.dropped_assignments(cfg, experts) == dropped


def test_repeated_call_is_bit_identical(layer):
    arch, _, tp = layer
    cfg = _cfg(arch, "sorted", 0.5)
    x = torch.from_numpy(_x(cfg, seed=4))
    a, _ = TMOE.moe_apply(tp, cfg, x)
    b, _ = TMOE.moe_apply(tp, cfg, x)
    assert torch.equal(a, b)


def test_capacity_is_the_reference_formula():
    cfg = TCFG.get("deepseek-moe-16b")
    assert TMOE.capacity(cfg, 4) == 1            # a 4-slot decode step
    assert TMOE.capacity(cfg, 512) == 60
    assert TMOE.dispatch_shards(cfg, 4) == 1     # 4 % 16 != 0
    assert TMOE.dispatch_shards(cfg, 64) == 16
    assert TMOE.dispatch_shards(TCFG.smoke("deepseek-moe-16b"), 64) == 1


def test_top1_of_one_expert_equals_its_ffn():
    """The counterpart of the reference's
    ``test_moe_top1_equals_dense_expert``."""
    cfg = dataclasses.replace(TCFG.smoke("granite-moe-3b-a800m"),
                              n_experts=1, top_k=1, capacity_factor=2.0)
    p = TMOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(_x(cfg, t=16))
    y, _ = TMOE.moe_apply(p, cfg, x)
    ffn = {k: {"w": p[k][0]} for k in ("w1", "w3", "w2")}
    np.testing.assert_allclose(y.numpy(), TF.ffn_apply(ffn, cfg, x).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("arch", MOE + ["deepseek-moe-16b:shards4"])
def test_prefill_and_decode_match_reference(arch):
    """Whole models; ``:shards4`` takes the sharded dispatch at prefill
    (T = 40) and the unsharded one at decode (T = 2)."""
    _, _, configs = _jax()
    name, _, shards = arch.partition(":shards")
    cfg = dataclasses.replace(configs.smoke(name),
                              moe_local_shards=int(shards or 0))
    check_prefill_and_decode(cfg, *carry(cfg))


def test_published_widths():
    d = TCFG.get("deepseek-moe-16b")
    assert (d.n_layers, d.d_model, d.n_experts, d.n_shared_experts,
            d.top_k, d.d_ff, d.first_k_dense, d.vocab) == \
        (28, 2048, 64, 2, 6, 1408, 1, 102400)
    assert d.n_params() == 16_317_022_208    # 32.6 GB in bf16
