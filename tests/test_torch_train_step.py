"""``make_train_step`` against the reference's jitted ``make_train_step``
for one step on the CPU.

Smoke configs (float32), params carried across with
``convert.model_params``, the reference's ``AdamWState`` with
``convert.adamw_state``; one batch of ``data.pipeline.for_config``
(2 x 16 tokens, frames or patches from the same seed), q / k chunks of
8.  Held: ``loss``, ``nll``, ``aux``, ``grad_norm`` and ``lr`` within
TOL relative; after the step every param and master within TOL relative
to max|ref| of its tensor, and ``m`` and ``v`` -- after one step the
clipped gradient and its square, scaled -- within the gradients' own
GRAD_TOL (``test_torch_train_loss.py``: a gradient summed over every
token, as Mamba's ``D``'s is, rounds apart by 2e-5 of its largest
element); the step counter equal.  The lr is the launcher's WSD at its
first step.

Every leaf of the carried params is the reference's init plus N(0,
0.02^2) noise, the same in both packages: a first Adam step moves an
element by lr * g / (|g| + eps), which turns the gradients' float32
rounding into a change of lr * 1e-4 where |g| is near eps, so a leaf
the init sets to zero (a bias) would hold nothing but that change, and
a comparison relative to its own largest value measures the rounding.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.data.pipeline import for_config
from repro_torch.train.optimizer import AdamW, trainable
from repro_torch.train.schedules import wsd
from repro_torch.train.step import make_train_step

from test_torch_models import _close, carry
from test_torch_train_loss import GRAD_TOL, _cfg

TOL = 1e-5
STEP_ARCHS = ["minicpm-2b", "granite-moe-3b-a800m", "seamless-m4t-medium",
              "llava-next-mistral-7b"]
KW = dict(q_chunk=8, k_chunk=8)


def check_one_step(arch):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.train.optimizer import AdamW as JAdamW
    from repro.train.schedules import wsd as jwsd
    from repro.train.step import make_train_step as jmake
    cfg = _cfg(arch)
    jm, jp, tm, _ = carry(cfg)
    rng = np.random.default_rng(6)
    jp = jax.tree.map(lambda x: (x + rng.normal(0, 0.02, x.shape)).astype(
        x.dtype), jax.device_get(jp))
    tp = convert.model_params(jp, cfg, device="cpu")
    batch = for_config(cfg, batch=2, seq=16, seed=4).next()

    jopt = JAdamW(lr_fn=jwsd(3e-4, 10, 50, 33))
    js = jopt.init(jp)
    jp2, js2, jmet = jax.jit(jmake(jm, jopt, **KW))(
        jp, js, {k: jnp.asarray(v) for k, v in batch.items()})

    topt = AdamW(lr_fn=wsd(3e-4, 10, 50, 33))
    ts = topt.init(tp)
    carried = convert.adamw_state(jax.device_get(js), cfg, tp, device="cpu")
    assert list(carried.master) == list(ts.master)
    tp2, ts2, tmet = make_train_step(tm, topt, **KW)(
        tp, carried, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert sorted(tmet) == sorted(jmet)
    for k, v in tmet.items():
        assert v.dtype == torch.float32 and v.shape == (), k
        want = float(jmet[k])
        assert abs(float(v) - want) <= TOL * max(abs(want), 1e-30), \
            (cfg.name, k, float(v), want)
    assert int(ts2.step) == int(js2.step) == 1
    want = convert.adamw_state(jax.device_get(js2), cfg, tp2, device="cpu")
    wp = dict(convert.model_params(jax.device_get(jp2), cfg,
                                   device="cpu").named_parameters())
    for n, p in trainable(tp2).items():
        assert p.grad is None
        _close(p.detach().numpy(), wp[n].detach().numpy(), TOL, f"param {n}")
        for what, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL),
                          ("master", TOL)):
            _close(getattr(ts2, what)[n].numpy(),
                   getattr(want, what)[n].numpy(), tol, f"{what} {n}")


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch):
    check_one_step(arch)


def test_eight_launcher_steps_follow_the_reference():
    """Eight steps of the launcher's schedule for 8 steps (WSD at 3e-4,
    warmup 1, stable 4, decay 2) on the minicpm-2b smoke config, the
    pipeline's batches: every step's loss and grad norm within TOL of
    the reference's jitted steps."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.data.pipeline import for_config as jfor
    from repro.train.optimizer import AdamW as JAdamW
    from repro.train.schedules import wsd as jwsd
    from repro.train.step import make_train_step as jmake
    cfg = _cfg("minicpm-2b")
    jm, jp, tm, tp = carry(cfg)
    jopt = JAdamW(lr_fn=jwsd(3e-4, 1, 4, 2))
    topt = AdamW(lr_fn=wsd(3e-4, 1, 4, 2))
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(jmake(jm, jopt, **KW))
    tstep = make_train_step(tm, topt, **KW)
    jd, td = jfor(cfg, batch=2, seq=32), for_config(cfg, batch=2, seq=32)
    for i in range(8):
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in jd.next().items()})
        tp, ts, tmet = tstep(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in td.next().items()})
        for k in ("loss", "grad_norm", "lr"):
            want = float(jmet[k])
            assert abs(float(tmet[k]) - want) <= TOL * abs(want), (i, k)


def test_train_step_reads_nothing_back(monkeypatch):
    """No host read inside the step: ``Tensor.item`` / ``tolist`` /
    ``__float__`` are never called between loss and update."""
    cfg = _cfg("minicpm-2b")
    _, _, tm, tp = carry(cfg)
    opt = AdamW(lr_fn=wsd(3e-4, 10, 50, 33))
    st = opt.init(tp)
    batch = {k: torch.from_numpy(v) for k, v in
             for_config(cfg, batch=2, seq=16).next().items()}
    for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, _refuse(name))
    step = make_train_step(tm, opt, **KW)
    _, st, met = step(tp, st, batch)
    monkeypatch.undo()
    assert np.isfinite(float(met["loss"])) and int(st.step) == 1


def _refuse(name):
    def f(*args, **kwargs):
        raise AssertionError(f"host read: Tensor.{name}")
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-moe-3b-a800m"])
def test_train_step_on_the_card_matches_the_cpu(arch):
    """One step of the f32 smoke config on the card (TF32 off) against
    the same step on the CPU, from the same noised params and batch:
    metrics within TOL relative, every param within TOL * max|p|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy
    import repro_torch.configs as TCFG
    from repro_torch.models.api import build_model
    cfg = TCFG.smoke(arch)
    base = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in base.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    batch = for_config(cfg, batch=4, seq=64).next()
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            params = copy.deepcopy(base).to(dev)
            opt = AdamW(lr_fn=wsd(3e-4, 10, 50, 33))
            state = opt.init(params)
            _, _, met = make_train_step(build_model(cfg, device=dev), opt,
                                        **KW)(params, state, {
                                            k: torch.as_tensor(v).to(dev)
                                            for k, v in batch.items()})
            out[dev] = ({k: float(v) for k, v in met.items()},
                        {n: p.detach().cpu()
                         for n, p in trainable(params).items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for k, want in out["cpu"][0].items():
        got = out["cuda"][0][k]
        assert abs(got - want) <= TOL * max(abs(want), 1e-30), (k, got, want)
    for n, want in out["cpu"][1].items():
        _close(out["cuda"][1][n].numpy(), want.numpy(), TOL, n)
