"""The port's AdamW, schedules and watchdog (``repro_torch.train``)
against the reference's (``repro.train``) on the CPU.

AdamW: the same params and gradients (numpy, drawn from a seed) through
1 and 3 updates of both, float32 and bfloat16 params, gradient clipping
active and inactive: params, ``m``, ``v``, the float32 master,
``grad_norm`` and ``lr`` within TOL relative (to max|ref| per tensor).
Schedules: the lr at every step of a horizon, as one curve, within TOL
relative to its largest value (float32 ``cos`` near -1 loses the digits
of ``1 + cos`` in both packages alike).
"""
import numpy as np
import pytest
import torch
from torch import nn

from repro_torch.train import loop as TL
from repro_torch.train import optimizer as TO
from repro_torch.train import schedules as TS

TOL = 1e-6
SHAPES = {"embed": (40, 8), "w": (8, 12), "g": (12,)}


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    return jax, jnp


def _close(got, want, what):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale, what


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [True, False])
def test_adamw_matches_reference(steps, dtype, clip):
    jax, jnp = _jax()
    from repro.train.optimizer import AdamW as JAdamW
    from repro.train.schedules import wsd as jwsd
    rng = np.random.default_rng(steps * 10 + len(dtype) + clip)
    init = {k: rng.standard_normal(s).astype(np.float32) * 0.5
            for k, s in SHAPES.items()}
    # gradients of global norm ~ 11.6 (clipped at 1.0) or ~ 0.012
    gscale = 1.0 if clip else 1e-3
    grads = [{k: (rng.standard_normal(s) * gscale).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    kw = dict(weight_decay=0.1, grad_clip=1.0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    jopt = JAdamW(lr_fn=jwsd(1e-2, warmup=2, stable=1, decay=4), **kw)
    jp = {k: jnp.asarray(v, jdt) for k, v in init.items()}
    js = jopt.init(jp)
    topt = TO.AdamW(lr_fn=TS.wsd(1e-2, warmup=2, stable=1, decay=4), **kw)
    tp = nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v).to(tdt),
                                           requires_grad=False)
                           for k, v in init.items()})
    ts = topt.init(tp)
    assert all(p.requires_grad for p in tp.parameters())
    for g in grads:
        jp, js, jinfo = jopt.update({k: jnp.asarray(v, jdt)
                                     for k, v in g.items()}, js, jp)
        tp, ts, tinfo = topt.update({k: torch.from_numpy(v).to(tdt)
                                     for k, v in g.items()}, ts, tp)
    assert int(ts.step) == int(js.step) == steps
    assert ts.step.dtype == torch.int32
    for k in SHAPES:
        assert tp[k].dtype == tdt and ts.master[k].dtype == torch.float32
        _close(ts.m[k], js.m[k], f"m {k}")
        _close(ts.v[k], js.v[k], f"v {k}")
        _close(ts.master[k], js.master[k], f"master {k}")
        _close(tp[k], np.asarray(jp[k], np.float32), f"param {k}")
    for k in ("grad_norm", "lr"):
        assert tinfo[k].dtype == torch.float32 and tinfo[k].shape == ()
        _close(tinfo[k], jinfo[k], k)
    assert (float(tinfo["grad_norm"]) > 1.0) == clip


def test_missing_gradient_counts_as_zero():
    """A parameter the loss does not reach: its moments stay 0 and only
    weight decay moves it, as ``jax.grad``'s zero gradient does."""
    tp = nn.ParameterDict({"a": nn.Parameter(torch.ones(3)),
                           "b": nn.Parameter(torch.ones(2))})
    opt = TO.AdamW(lr_fn=TS.constant(0.1), weight_decay=0.5)
    st = opt.init(tp)
    tp, st, info = opt.update({"a": torch.full((3,), 2.0), "b": None}, st, tp)
    assert torch.equal(st.m["b"], torch.zeros(2))
    assert torch.allclose(tp["b"], torch.full((2,), 1 - 0.1 * 0.5))
    assert float(info["grad_norm"]) == pytest.approx(12 ** 0.5)


def test_init_takes_only_floating_params():
    tp = nn.ParameterDict({"w": nn.Parameter(torch.ones(2),
                                             requires_grad=False)})
    st = TO.AdamW(lr_fn=TS.constant(1.0)).init(tp)
    assert list(st.master) == ["w"] and tp["w"].requires_grad
    st.master["w"].add_(1.0)          # the master is a copy
    assert float(tp["w"].detach()[0]) == 1.0


def test_global_norm_matches_reference():
    jax, jnp = _jax()
    from repro.train.optimizer import global_norm as jnorm
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES.values()]
    _close(TO.global_norm([torch.from_numpy(x).bfloat16() for x in xs]),
           jnorm([jnp.asarray(x, jnp.bfloat16) for x in xs]), "norm bf16")
    _close(TO.global_norm({str(i): torch.from_numpy(x)
                           for i, x in enumerate(xs)}),
           jnorm(xs), "norm f32")


def test_zero1_raises_naming_its_item():
    """ZeRO-1 is ported (ROADMAP 1.28): ``zero1_axis`` gives the
    reference's picks (``tests/test_train_substrate.py``'s cases; every
    config's against the reference in ``test_torch_sharding.py``) and
    ``zero1_specs`` resolves a spec tree over a mesh's shape."""
    assert TO.zero1_axis((1024, 512), ("model", None), ["data"],
                         {"data": 16, "model": 16}) == ("model", ("data",))
    assert TO.zero1_axis((8,), (None,), ["data"], {"data": 16}) == (None,)
    assert TO.zero1_axis((4096, 32), (None, None), ["pod", "data"],
                         {"pod": 2, "data": 16, "model": 16}) == \
        (("pod", "data"), None)
    from repro_torch.models.sharding import use_rules, DEFAULT_SINGLE_POD
    with use_rules(DEFAULT_SINGLE_POD):
        z = TO.zero1_specs({"w": ("model", None), "g": (None,)},
                           {"w": (64, 32), "g": (16,)},
                           {"data": 2, "model": 2})
    assert z == {"w": (("model",), ("data",)), "g": (("data",),)}


@pytest.mark.parametrize("name", ["wsd", "wsd_short", "cosine",
                                  "cosine_zero", "constant"])
def test_schedule_matches_reference_at_every_step(name):
    jax, jnp = _jax()
    from repro.train import schedules as JS
    args = {"wsd": ("wsd", (3e-4, 10, 20, 10)),
            "wsd_short": ("wsd", (1e-2, 1, 4, 3, 0.05)),
            "cosine": ("cosine", (3e-4, 10, 110)),
            "cosine_zero": ("cosine", (1.0, 5, 50, 0.0)),
            "constant": ("constant", (2e-4,))}[name]
    tfn = getattr(TS, args[0])(*args[1])
    jfn = getattr(JS, args[0])(*args[1])
    got = [tfn(torch.tensor(s, dtype=torch.int32)) for s in range(121)]
    assert all(g.dtype == torch.float32 and g.shape == () for g in got)
    _close(torch.stack(got), [float(jfn(jnp.asarray(s, jnp.int32)))
                              for s in range(121)], name)


def test_watchdog_flags_stragglers():
    wd = TL.Watchdog(straggler_factor=3.0)
    for i in range(10):
        wd.record(i, 0.1)
    assert wd.record(10, 1.0)            # 10x median -> straggler
    assert len(wd.stragglers) == 1
