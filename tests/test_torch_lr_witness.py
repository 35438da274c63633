"""The launcher's first steps at lr 3e-4, the reference against the port.

``launch.train``'s WSD for a 6-step run (warmup 1, stable 3, decay 2),
read at the step counter after the update, gives the full 3e-4 to the
first three updates, so the loss read at step 1 is the first after a
full-size Adam step.  The same params (the
reference's init, carried across with ``convert.model_params``) train
on the same batches (``data.pipeline.for_config``) in both packages,
float32, and the losses of every step are reported side by side.

As a test it runs the qwen2.5-14b smoke config (a subprocess, JAX on the
CPU): every loss within TOL relative of the reference's.  Run as a
script it takes qwen2.5-14b's published width -- d_model 5120, 40 / 8
heads, d_ff 13824 -- at 2 layers with the vocab cut to 8192 (the
embedding and head at full vocab would need another 6 GB a copy of
the state), batch 2 x 64, and prints one JSON line with both packages'
losses and each one's peak resident memory::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lr_witness.py

It needs about 16 GB of host memory at that width.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TOL = 1e-5
STEPS = 3

_RUN = textwrap.dedent("""
    import dataclasses, gc, json, resource, sys
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    from repro import configs
    from repro.models.api import build_model as jbuild
    from repro.train.optimizer import AdamW as JAdamW
    from repro.train.schedules import wsd as jwsd
    from repro.train.step import make_train_step as jmake
    from repro_torch import convert
    from repro_torch.data.pipeline import for_config
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedules import wsd
    from repro_torch.train.step import make_train_step

    arch, over, b, s, steps = (sys.argv[1], json.loads(sys.argv[2]),
                               int(sys.argv[3]), int(sys.argv[4]),
                               int(sys.argv[5]))
    base = configs.smoke(arch) if over.pop("smoke", False) \\
        else configs.get(arch)
    cfg = dataclasses.replace(base, param_dtype="float32",
                              activation_dtype="float32", **over)
    data = for_config(cfg, batch=b, seq=s, seed=0)
    batches = [data.next() for _ in range(steps)]
    kw = dict(q_chunk=64, k_chunk=64)
    # the launcher's WSD for a 6-step run
    sched = (3e-4, 1, 3, 2)

    def rss_gib():
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20

    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    host = jax.device_get(jp)
    jopt = JAdamW(lr_fn=jwsd(*sched))
    # the f32 master aliases the f32 params: copied, so both can be donated
    js = jax.tree.map(jnp.copy, jopt.init(jp))
    jstep = jax.jit(jmake(jm, jopt, **kw), donate_argnums=(0, 1))
    ref, lrs = [], []
    for bt in batches:
        jp, js, met = jstep(jp, js, {k: jnp.asarray(v) for k, v in bt.items()})
        ref.append(float(met["loss"]))
        lrs.append(float(met["lr"]))
    del jp, js, jstep, met
    gc.collect()
    rss_ref = rss_gib()

    tm = build_model(cfg, device="cpu")
    tp = convert.model_params(host, cfg, device="cpu")
    del host
    topt = AdamW(lr_fn=wsd(*sched))
    ts = topt.init(tp)
    tstep = make_train_step(tm, topt, **kw)
    port = []
    for bt in batches:
        tp, ts, met = tstep(tp, ts, {k: torch.from_numpy(v)
                                     for k, v in bt.items()})
        port.append(float(met["loss"]))
    print("OUT " + json.dumps({
        "config": cfg.name, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "n_layers": cfg.n_layers, "vocab": cfg.vocab, "batch": b, "seq": s,
        "lr": lrs, "reference_losses": ref, "port_losses": port,
        "peak_rss_gib_after_reference": rss_ref,
        "peak_rss_gib": rss_gib()}), flush=True)
""")


def witness(arch: str, over: dict, batch: int, seq: int,
            steps: int = STEPS, timeout: int = 3000) -> dict:
    """Both packages' losses over ``steps`` steps, in a subprocess."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _RUN, arch, json.dumps(over),
                        str(batch), str(seq), str(steps)],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads([ln for ln in r.stdout.splitlines()
                       if ln.startswith("OUT ")][-1][4:])


def test_first_full_lr_step_matches_reference():
    w = witness("qwen2.5-14b", {"smoke": True}, 2, 16)
    assert w["lr"][0] == w["lr"][1] == pytest.approx(3e-4)
    for a, b in zip(w["port_losses"], w["reference_losses"]):
        assert abs(a - b) <= TOL * abs(b), w


if __name__ == "__main__":
    print(json.dumps(witness("qwen2.5-14b", {"n_layers": 2, "vocab": 8192},
                             2, 64)))
