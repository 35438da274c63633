"""The dry run's bytes and per-rank peak memory
(``launch.comm_analysis.StepRecorder``, ``launch.dryrun``).

* On a (1, 1) fake mesh (PyTorch's fake process group, fake tensors)
  the recorder's peak and bytes for a smoke config's train step equal,
  within 1 %, what the same recorder counts for the unsharded step on
  real CPU tensors: DTensor's global-shape propagation tensors are not
  counted (``MemTracker`` counted them).
* On (2, 2) the peak is at most 0.6 x the (1, 1) peak for a config
  whose parameters dominate (minicpm-2b at its published width, one
  layer).
* A dry-run record carries the reference's keys: ``memory.
  output_size_in_bytes``, ``temp_size_in_bytes``, ``peak_bytes``,
  ``hlo_bytes_raw``, ``cost["bytes"]``, and the chunks it was traced at.

The fake process group runs in a subprocess: it must not enter a test
worker.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.data.pipeline import for_config
    from repro_torch.launch.comm_analysis import StepRecorder
    from repro_torch.launch.dryrun import _fake_world, dryrun_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common as C
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedules import cosine
    from repro_torch.train.step import (make_train_step, place_batch,
                                        train_state_shardings)

    out = {}

    def opt():
        return AdamW(lr_fn=cosine(3e-4, 100, 10_000))

    def fake_step(model, shape, batch, chunk):
        _fake_world(shape[0] * shape[1])
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        rules = S.rules_for("train", batch["tokens"].shape[0],
                            dict(zip(mesh.mesh_dim_names, mesh.shape)))
        o = opt()
        step = make_train_step(model, o, remat=True, q_chunk=chunk,
                               k_chunk=chunk)
        with FakeTensorMode(allow_non_fake_inputs=True), \\
                S.use_rules(rules):
            _, osh = train_state_shardings(model, mesh, rules)

            def placer(t, spec):
                return S.place(t, mesh, S.placements(spec, mesh, rules))
            with C.placing(placer):
                params = model.build(C.NoDraw("cpu"))
            state = o.init(params, shardings=osh)
            b = place_batch(batch, mesh)
            rec = StepRecorder()
            held = rec.hold(params, state, b)
            with rec:
                step(params, state, b)
        return {"held": held, "peak": rec.peak_bytes, "bytes": rec.bytes,
                "flops": rec.flops}

    # (1) the unsharded real step vs the (1, 1) fake mesh
    cfg = configs.smoke("minicpm-2b")
    model = build_model(cfg, device="cpu")
    data = for_config(cfg, batch=2, seq=32)
    batch = {k: torch.as_tensor(v) for k, v in data.next().items()}
    o = opt()
    params = model.init(torch.Generator().manual_seed(0))
    state = o.init(params)
    rec = StepRecorder()
    held = rec.hold(params, state, batch)
    with rec:
        res = make_train_step(model, o, remat=True, q_chunk=16,
                              k_chunk=16)(params, state, batch)
    out["real"] = {"held": held, "peak": rec.peak_bytes,
                   "bytes": rec.bytes, "flops": rec.flops,
                   "loss": float(res[2]["loss"])}
    del res, params, state
    out["fake11"] = fake_step(model, (1, 1), batch, 16)

    # (2) a config whose parameters dominate: (1, 1) vs (2, 2)
    big = build_model(dataclasses.replace(configs.get("minicpm-2b"),
                                          n_layers=1), device="cpu")
    tb = {"tokens": torch.zeros(8, 64, dtype=torch.int32),
          "labels": torch.zeros(8, 64, dtype=torch.int32)}
    out["big11"] = fake_step(big, (1, 1), tb, 32)
    out["big22"] = fake_step(big, (2, 2), tb, 32)

    # (3) a record's keys, at chunks of 1024
    rec = dryrun_cell("seamless-m4t-medium", "decode_32k", "single",
                      q_chunk=1024, k_chunk=1024)
    out["record"] = {k: rec.get(k) for k in (
        "status", "q_chunk", "k_chunk", "hlo_bytes_raw", "memory", "cost",
        "flops_per_rank")}
    print("OUT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def run():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("OUT ")][-1]
    return json.loads(line[4:])


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1)


def test_real_step_is_counted(run):
    real = run["real"]
    assert real["held"] > 0 and real["bytes"] > 0 and real["flops"] > 0
    assert real["peak"] > real["held"]


@pytest.mark.parametrize("key", ["peak", "bytes", "held"])
def test_one_rank_mesh_counts_the_unsharded_step(run, key):
    """Within 1 %: DTensor's global-shape tensors are left out."""
    assert _rel(run["fake11"][key], run["real"][key]) <= 0.01, \
        (run["fake11"], run["real"])


def test_one_rank_mesh_flops_equal_the_unsharded_step(run):
    assert run["fake11"]["flops"] == run["real"]["flops"]


def test_four_ranks_hold_a_fraction_of_the_peak(run):
    one, four = run["big11"], run["big22"]
    assert four["peak"] <= 0.6 * one["peak"], (one, four)
    assert four["held"] <= 0.6 * one["held"]
    assert four["bytes"] < one["bytes"]


def test_record_carries_the_references_keys(run):
    rec = run["record"]
    assert rec["status"] == "ok"
    assert rec["q_chunk"] == rec["k_chunk"] == 1024
    mem = rec["memory"]
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "peak_bytes"):
        assert isinstance(mem[k], int) and mem[k] >= 0, k
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] == (mem["peak_bytes"]
                                         - mem["argument_size_in_bytes"])
    # the peak is a rank's: near its arguments, not the 208 GB of the
    # global-shape tensors
    assert mem["peak_bytes"] < 2 * mem["argument_size_in_bytes"]
    assert rec["hlo_bytes_raw"] > 0
    assert rec["cost"]["bytes"] == rec["hlo_bytes_raw"]
    assert "unfused" in rec["cost"]["bytes_kind"]
    assert rec["cost"]["flops"] == rec["flops_per_rank"]
