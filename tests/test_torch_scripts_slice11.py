"""Rehearsals on the CPU of the model across cards' card scripts.

* ``dist_train.py --backend gloo --smoke``: the four-card training
  harness as four gloo CPU processes on the families' smoke configs --
  every phase's checks pass and each prints its line, the last
  ``{"ok": true, ...}``.
* ``chip_smoke.slice11_phases`` with a host-clock harness: the CPU in
  place of the card, smoke configs (minicpm-2b in bfloat16, llava with
  the parallel block), counts that return zeros; the sharded step on the
  one-rank mesh equals the unsharded one bit for bit, and the sharded
  prefill and decode steps (``mesh:one:decode``) stay within 1e-6.
Both run in subprocesses: they start process groups.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def test_dist_train_rehearses_on_gloo():
    r = subprocess.run([sys.executable, str(ROOT / "dist_train.py"),
                        "--backend", "gloo", "--smoke", "--timeout", "500"],
                       env=_env(), cwd=ROOT, capture_output=True, text=True,
                       timeout=560)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    assert lines[-1]["ok"] is True and lines[-1]["ranks"] == 4
    by = {ln.get("phase"): ln for ln in lines}
    for phase in ("dist_train:qwen2.5-14b:tp4", "dist_train:gemma3-4b:2x2",
                  "dist_train:elastic", "dist_train:launch:host",
                  "dist_train:parity"):
        assert phase in by, phase
    tp4 = by["dist_train:qwen2.5-14b:tp4"]
    assert tp4["held_bytes"] == tp4["predicted_bytes"]
    assert tp4["collectives_per_rank"][0]["counts"].get("all-reduce", 0) > 0
    assert by["dist_train:gemma3-4b:2x2"]["master_leaves_quartered"] > 0
    assert by["dist_train:elastic"]["all_ranks_ok"]
    assert by["dist_train:parity"]["m_max_rel_err"] <= 1e-5


_SLICE11 = textwrap.dedent("""
    import dataclasses, json, sys, tempfile, types
    sys.path.insert(0, sys.argv[1])
    import torch
    import chip_smoke as CS
    from repro_torch import configs as TCFG

    def require(ok, what):
        if not ok:
            raise AssertionError(what)
    rows = {}
    out = CS.slice11_phases(types.SimpleNamespace(
        dev=torch.device("cpu"), seed=0, require=require,
        emit=lambda phase, **f: rows.__setitem__(phase, f),
        counts=lambda: ({"pjds_spmv": 0}, {}), reset_counts=lambda: None,
        plain_free=lambda calls, phase: None,
        cfgs={"main": dataclasses.replace(
                  TCFG.smoke("minicpm-2b"), param_dtype="bfloat16",
                  activation_dtype="bfloat16"),
              "parallel": dataclasses.replace(
                  TCFG.smoke("llava-next-mistral-7b"), parallel_block=True)},
        batch=2, seq=32, steps=3, pb_batch=2, pb_prompt=8, pb_steps=4,
        decode_batch=2, decode_prompt=8, decode_steps=4,
        tmp=tempfile.mkdtemp()))
    print("OUT " + json.dumps({"rows": rows, "launches": out["launches"]},
                              default=str))
""")


def test_slice11_phases_rehearse_on_the_cpu():
    r = subprocess.run([sys.executable, "-c", _SLICE11, str(ROOT)],
                       env=_env(), cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads([ln for ln in r.stdout.splitlines()
                      if ln.startswith("OUT ")][-1][4:])
    one = out["rows"]["mesh:one:minicpm-2b-smoke"]
    assert one["bit_equal"] and one["max_rel_err"] == 0.0
    dec = out["rows"]["mesh:one:decode:minicpm-2b-smoke"]
    assert dec["decode_steps"] == 4 and len(dec["rel_err_per_step"]) == 5
    assert dec["max_rel_err"] <= 1e-6 and isinstance(dec["bit_equal"], bool)
    pb = out["rows"]["lm:parallel_block:llava-next-mistral-7b-smoke"]
    assert pb["steps_vs_longer_prefill_rel_l2"] <= 1e-5
    assert pb["sequential_block_rel_l2"] > 1e-3
    assert out["launches"] == {"pjds_spmv": 0}
