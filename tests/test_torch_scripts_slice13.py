"""Rehearsals on the CPU of the four-card serving script and of the
four-card training script's falcon-mamba-7b phase.

* ``dist_serve.py --backend gloo --smoke``: four gloo CPU processes on
  the smoke configs -- every phase prints its line and ends
  ``{"ok": true, ...}``; each rank holds the bytes the layout predicts;
  the MoE repeats its tokens; the context-parallel phase agrees with
  rank 0 alone; the parity rows stay within their bounds on every step,
  caches and counters included.
* ``dist_train.py --backend gloo --smoke``: its
  ``dist_train:falcon-mamba-7b:tp4`` line (held bytes as the layout
  says, finite losses, the recorded step's all-gathers) and the
  falcon-mamba-7b row of ``dist_train:parity``.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL, SERVE_TOL = 1e-5, 1e-4


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _lines(script):
    r = subprocess.run([sys.executable, str(ROOT / script), "--backend",
                        "gloo", "--smoke", "--timeout", "500"],
                       env=_env(), cwd=ROOT, capture_output=True, text=True,
                       timeout=560)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    assert lines[-1]["ok"] is True and lines[-1]["ranks"] == 4
    return {ln.get("phase"): ln for ln in lines}


@pytest.fixture(scope="module")
def serve():
    return _lines("dist_serve.py")


SERVE_PHASES = ("dist_serve:qwen2.5-14b:b16x32k",
                "dist_serve:gemma3-4b:cp524k",
                "dist_serve:deepseek-moe-16b:tp4",
                "dist_serve:falcon-mamba-7b:tp4")


@pytest.mark.parametrize("phase", SERVE_PHASES)
def test_dist_serve_phase_holds_its_layout(serve, phase):
    row = serve[phase]
    assert row["finite"] and row["counters_ok"], row
    assert row["weight_bytes"] == row["predicted_weight_bytes"]
    assert row["cache_bytes"] == row["predicted_cache_bytes"]
    assert len(row["tokens"]) == row["steps"] + 1
    assert len(row["step_ms_per_rank"]) == 4
    assert row["collectives"]["counts"], row["collectives"]


def test_dist_serve_layouts(serve):
    assert serve["dist_serve:qwen2.5-14b:b16x32k"]["rules"]["batch"] == \
        ["data"]
    cp = serve["dist_serve:gemma3-4b:cp524k"]
    assert cp["rules"]["kvseq"] == ["data"] and "batch" not in cp["rules"]
    assert cp["prompt"] > 16        # past the smoke config's window
    one = cp["one_card"]
    assert max(one["max_rel_logit_err_per_step"]) <= TOL, one
    assert one["greedy_agreement"] == 1.0, one


def test_dist_serve_moe_repeats_its_tokens(serve):
    moe = serve["dist_serve:deepseek-moe-16b:tp4"]
    assert moe["tokens_repeat_equal"] is True
    assert moe["routed_calls"] > 0 and moe["dropped_decode"] >= 0


def test_dist_serve_parity(serve):
    rows = serve["dist_serve:parity"]["rows"]
    assert len(rows) == 4
    for name, row in rows.items():
        tol = SERVE_TOL if "moe" in name else TOL
        assert row["tol"] == tol
        assert len(row["logit_errs"]) == row["steps"] + 1 == 17
        assert row["max_logit_err"] <= tol, (name, row["logit_errs"])
        assert row["cache_max_rel_err"] <= tol, name
        assert row["counters_equal"], name


def test_dist_train_falcon_mamba_phase_rehearses_on_gloo():
    by = _lines("dist_train.py")
    f = by["dist_train:falcon-mamba-7b:tp4"]
    assert f["mesh"] == {"data": 1, "model": 4}
    assert f["held_bytes"] == f["predicted_bytes"]
    assert f["finite"] and len(f["losses"]) == 2
    assert f["all_gather_sizes"], f
    assert len(f["collectives_per_rank"]) == 4
    rows = by["dist_train:parity"]["rows"]
    ssm = rows["falcon-mamba-7b-smoke"]
    assert ssm["mesh"] == [1, 4]
    assert max(ssm["rel_err"].values()) <= TOL
    assert ssm["m_max_rel_err"] <= TOL and ssm["sqrt_v_max_rel_err"] <= TOL
