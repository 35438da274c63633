"""The port's LM engine (``repro_torch.serve.Engine``) against the
reference's (``repro.serve.engine.Engine``) and its greedy decode.

The reference's params carried across (``convert.model_params``) on
smoke configs (2 layers, float32, the CPU); prompts from numpy seeds.
Held token for token: the port's engine against the reference's
``_greedy_reference`` (``tests/test_serve_engine.py``), against the
reference's engine at one slot, and every request of a batched run
against its solo run -- which the reference's batched engine misses:
its ``_prefill_one`` streams a new prompt through every slot
(the cross-talk fixed in the port; ROADMAP.md queue 3).
"""
import copy
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as TCFG
from repro_torch import convert
from repro_torch.models.api import build_model
from repro_torch.serve import Engine, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models.api import build_model as jbuild
    from repro.serve import engine as JE
    return jax, configs, jbuild, JE


@pytest.fixture(scope="module")
def pair():
    """Per smoke arch: the reference model, params and jitted decode step
    (shared by every reference engine), and the port's model and params
    carried across."""
    jax, configs, jbuild, _ = _jax()
    out = {}

    def get(arch, seed):
        if (arch, seed) not in out:
            cfg = configs.smoke(arch)
            jm = jbuild(cfg)
            jp = jm.init(jax.random.PRNGKey(seed))
            tm = build_model(TCFG.smoke(arch), device="cpu")
            tp = convert.model_params(jax.device_get(jp), cfg, device="cpu")
            out[arch, seed] = (cfg, jm, jp, jax.jit(jm.decode_step), tm, tp)
        return out[arch, seed]
    return get


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
            for n in lengths]


def _run_port(tm, tp, prompts, *, slots, max_new, max_len=64, eos_id=-1):
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    Engine(tm, tp, batch_slots=slots, max_len=max_len, eos_id=eos_id).run(
        reqs)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def _run_ref(JE, jm, jp, step, prompts, *, slots, max_new, max_len=64,
             eos_id=-1):
    reqs = [JE.Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    eng = JE.Engine(jm, jp, batch_slots=slots, max_len=max_len,
                    eos_id=eos_id)
    eng._decode = step                   # one compile for every engine
    eng.run(reqs)
    return [r.out for r in reqs]


def test_engine_matches_reference_greedy_decode(pair):
    """The counterpart of ``test_engine_matches_sequential_decode``."""
    from test_serve_engine import _greedy_reference
    cfg, jm, jp, _, tm, tp = pair("qwen2.5-14b", 0)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (6,)).astype(
        np.int32)
    want = _greedy_reference(jm, jp, prompt, 5, 64)
    assert _run_port(tm, tp, [prompt], slots=2, max_new=5) == [want]


@pytest.mark.parametrize("eos", [False, True])
def test_each_request_alone_equals_reference_engine(pair, eos):
    _, _, _, JE = _jax()
    cfg, jm, jp, step, tm, tp = pair("minicpm-2b", 0)
    prompts = _prompts(cfg, (4, 9, 14))
    for p in prompts:
        eos_id = -1
        if eos:   # stop at the third token the request would produce
            eos_id = _run_ref(JE, jm, jp, step, [p], slots=1, max_new=8)[0][2]
        want = _run_ref(JE, jm, jp, step, [p], slots=1, max_new=8,
                        eos_id=eos_id)
        got = _run_port(tm, tp, [p], slots=1, max_new=8, eos_id=eos_id)
        assert got == want
        assert len(got[0]) == (3 if eos else 8)


def test_batched_requests_equal_their_solo_runs_unlike_reference(pair):
    """minicpm-2b smoke, three prompts of 4, 9 and 14 tokens, 8 new
    tokens each, three slots: the reference's batched run changes the
    requests admitted first (their caches take the later prompts' steps),
    the port's equals every solo run."""
    _, _, _, JE = _jax()
    cfg, jm, jp, step, tm, tp = pair("minicpm-2b", 0)
    prompts = _prompts(cfg, (4, 9, 14))
    solo = [_run_ref(JE, jm, jp, step, [p], slots=1, max_new=8)[0]
            for p in prompts]
    ref_batched = _run_ref(JE, jm, jp, step, prompts, slots=3, max_new=8)
    assert ref_batched != solo
    assert ref_batched[2] == solo[2]     # admitted last: no cross-talk
    assert _run_port(tm, tp, prompts, slots=3, max_new=8) == solo


def test_slot_reuse_with_more_requests_than_slots(pair):
    _, _, _, JE = _jax()
    cfg, jm, jp, step, tm, tp = pair("qwen2.5-14b", 1)
    prompts = _prompts(cfg, (5, 3, 8, 4, 6, 2), seed=4)
    solo = [_run_ref(JE, jm, jp, step, [p], slots=1, max_new=6)[0]
            for p in prompts]
    got = _run_port(tm, tp, prompts, slots=2, max_new=6)
    assert got == solo
    assert all(len(o) == 6 for o in got)


def test_request_of_one_token_frees_its_slot_at_admission():
    cfg = TCFG.smoke("qwen2.5-14b")
    tm = build_model(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    eng = Engine(tm, tp, batch_slots=1, max_len=32)
    reqs = [Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32),
                    max_new=1) for i in range(3)]
    eng.run(reqs)
    assert all(r.done and len(r.out) == 1 for r in reqs)
    assert eng.active == [None]


def test_serve_launcher_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-4b", "--device", "cpu", "--requests", "3",
         "--max-new", "4"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "3 requests, 12 tokens" in out.stdout


def test_serve_launcher_no_smoke_reaches_the_published_config(monkeypatch):
    """``--no-smoke`` builds the published config (the reference's
    ``--smoke`` cannot be turned off)."""
    from repro_torch.launch import serve as LS
    seen = []

    def stop(cfg, device=None):
        seen.append(cfg)
        raise RuntimeError("stop")
    monkeypatch.setattr(LS, "build_model", stop)
    for flag, want in (("--no-smoke", TCFG.get), ("--smoke", TCFG.smoke)):
        with pytest.raises(RuntimeError, match="stop"):
            LS.main(["--arch", "qwen2.5-14b", flag, "--device", "cpu"])
        assert seen[-1] == want("qwen2.5-14b")


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_engine_on_card_matches_cpu_and_runs_k5():
    """qwen2.5-14b smoke on the card: the same tokens as on the CPU, with
    layer 0's FFN sparse (K5 launched) and every request equal to its
    solo run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels.pjds_spmm import pjds_matmat_kernel_call as k5
    from repro_torch.sparse import sparsify_ffn_params
    cfg = TCFG.smoke("qwen2.5-14b")
    base = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    prompts = _prompts(cfg, (4, 9, 14, 5))
    tokens = {}
    for dev in ("cpu", "cuda"):
        tm = build_model(cfg, device=dev)
        tp = copy.deepcopy(base).to(dev)
        tp["dec"][0]["mlp"] = sparsify_ffn_params(base["dec"][0]["mlp"],
                                                  0.5, device=dev)
        k5.launches = 0
        tokens[dev] = _run_port(tm, tp, prompts, slots=2, max_new=8)
        solo = [_run_port(tm, tp, [p], slots=1, max_new=8)[0]
                for p in prompts]
        assert tokens[dev] == solo
        if dev == "cuda":
            assert k5.launches >= 1
    assert tokens["cuda"] == tokens["cpu"]
