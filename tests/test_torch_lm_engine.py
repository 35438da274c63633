"""The port's LM engine (``repro_torch.serve.Engine``) against the
reference's (``repro.serve.engine.Engine``) and its greedy decode.

The reference's params carried across (``convert.model_params``) on
smoke configs (2-4 layers, float32, the CPU; every family: dense, MoE,
Mamba, RG-LRU, the VLM and the encoder-decoder, whose engine cross
cache stays zero as the reference's does); prompts from numpy seeds.
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
NEW_FAMILIES = ["deepseek-moe-16b", "granite-moe-3b-a800m", "falcon-mamba-7b",
                "recurrentgemma-2b", "llava-next-mistral-7b",
                "seamless-m4t-medium"]


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
@pytest.mark.parametrize("arch", ["minicpm-2b"] + NEW_FAMILIES)
def test_each_request_alone_equals_reference_engine(pair, arch, eos):
    _, _, _, JE = _jax()
    cfg, jm, jp, step, tm, tp = pair(arch, 0)
    prompts = _prompts(cfg, (4, 9, 14))
    for p in prompts:
        eos_id, n_out = -1, 8
        if eos:   # stop at the third token the request would produce
            full = _run_ref(JE, jm, jp, step, [p], slots=1, max_new=8)[0]
            eos_id = full[2]
            # the first occurrence past the prefill's token, which the
            # engine does not test for EOS
            n_out = full.index(eos_id, 1) + 1
        want = _run_ref(JE, jm, jp, step, [p], slots=1, max_new=8,
                        eos_id=eos_id)
        got = _run_port(tm, tp, [p], slots=1, max_new=8, eos_id=eos_id)
        assert got == want
        assert len(got[0]) == n_out


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


@pytest.mark.parametrize("arch", ["qwen2.5-14b"] + NEW_FAMILIES)
def test_slot_reuse_with_more_requests_than_slots(pair, arch):
    """Six requests through two slots (one for MoE, whose capacity
    couples the tokens of a step) equal their solo runs in the
    reference's engine: a reused slot keeps nothing of its last
    request."""
    _, _, _, JE = _jax()
    cfg, jm, jp, step, tm, tp = pair(arch, 1)
    prompts = _prompts(cfg, (5, 3, 8, 4, 6, 2), seed=4)
    solo = [_run_ref(JE, jm, jp, step, [p], slots=1, max_new=6)[0]
            for p in prompts]
    got = _run_port(tm, tp, prompts, slots=1 if cfg.n_experts else 2,
                    max_new=6)
    assert got == solo
    assert all(len(o) == 6 for o in got)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b",
                                  "seamless-m4t-medium"])
def test_reused_slot_starts_from_a_fresh_cache(arch):
    """After a request, its slot's recurrent states (conv, h) or cross
    keys and values are what ``init_cache`` gives again at the next
    admission, and the next request gets its solo tokens."""
    cfg = TCFG.smoke(arch)
    tm = build_model(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(2))
    if cfg.is_encdec:     # live cross keys, as a prefill with frames leaves
        tp_x = tm.prefill(tp, {"tokens": np.zeros((1, 3), np.int64),
                               "enc_frames": torch.randn(
                                   1, cfg.frontend_seq, cfg.d_model)},
                          max_len=32)[0]
    prompts = _prompts(cfg, (6, 4), seed=7)
    eng = Engine(tm, tp, batch_slots=1, max_len=32)
    first = Request(rid=0, prompt=prompts[0], max_new=5)
    eng.run([first])
    if cfg.is_encdec:
        for c, x in zip(eng.cache, tp_x):
            c["xk"].copy_(x["xk"])
            c["xv"].copy_(x["xv"])
    states = [t for c in eng.cache for t in _leaves(c)]
    assert any(bool(t.any()) for t in states)
    eng._reset_slot(0)
    fresh = [t for c in tm.init_cache(1, 32) for t in _leaves(c)]
    assert all(torch.equal(a, b) for a, b in zip(states, fresh))
    second = Request(rid=1, prompt=prompts[1], max_new=5)
    eng.run([second])
    assert second.out == _run_port(tm, tp, [prompts[1]], slots=1,
                                   max_new=5, max_len=32)[0]


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "granite-moe-3b-a800m"])
def test_moe_engine_run_repeats_token_for_token(arch):
    """Four slots, eight requests: the capacity couples the tokens of a
    step, and the same run gives the same tokens again."""
    cfg = TCFG.smoke(arch)
    tm = build_model(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(3))
    prompts = _prompts(cfg, [4 + i % 13 for i in range(8)], seed=8)
    runs = [_run_port(tm, tp, prompts, slots=4, max_new=6) for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(len(o) == 6 for o in runs[0])


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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_family_on_card_matches_cpu(arch):
    """Each new family's smoke config on the card, float32, the CPU's
    params: prefill (with frames or patches) and three decode steps
    within 1e-4 * max of the CPU's logits; the engine's requests equal
    their solo runs at the same slot count (MoE: the same run twice
    gives the same tokens)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = TCFG.smoke(arch)
    base = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    extra = rng.standard_normal((2, cfg.frontend_seq, cfg.d_model)).astype(
        np.float32)
    inputs, n_front = {}, 0
    if cfg.is_encdec:
        inputs = {"enc_frames": extra}
    elif cfg.frontend == "vision":
        inputs, n_front = {"frontend": extra}, cfg.frontend_seq
    logits = {}
    for dev in ("cpu", "cuda"):
        tm = build_model(cfg, device=dev)
        tp = copy.deepcopy(base).to(dev)
        cache, out = tm.prefill(tp, {"tokens": toks[:, :9], **inputs},
                                max_len=n_front + 16)
        outs = [out]
        for i in range(3):
            cache, out = tm.decode_step(tp, cache, toks[:, 9 + i:10 + i],
                                        np.full(2, n_front + 9 + i,
                                                np.int32))
            outs.append(out)
        logits[dev] = [o[..., :cfg.vocab].cpu().numpy() for o in outs]
        if dev == "cuda":
            prompts = _prompts(cfg, (4, 9, 14, 5))
            batched = _run_port(tm, tp, prompts, slots=2, max_new=6)
            if cfg.n_experts:
                assert _run_port(tm, tp, prompts, slots=2,
                                 max_new=6) == batched
            else:
                assert batched == [_run_port(tm, tp, [p], slots=2,
                                             max_new=6)[0] for p in prompts]
    for got, want in zip(logits["cuda"], logits["cpu"]):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (arch, err)
