"""Decode over a sharded cache on the CPU: four gloo processes on a
(2, 2) (data, model) mesh with the context-parallel rules that
``rules_for`` gives a decode batch of one (the cache's sequence dim on
``data``, its head dim on ``model`` as ``attn_cache_specs`` lays out two
kv heads), against the same model on one device.

Each smoke config (float32) prefills 8 tokens into a cache of 24 slots
and decodes 10 more, so the ring writes of the global layers cross from
the first data rank's half of the cache to the second's, and a
window-16 local layer's wrap back to slot 0 does too.  Held: every
step's logits within TOL of the one-device logits' max, and the final
cache (k, v, positions, insertion counters) against one device's:
positions and counters equal, k and v within TOL of their max.
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
ARCHS = ["qwen2.5-14b", "gemma3-4b"]

_RANK = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as LM
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    from repro_torch.train import step as ST

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    work = sys.argv[1]
    LM.join("cpu", rank=rank, world=world,
            store=dist.FileStore(os.path.join(work, "store"), world))
    mesh = LM.make_mesh((2, 2), ("data", "model"))
    rules = S.rules_for("decode", 1, {"data": 2, "model": 2})
    assert rules["kvseq"] == ("data",) and rules["batch"] is None

    def full(t):
        return t.full_tensor() if S.is_dtensor(t) else t

    def leaves(cache):
        for i, layer in enumerate(cache):
            for k, v in layer.items():
                yield f"{i}.{k}", v

    out = {}
    for arch in json.loads(sys.argv[2]):
        cfg = dataclasses.replace(configs.smoke(arch),
                                  param_dtype="float32",
                                  activation_dtype="float32")
        m = build_model(cfg, device="cpu")
        rng = np.random.default_rng(3)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 18)))
        p1 = m.init(torch.Generator().manual_seed(0))
        with S.use_rules(rules):
            p2 = ST.init_sharded(m, torch.Generator().manual_seed(0), mesh,
                                 rules)
        errs, placed = [], None
        with torch.no_grad():
            c1, _ = m.prefill(p1, {"tokens": toks[:, :8]}, max_len=24,
                              q_chunk=4, k_chunk=4)
            with S.use_rules(rules):
                c2, _ = m.prefill(p2, ST.place_batch(
                    {"tokens": toks[:, :8]}, mesh), max_len=24, q_chunk=4,
                    k_chunk=4)
                S.lay_out_cache(c2, m.cache_specs(), mesh)
                placed = {n: [str(p) for p in v.placements]
                          for n, v in leaves(c2)}
            for t in range(8, 18):
                pos = torch.full((1,), t, dtype=torch.int32)
                _, d1 = m.decode_step(p1, c1, toks[:, t:t + 1], pos)
                with S.use_rules(rules):
                    b = ST.place_batch({"t": toks[:, t:t + 1], "p": pos},
                                       mesh)
                    _, d2 = m.decode_step(p2, c2, b["t"], b["p"])
                errs.append(float((full(d2) - d1).abs().max()
                                  / d1.abs().max()))
        cache = {}
        want = dict(leaves(c1))
        for n, v in leaves(c2):
            got = full(v)
            if got.is_floating_point():
                cache[n] = float((got - want[n]).abs().max()
                                 / want[n].abs().max())
            else:
                cache[n] = bool(torch.equal(got, want[n]))
        out[arch] = {"logit_errs": errs, "cache": cache,
                     "placements": placed}
    if rank == 0:
        print("OUT " + json.dumps(out), flush=True)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sharded_decode"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, work, json.dumps(ARCHS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(env, RANK=str(r), WORLD_SIZE="4")) for r in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, e) in zip(procs, outs):
        assert p.returncode == 0, e[-4000:]
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("OUT ")]
    return json.loads(line[-1][4:])


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_is_split_over_sequence_and_head_dim(run, arch):
    pl = run[arch]["placements"]
    assert pl["0.k"] == ["S(1)", "S(3)"], pl
    assert pl["0.pos"] == ["S(1)", "R"], pl


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_one_device(run, arch):
    errs = run[arch]["logit_errs"]
    assert len(errs) == 10
    assert max(errs) <= TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_writes_match_one_device(run, arch):
    for name, e in run[arch]["cache"].items():
        if isinstance(e, bool):
            assert e, name
        else:
            assert e <= TOL, (name, e)
