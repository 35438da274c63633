"""Sharded serving over several decode steps on the CPU: four gloo
processes on a (2, 2) (data, model) mesh against the same model on one
device, in float32.

* The batch layout (``rules_for("decode", 4, ...)``: the batch on
  ``data``, heads, head dim or channels on ``model``), the one the
  reference's decode_32k cells run, for each of the six families and
  for an expert-parallel MoE (16 experts, so that ``expert`` splits
  them): a batch of 4 prefills 8 tokens, then 8 decode steps, each
  fed the next token of the prompt.
* The context-parallel layout (``rules_for("decode", 1, ...)``: the KV
  cache's sequence dim on ``data``), the one of long_500k, for the two
  recurrent configs of that shape, falcon-mamba-7b and
  recurrentgemma-2b: a batch of one prefills 8 tokens and decodes 10,
  so recurrentgemma's window-16 ring wraps.

Each cache is laid out by ``Model.cache_specs()`` after the prefill
(``sharding.lay_out_cache``), as the four-card script does.  Held, as
``tests/test_torch_dist_train.py`` holds one step: every step's logits
within TOL of the one-device logits' max (SERVE_TOL for the MoE, whose
partial expert outputs meet in another order), and after the last step
every cache and state leaf within the same bound of its max, positions
and insertion counters equal.  A state written past its cache (a bare
``copy_`` into a DTensor of other placements) shows from the second
step on.

The recurrent cases (falcon-mamba-7b and recurrentgemma-2b, both
layouts) are also held against the reference: a JAX subprocess builds
each config's params (``PRNGKey(3)``) and runs its prefill and the same
decode steps on one device; the gloo ranks carry those params across
(``convert.model_params``), lay them out (``train.step.shard_params``)
and decode sharded: every call's logits within LOGIT_TOL of the
reference's max, the bound ``tests/test_torch_models.py`` holds the
unsharded port to.
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
SERVE_TOL = 1e-4        # tests/test_torch_dist_train.py, for the MoE
BATCH = {"dense": "qwen2.5-14b", "moe": "granite-moe-3b-a800m",
         "moe_ep": "deepseek-moe-16b", "ssm": "falcon-mamba-7b",
         "hybrid": "recurrentgemma-2b", "vlm": "llava-next-mistral-7b",
         "audio": "seamless-m4t-medium"}
CP = {"ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-2b"}
CASES = [("batch", r, a) for r, a in BATCH.items()] + \
    [("cp", r, a) for r, a in CP.items()]
LOGIT_TOL = 1e-4        # tests/test_torch_models.py, against the reference
REF_CASES = [(lay, r, a) for lay, r, a in CASES if r in CP]


_REF = textwrap.dedent("""
    import dataclasses, json, os, pickle, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro import configs
    from repro.models.api import build_model

    work, cases, prompt = sys.argv[1], json.loads(sys.argv[2]), 8
    built = {}
    for layout, role, arch in cases:
        cfg = dataclasses.replace(configs.smoke(arch),
                                  param_dtype="float32",
                                  activation_dtype="float32")
        if arch not in built:
            m = build_model(cfg)
            built[arch] = (m, m.init(jax.random.PRNGKey(3)))
            with open(os.path.join(work, arch + ".pkl"), "wb") as f:
                pickle.dump(jax.tree.map(np.asarray,
                                         jax.device_get(built[arch][1])), f)
        m, p = built[arch]
        b, steps = (4, 8) if layout == "batch" else (1, 10)
        toks = np.random.default_rng(5).integers(
            0, cfg.vocab, (b, prompt + steps)).astype(np.int32)
        cache, lg = jax.jit(lambda p, t: m.prefill(
            p, {"tokens": t}, max_len=24, q_chunk=4, k_chunk=4))(
            p, jnp.asarray(toks[:, :prompt]))
        out = [np.asarray(lg)]
        step = jax.jit(m.decode_step)
        for t in range(prompt, prompt + steps):
            cache, lg = step(p, cache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(np.full(b, t, np.int32)))
            out.append(np.asarray(lg))
        np.savez(os.path.join(work, f"ref_{layout}_{role}.npz"), *out)
""")

_RANK = textwrap.dedent("""
    import dataclasses, json, os, pickle, sys
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

    def full(t):
        return t.full_tensor() if S.is_dtensor(t) else t

    def leaves(tree, pre=""):
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        for k, v in items:
            if isinstance(v, (dict, list)):
                yield from leaves(v, f"{pre}{k}.")
            else:
                yield f"{pre}{k}", v

    out = {}
    for layout, role, arch in json.loads(sys.argv[2]):
        cfg = dataclasses.replace(configs.smoke(arch),
                                  param_dtype="float32",
                                  activation_dtype="float32")
        if role == "moe_ep":
            cfg = dataclasses.replace(cfg, n_experts=16)
        b, steps = (4, 8) if layout == "batch" else (1, 10)
        rules = S.rules_for("decode", b, {"data": 2, "model": 2})
        m = build_model(cfg, device="cpu")
        rng = np.random.default_rng(5)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, 8 + steps)))
        pb = {"tokens": toks[:, :8]}
        if cfg.frontend == "vision":
            pb["frontend"] = torch.as_tensor(rng.standard_normal(
                (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32))
        if cfg.is_encdec:
            pb["enc_frames"] = torch.as_tensor(rng.standard_normal(
                (b, 12, cfg.d_model)).astype(np.float32))
        off = cfg.frontend_seq if cfg.frontend == "vision" else 0
        max_len = 24 + off
        p1 = m.init(torch.Generator().manual_seed(0))
        with S.use_rules(rules):
            p2 = ST.init_sharded(m, torch.Generator().manual_seed(0), mesh,
                                 rules)
        errs = []
        with torch.no_grad():
            c1, l1 = m.prefill(p1, pb, max_len=max_len, q_chunk=4,
                               k_chunk=4)
            with S.use_rules(rules):
                c2, l2 = m.prefill(p2, ST.place_batch(pb, mesh),
                                   max_len=max_len, q_chunk=4, k_chunk=4)
                S.lay_out_cache(c2, m.cache_specs(), mesh)
                placed = {n: [str(p) for p in v.placements]
                          for n, v in leaves(c2)}
            v = cfg.vocab
            errs.append(float((full(l2) - l1)[..., :v].abs().max()
                              / l1[..., :v].abs().max()))
            for t in range(8, 8 + steps):
                pos = torch.full((b,), t + off, dtype=torch.int32)
                _, d1 = m.decode_step(p1, c1, toks[:, t:t + 1], pos)
                with S.use_rules(rules):
                    x = ST.place_batch({"t": toks[:, t:t + 1], "p": pos},
                                       mesh)
                    _, d2 = m.decode_step(p2, c2, x["t"], x["p"])
                errs.append(float((full(d2) - d1)[..., :v].abs().max()
                                  / d1[..., :v].abs().max()))
        cache = {}
        want = dict(leaves(c1))
        for n, t in leaves(c2):
            got = full(t)
            if got.is_floating_point():
                cache[n] = float((got - want[n]).abs().max()
                                 / max(float(want[n].abs().max()), 1e-30))
            else:
                cache[n] = bool(torch.equal(got, want[n]))
        out[f"{layout}:{role}"] = {
            "logit_errs": errs, "cache": cache, "placements": placed,
            "rules": {k: list(v) if v else None for k, v in rules.items()}}
    from repro_torch import convert
    for layout, role, arch in json.loads(sys.argv[3]):
        cfg = dataclasses.replace(configs.smoke(arch),
                                  param_dtype="float32",
                                  activation_dtype="float32")
        b, steps = (4, 8) if layout == "batch" else (1, 10)
        rules = S.rules_for("decode", b, {"data": 2, "model": 2})
        m = build_model(cfg, device="cpu")
        toks = torch.as_tensor(np.random.default_rng(5).integers(
            0, cfg.vocab, (b, 8 + steps)))
        with open(os.path.join(work, arch + ".pkl"), "rb") as f:
            p = convert.model_params(pickle.load(f), cfg, "cpu")
        got = []
        with torch.no_grad(), S.use_rules(rules):
            p = ST.shard_params(p, mesh, rules, m.param_specs())
            c, lg = m.prefill(p, ST.place_batch({"tokens": toks[:, :8]},
                                                mesh),
                              max_len=24, q_chunk=4, k_chunk=4)
            S.lay_out_cache(c, m.cache_specs(), mesh)
            got.append(full(lg).numpy())
            for t in range(8, 8 + steps):
                x = ST.place_batch({"t": toks[:, t:t + 1], "p": torch.full(
                    (b,), t, dtype=torch.int32)}, mesh)
                _, lg = m.decode_step(p, c, x["t"], x["p"])
                got.append(full(lg).numpy())
        if rank == 0:
            np.savez(os.path.join(work, f"port_{layout}_{role}.npz"), *got)
    if rank == 0:
        print("OUT " + json.dumps(out), flush=True)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_serve"))


@pytest.fixture(scope="module")
def run(work):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF, work,
                        json.dumps(REF_CASES)], capture_output=True,
                       text=True, env=dict(env, JAX_PLATFORMS="cpu"),
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, work, json.dumps(CASES),
         json.dumps(REF_CASES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(env, RANK=str(r), WORLD_SIZE="4")) for r in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, e) in zip(procs, outs):
        assert p.returncode == 0, e[-4000:]
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("OUT ")]
    return json.loads(line[-1][4:])


def _tol(role):
    return SERVE_TOL if role.startswith("moe") else TOL


@pytest.mark.parametrize("layout,role,arch", CASES)
def test_decode_steps_match_one_device(run, layout, role, arch):
    """The prefill's logits and every decode step's."""
    r = run[f"{layout}:{role}"]
    errs = r["logit_errs"]
    assert len(errs) == 1 + (8 if layout == "batch" else 10)
    assert max(errs) <= _tol(role), errs


@pytest.mark.parametrize("layout,role,arch", CASES)
def test_final_cache_matches_one_device(run, layout, role, arch):
    """Every leaf of the cache after the last step: k / v / states
    within the bound, positions and counters equal."""
    r = run[f"{layout}:{role}"]
    assert r["cache"]
    for name, e in r["cache"].items():
        if isinstance(e, bool):
            assert e, name
        else:
            assert e <= _tol(role), (name, e)


def test_batch_layout_splits_the_batch_over_data(run):
    for role in BATCH:
        r = run[f"batch:{role}"]
        assert r["rules"]["batch"] == ["data"], r["rules"]
        assert r["rules"]["kvseq"] is None, r["rules"]
        for name, pl in r["placements"].items():
            assert pl[0] == "S(0)", (role, name, pl)


def test_context_parallel_state_placements(run):
    """Under the kvseq rules the batch is not split: a Mamba or RG-LRU
    state keeps only its channel split on ``model``, as
    ``mamba_cache_specs`` / ``rglru_cache_specs`` resolve; the hybrid's
    local ring splits its sequence over ``data``."""
    ssm, hyb = run["cp:ssm"], run["cp:hybrid"]
    assert ssm["rules"]["batch"] is None
    assert ssm["rules"]["kvseq"] == ["data"]
    for n, pl in ssm["placements"].items():
        want = ["R", "S(2)"] if n.endswith("conv") else ["R", "S(1)"]
        assert pl == want, (n, pl)
    pl = hyb["placements"]
    assert pl["0.conv"] == ["R", "S(2)"] and pl["0.h"] == ["R", "S(1)"], pl
    assert pl["2.k"] == ["S(1)", "S(3)"], pl
    assert pl["2.pos"] == ["S(1)", "R"], pl


@pytest.mark.parametrize("layout,role,arch", REF_CASES)
def test_sharded_decode_matches_reference(run, work, layout, role, arch):
    """The recurrent configs' sharded prefill and every decode step
    against the reference's on one device, from the same params."""
    import numpy as np

    from repro_torch import configs
    vocab = configs.smoke(arch).vocab
    b, steps = (4, 8) if layout == "batch" else (1, 10)
    got = np.load(os.path.join(work, f"port_{layout}_{role}.npz"))
    want = np.load(os.path.join(work, f"ref_{layout}_{role}.npz"))
    assert len(got.files) == len(want.files) == 1 + steps
    for i, k in enumerate(want.files):
        g, w = got[k][..., :vocab], want[k][..., :vocab]
        assert g.shape == w.shape and g.shape[0] == b, (i, g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= LOGIT_TOL * float(np.abs(w).max()), (i, err)
