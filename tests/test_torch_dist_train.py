"""The model across cards (ROADMAP 1.28) trained on the CPU: gloo
processes against the reference's 8-device mesh and against the port's
one-device step.

* The reference test's run (``tests/test_distributed_train.py``: the
  qwen2.5-14b smoke config at d_model 64, d_ff 128, 2 layers, here in
  float32; AdamW at a constant 1e-3; six batches of 8 x 32 from
  ``default_rng(0)``) runs in a JAX subprocess on its (4, 2) mesh, which
  also dumps its initial params.  Four gloo processes carry those params
  across (``convert.model_params``), lay them out on a (2, 2) (data,
  model) mesh (``train.step.shard_params``) and train on the same
  batches: the six losses within 1e-5 relative of the reference's; the
  largest master leaf ZeRO-1-sharded over both axes; the step-6 state
  saved (``checkpoint.store``).
* In the same processes, one smoke step of each of the six families
  (dense, MoE, SSM, hybrid, VLM, audio; float32) on the (2, 2) mesh from
  ``init_sharded`` against the one-device step from the same generator:
  the sharded init the one-device init bit for bit; then both given the
  same N(0, 0.02^2) noise, as ``test_torch_train_step.py`` does: loss,
  grad norm, m and sqrt(v) within 1e-5 (relative to the loss, and to
  each leaf's max); every sharded param equal to its new master cast to
  the param's dtype; and a second step's loss, which reads the params
  the first step wrote, within 1e-5 of one device's.
* Serving over the mesh: each family's prefill and one decode step on
  the (2, 2) mesh (the cache laid out by ``Model.cache_specs``) against
  one device, within 1e-4 of the logits' max.
* Elastic restore from 4 ranks to 2: two new gloo processes restore the
  step-6 checkpoint onto a (1, 2) mesh (``store.restore`` with
  ``shardings``, onto a target built on ``meta``): every leaf the saved
  one bit for bit, and one more step reaches step 7 with a finite loss
  below the first.
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
# serving's logits, relative to their max: float32 through the whole
# stack with every sum in another order (MoE adds each rank's experts'
# partial outputs over the model axis before the shared expert's);
# granite's part by 2e-5 after the noised step, the others by 1e-6
SERVE_TOL = 1e-4
FAMILIES = {"dense": "qwen2.5-14b", "moe": "granite-moe-3b-a800m",
            "ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-2b",
            "vlm": "llava-next-mistral-7b", "audio": "seamless-m4t-medium"}

_REF = textwrap.dedent("""
    import os, sys, json, pickle, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro import configs
    from repro.models.api import build_model
    from repro.models.sharding import use_rules
    from repro.train.optimizer import AdamW
    from repro.train.schedules import constant
    from repro.train.step import make_train_step, train_state_shardings
    from repro._compat import set_mesh, make_mesh

    out_dir = sys.argv[1]
    cfg = dataclasses.replace(
        configs.smoke("qwen2.5-14b"), d_model=64, d_ff=128, n_layers=2,
        param_dtype="float32", activation_dtype="float32")
    model = build_model(cfg)
    rules = {"batch": ("data",), "model": ("model",), "expert": ("model",),
             "seq": None, "kvseq": None}
    mesh = make_mesh((4, 2), ("data", "model"))
    with set_mesh(mesh), use_rules(rules):
        param_sh, opt_sh = train_state_shardings(model, mesh, rules)
        opt = AdamW(lr_fn=constant(1e-3))
        step = jax.jit(make_train_step(model, opt, q_chunk=16, k_chunk=16),
                       in_shardings=(param_sh, opt_sh, None),
                       out_shardings=(param_sh, opt_sh, None))
        params = jax.jit(model.init, out_shardings=param_sh)(
            jax.random.PRNGKey(0))
        with open(os.path.join(out_dir, "params.pkl"), "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, jax.device_get(params)), f)
        opt_state = jax.jit(opt.init, out_shardings=opt_sh)(params)
        rng = np.random.default_rng(0)
        losses = []
        for i in range(6):
            batch = {k: jnp.asarray(rng.integers(0, cfg.vocab, (8, 32)),
                                    jnp.int32) for k in ("tokens", "labels")}
            params, opt_state, metrics = step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
    print("OUT " + json.dumps({"losses": losses}))
""")

_PORT = textwrap.dedent("""
    import os, sys, json, pickle, dataclasses
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch import configs, convert
    from repro_torch.checkpoint import store
    from repro_torch.launch import mesh as LM
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import AdamW, trainable
    from repro_torch.train.schedules import constant
    from repro_torch.train import step as ST

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    work, mode = sys.argv[1], sys.argv[2]
    LM.join("cpu", rank=rank, world=world,
            store=dist.FileStore(os.path.join(work, "store_" + mode), world))
    torch.use_deterministic_algorithms(True)
    RULES = {"batch": ("data",), "model": ("model",), "expert": ("model",),
             "seq": None, "kvseq": None}
    out = {}

    def f32(cfg, **kw):
        return dataclasses.replace(cfg, param_dtype="float32",
                                   activation_dtype="float32", **kw)

    def full(t):
        return t.full_tensor() if S.is_dtensor(t) else t

    def ref_batches(cfg, n=6):
        rng = np.random.default_rng(0)
        return [{k: torch.as_tensor(rng.integers(0, cfg.vocab, (8, 32)))
                 for k in ("tokens", "labels")} for _ in range(n)]

    cfg = f32(configs.smoke("qwen2.5-14b"), d_model=64, d_ff=128, n_layers=2)
    model = build_model(cfg, device="cpu")
    opt = AdamW(lr_fn=constant(1e-3))

    if mode == "train":
        mesh = LM.make_mesh((2, 2), ("data", "model"))
        with S.use_rules(RULES):
            _, opt_sh = ST.train_state_shardings(model, mesh, RULES)
            with open(os.path.join(work, "params.pkl"), "rb") as fh:
                params = convert.model_params(pickle.load(fh), cfg, "cpu")
            params = ST.shard_params(params, mesh, RULES,
                                     model.param_specs())
            state = opt.init(params, shardings=opt_sh)
            step = ST.make_train_step(model, opt, q_chunk=16, k_chunk=16)
            losses = []
            for b in ref_batches(cfg):
                params, state, m = step(params, state, b)
                losses.append(float(m["loss"]))
            out["losses"] = losses
            # the collectives of one optimizer update
            from repro_torch.launch.comm_analysis import StepRecorder
            loss, _ = model.loss(params, ST.place_batch(
                ref_batches(cfg, 7)[-1], mesh), q_chunk=16, k_chunk=16)
            with S.sharded_region(params):
                loss.backward()
            named = trainable(params)
            with StepRecorder() as rec:
                opt.update({n: named[n].grad for n in state.master},
                           state._replace(), params)
            for p_ in named.values():
                p_.grad = None
            ops = [c["op"] for c in rec.collectives]
            out["update_collectives"] = {o: ops.count(o) for o in set(ops)}
            out["zero1_leaves"] = sum(
                any(type(q).__name__ == "Shard" and i == 0
                    for i, q in enumerate(pl))
                for pl in opt_sh.master.values())
            big = max(state.master.items(), key=lambda kv: kv[1].numel())
            out["big_master"] = [big[0], [type(p).__name__ for p in
                                          big[1].placements],
                                 big[1].numel(), big[1].to_local().numel()]
            store.save(os.path.join(work, "ckpt"), 6, (params, state),
                       extra={"losses": losses},
                       spec_tree=model.param_specs())
        # one step of each family: the sharded model against one device
        fam = {}
        for role, arch in json.loads(sys.argv[3]).items():
            c = f32(configs.smoke(arch))
            m_ = build_model(c, device="cpu")
            rng = np.random.default_rng(1)
            b = {"tokens": torch.as_tensor(rng.integers(0, c.vocab, (4, 16))),
                 "labels": torch.as_tensor(rng.integers(0, c.vocab, (4, 16)))}
            if c.frontend == "vision":
                b["frontend"] = torch.as_tensor(rng.standard_normal(
                    (4, c.frontend_seq, c.d_model)).astype(np.float32))
            if c.is_encdec:
                b["enc_frames"] = torch.as_tensor(rng.standard_normal(
                    (4, 16, c.d_model)).astype(np.float32))
            o = AdamW(lr_fn=constant(1e-3))

            def noised(params):
                # N(0, 0.02^2) on every leaf, the same full draw on every
                # rank: no zero-init leaf, whose first Adam step would turn
                # float32 rounding of a near-zero gradient into an lr-sized
                # move (tests/test_torch_train_step.py)
                g = torch.Generator().manual_seed(1)
                with torch.no_grad():
                    for p in params.parameters():
                        z = 0.02 * torch.randn(p.shape, generator=g)
                        if S.is_dtensor(p):
                            z = S.place(z, p.device_mesh, p.placements)
                        p.add_(z)
                return params

            p1 = noised(m_.init(torch.Generator().manual_seed(0)))
            s1 = o.init(p1)
            step1 = ST.make_train_step(m_, o, q_chunk=8, k_chunk=8)
            _, s1, m1 = step1(p1, s1, b)
            with S.use_rules(RULES):
                _, osh = ST.train_state_shardings(m_, mesh, RULES)
                p2 = ST.init_sharded(m_, torch.Generator().manual_seed(0),
                                     mesh, RULES)
                same_init = all(
                    torch.equal(full(a), b_) for a, b_ in zip(
                        p2.parameters(),
                        m_.init(torch.Generator().manual_seed(0)
                                ).parameters()))
                s2 = o.init(noised(p2), shardings=osh)
                step2 = ST.make_train_step(m_, o, q_chunk=8, k_chunk=8)
                _, s2, m2 = step2(p2, s2, b)
            t1, t2 = trainable(p1), trainable(p2)
            # the update's write-back: each sharded param is its new
            # master cast, gathered from the ranks' ZeRO-1 shards (exact)
            wrote = all(torch.equal(full(t2[n]),
                                    full(s2.master[n]).to(t2[n].dtype))
                        for n in s2.master)

            def rel(a, b):      # max|a - b| over max|b|, by leaf
                return max(float((full(a[n]) - b[n]).abs().max())
                           / max(float(b[n].abs().max()), 1e-30) for n in b)
            perr = rel(t2, t1)
            # sqrt(v): v is the squared gradient, whose relative error
            # is twice the gradient's
            merr = rel(s2.m, s1.m)
            verr = rel({n: v.sqrt() for n, v in s2.v.items()},
                       {n: v.sqrt() for n, v in s1.v.items()})
            # an element's move lr * g / (|g| + eps): the largest change
            # a gradient's rounding can make, over lr
            moved = max(float((full(t2[n]) - t1[n]).abs().max())
                        for n in t1) / 1e-3
            # prefill of 8 tokens and one decode step, sharded against
            # one device (the cache laid out as cache_specs says)
            pb = {k: v[:, :8] if k in ("tokens",) else v
                  for k, v in b.items() if k != "labels"}
            off = c.frontend_seq if c.frontend == "vision" else 0
            pos = torch.full((4,), 8 + off, dtype=torch.int32)
            with torch.no_grad():
                c1, l1 = m_.prefill(p1, pb, max_len=32, q_chunk=4,
                                    k_chunk=4)
                _, d1 = m_.decode_step(p1, c1, b["tokens"][:, 8:9], pos)
                with S.use_rules(RULES):
                    c2, l2 = m_.prefill(p2, ST.place_batch(pb, mesh),
                                        max_len=32, q_chunk=4, k_chunk=4)
                    S.lay_out_cache(c2, m_.cache_specs(), mesh)
                    t2 = ST.place_batch({"t": b["tokens"][:, 8:9],
                                         "p": pos}, mesh)
                    _, d2 = m_.decode_step(p2, c2, t2["t"], t2["p"])
            serve_err = max(
                float((full(l2) - l1).abs().max() / l1.abs().max()),
                float((full(d2) - d1).abs().max() / d1.abs().max()))
            # a second step on the same batch: its loss reads the params
            # the first step wrote
            _, s1, n1 = step1(p1, s1, b)
            with S.use_rules(RULES):
                _, s2, n2 = step2(p2, s2, b)
            fam[role] = {"loss": [float(m1["loss"]), float(m2["loss"])],
                         "loss2": [float(n1["loss"]), float(n2["loss"])],
                         "param_is_master": wrote,
                         "serve_err": serve_err,
                         "param_err": perr, "same_init": same_init,
                         "m_err": merr, "v_err": verr,
                         "param_move_over_lr": moved,
                         "grad_norm": [float(m1["grad_norm"]),
                                       float(m2["grad_norm"])]}
        out["families"] = fam
    else:   # elastic: restore the 4-rank checkpoint onto 2 ranks
        mesh = LM.make_mesh((1, 2), ("data", "model"))
        ck = os.path.join(work, "ckpt")
        with S.use_rules(RULES):
            psh, osh = ST.train_state_shardings(model, mesh, RULES)
            shapes = model.param_shapes()
            target = (shapes, opt.init(shapes))
            (params, state), extra = store.restore(ck, 6, target,
                                                   shardings=(psh, osh),
                                                   mesh=mesh)
            man = store.manifest(ck, 6)
            metas = {m["name"]: m for m in man["leaves"]}
            bits = True
            for name, t in store.leaves((params, state)):
                want = store.load_leaf(ck, 6, metas[name])
                bits &= bool(torch.equal(full(t).to(want.dtype), want)) \\
                    and S.is_dtensor(t) == (t.dim() > 0)
            out["bits"] = bits
            out["specs_saved"] = man["specs"] is not None
            out["restored_step"] = int(state.step)
            b = ref_batches(cfg, 7)[-1]     # the reference test's next batch
            params, state, m = ST.make_train_step(
                model, opt, q_chunk=16, k_chunk=16)(params, state, b)
            out["resumed_step"] = int(state.step)
            out["resumed_loss"] = float(m["loss"])
            out["first_loss"] = extra["losses"][0]
    if rank == 0:
        print("OUT " + json.dumps(out), flush=True)
    dist.destroy_process_group()
""")


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _spawn(world: int, args, timeout=600) -> dict:
    """``_PORT`` in ``world`` processes; rank 0's record."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PORT, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(_env(), RANK=str(r), WORLD_SIZE=str(world)))
        for r in range(world)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-4000:]
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("OUT ")]
    return json.loads(line[-1][4:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dist_train"))
    env = dict(_env(), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, work],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    ref = json.loads([ln for ln in r.stdout.splitlines()
                      if ln.startswith("OUT ")][-1][4:])
    train = _spawn(4, [work, "train", json.dumps(FAMILIES)])
    elastic = _spawn(2, [work, "elastic"])
    return ref, train, elastic


def test_losses_match_reference_mesh(runs):
    ref, train, _ = runs
    assert len(train["losses"]) == 6
    for a, b in zip(train["losses"], ref["losses"]):
        assert abs(a - b) <= TOL * abs(b), (train["losses"], ref["losses"])
    assert train["losses"][-1] < train["losses"][0]


def test_zero1_update_reduce_scatters_and_all_gathers(runs):
    """ZeRO-1's update: a reduce-scatter of each gradient onto its
    data-sharded state and one all-gather of each new param, not an
    all-reduce plus a slice (a gradient also partial over the model
    axis adds its reduction there)."""
    _, train, _ = runs
    got, n = train["update_collectives"], train["zero1_leaves"]
    assert n > 0
    assert got.get("all-gather") == n, (got, n)
    assert got.get("reduce-scatter", 0) >= n, (got, n)


def test_zero1_master_sharded_over_both_axes(runs):
    _, train, _ = runs
    name, placements, numel, local = train["big_master"]
    assert placements == ["Shard", "Shard"], (name, placements)
    assert local * 4 == numel, (name, local, numel)


@pytest.mark.parametrize("role", list(FAMILIES))
def test_family_step_matches_one_device(runs, role):
    _, train, _ = runs
    f = train["families"][role]
    one, sharded = f["loss"]
    assert abs(one - sharded) <= TOL * abs(one), f
    assert abs(f["grad_norm"][0] - f["grad_norm"][1]) <= \
        TOL * abs(f["grad_norm"][0]), f
    assert f["m_err"] <= TOL and f["v_err"] <= TOL, f
    assert f["same_init"], f
    assert f["param_is_master"], f
    one2, sharded2 = f["loss2"]
    assert abs(one2 - sharded2) <= TOL * abs(one2), f


@pytest.mark.parametrize("role", list(FAMILIES))
def test_family_prefill_and_decode_match_one_device(runs, role):
    """Serving over the (2, 2) mesh: the prefill's last logits and one
    decode step's, on a cache laid out by ``cache_specs``, within
    SERVE_TOL of one device's (relative to their max)."""
    _, train, _ = runs
    f = train["families"][role]
    assert f["serve_err"] <= SERVE_TOL, f


def test_elastic_restore_from_four_ranks_to_two(runs):
    _, train, el = runs
    assert el["bits"] and el["specs_saved"]
    assert el["restored_step"] == 6
    assert el["resumed_step"] == 7
    import math
    assert math.isfinite(el["resumed_loss"])
    assert el["resumed_loss"] < el["first_loss"] == train["losses"][0]


_CARD = textwrap.dedent("""
    import dataclasses, json, os, sys, tempfile
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as LM
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedules import constant
    from repro_torch.train import step as ST
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.smoke("qwen2.5-14b"),
                              param_dtype="float32",
                              activation_dtype="float32")
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    bs = [{k: torch.as_tensor(rng.integers(0, cfg.vocab, (4, 32))).cuda()
           for k in ("tokens", "labels")} for _ in range(3)]
    out = {}
    for sharded in (False, True):
        opt = AdamW(lr_fn=constant(1e-3))
        gen = torch.Generator(device="cuda").manual_seed(0)
        if sharded:
            LM.join(rank=0, world=1, store=dist.FileStore(
                os.path.join(tempfile.mkdtemp(), "s"), 1))
            mesh = LM.make_mesh((1, 1), ("data", "model"))
            rules = dict(S.DEFAULT_SINGLE_POD)
            ctx = S.use_rules(rules)
            ctx.__enter__()
            _, osh = ST.train_state_shardings(model, mesh, rules)
            p = ST.init_sharded(model, gen, mesh, rules)
            s = opt.init(p, shardings=osh)
        else:
            p = model.init(gen)
            s = opt.init(p)
        step = ST.make_train_step(model, opt, q_chunk=16, k_chunk=16)
        losses = []
        for b in bs:
            p, s, m = step(p, s, b)
            losses.append(float(m["loss"]))
        out[str(sharded)] = losses
    LM.leave()
    print("OUT " + json.dumps(out))
""")


@pytest.mark.cuda
def test_sharded_step_on_one_card_matches_unsharded():
    """On the card: three steps of the sharded model on a one-rank NCCL
    (1, 1) mesh against the unsharded model's, bit for bit (the same
    operations on the same card)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "-c", _CARD], capture_output=True,
                       text=True, env=_env(), timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads([ln for ln in r.stdout.splitlines()
                      if ln.startswith("OUT ")][-1][4:])
    assert out["True"] == out["False"], out
