#!/usr/bin/env python3
"""Train the port's models across four cards: the model across cards
(ROADMAP 1.28) -- DTensor params over a (data, model) DeviceMesh,
ZeRO-1, elastic restore -- one process and one card per rank.

    python3 dist_train.py                              # 4 ranks, 4 cards
    python3 dist_train.py --backend gloo --smoke       # 4 CPU processes

Phases (published configs at full width and depth unless said):

``dist_train:qwen2.5-14b:tp4``  qwen2.5-14b on a (1, 4) (data, model)
    mesh, batch 8 x 256, 6 steps of WSD at 3e-4 (the start of a
    2000-step schedule, in its warmup: ``LR_HORIZON``).  Per rank: ms a step
    (host clock around a step ending in the loss read), tokens/s, MFU
    (6 N T plus the attention's flops, against 4 x 989 TF/s), the flops
    the rank ran in one step (``comm_analysis.StepRecorder``, remat and
    replicated work included), peak memory, the bytes of params and
    optimizer state held against the layout's prediction (each leaf's
    numel over the ranks that split it), and one step's collectives
    (counts and bytes by op, ``collective_bytes``); rank 0 also traces
    one step with ``torch.profiler`` (device ms, idle share, kernels).
    Losses finite, the mean of the last two below the first.
``dist_train:falcon-mamba-7b:tp4``  falcon-mamba-7b (7.3 B parameters,
    about 116 GB of training state at 16 B a parameter: only across
    cards) on (1, 4), channels on ``model``, batch 8 x 256, 4 steps of
    the same WSD start; the same numbers as the qwen2.5-14b phase, and
    the recorded step's all-gathers as (bytes, count) pairs
    (``all_gather_sizes``): which weights or activations the step
    gathers at full ``d_inner``.
``dist_train:gemma3-4b:2x2``  gemma3-4b on (2, 2), ZeRO-1: every master
    leaf's local numel is the one-device numel over the ranks its state
    spec splits it (``zero1_specs``): /4 where the data axis found a free
    dim beside a model-sharded one; 4 steps, and one step's collectives
    (the reduce-scatters and all-gathers of ZeRO-1).
``dist_train:elastic``  gemma3-4b cut to one period of its pattern (6
    layers): 3 steps on (2, 2), a checkpoint, then restored onto (4, 1)
    in the same four processes and onto a 2-rank (2, 1) mesh in two new
    processes on two of the cards: every leaf equals the saved one bit
    for bit, the step counter is 3, one more step reaches step 4 with a
    finite loss.
``dist_train:launch:host``  ``launch.train.main(["--arch", "minicpm-2b",
    "--mesh", "host", "--steps", "4"])`` on every rank: data parallelism
    with ZeRO-1 over ``data`` at minicpm-2b's full width.
``dist_train:parity``  qwen2.5-14b's width cut to 2 layers, float32,
    TF32 off: one step on the (2, 2) mesh against the same step on rank
    0's card alone, loss, grad norm and every leaf's m and sqrt(v) within
    1e-5 (as ``tests/test_torch_dist_train.py`` holds them; v itself is
    reported); and a row of falcon-mamba-7b's width at 2 layers on
    (1, 4) in float64 (``PARITY_F64``), held the same way.

Rank processes start with ``torch.multiprocessing`` (spawn) and meet
through a ``FileStore`` in a temporary directory; the script waits at
most ``--timeout`` seconds and ends any rank still running.  Prints one
JSON line per phase, ``nvidia-smi``'s name and power limit, and last
``{"ok": true, ...}``; exits non-zero if a check fails, a rank fails, or
fewer than four cards are present for NCCL.  ``--backend gloo --smoke``
rehearses every phase on the CPU with the families' smoke configs at
batch 4 x 32, qwen2.5-14b 3 steps and gemma3-4b 2 (its times are
host-clock and name no device).
"""
from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
RANKS = 4
BF16_FLOPS = 989e12         # H100 SXM, bf16 dense on the tensor cores
PARITY_TOL = 1e-5
# the schedule's horizon.  Adam's first steps move every element of a
# weight by about lr, whatever its gradient, so an (n x n) matrix's update
# has a spectral norm of about lr * n: from a random init at full width
# that spikes the loss (qwen2.5-14b at d_model 5120 on four H100s: 12.97
# -> 31.7 after one step at 3e-4, -> 20.5 after one at 3e-5; gemma3-4b at
# 2560 fell 12.92 -> 10.14 at 3e-5).  The reference spikes the same way:
# ``tests/test_torch_lr_witness.py``, run as a script, trains qwen2.5-14b's
# width at 2 layers (f32) with the launcher's WSD at 3e-4 in both packages
# and reads 9.866 -> 30.547 -> 20.427 in each.  A phase of a few steps runs
# the start of a 2000-step WSD: a 200-step warmup, lr 1.5e-6 to 9e-6 over
# six steps
LR_HORIZON = 2000
# the parity rows' dtypes.  float32 with TF32 off; the Mamba row in
# float64, since two valid f32 summation orders part a Mamba model's
# logits and moments by more than PARITY_TOL (falcon-mamba-7b's width at
# 2 layers, one card against the CPU: 1.08e-5 logits, 1.33e-5 m;
# ``experiments/f32_floor.py``), so an f32 row could not tell a layout
# fault from rounding.  In float64 only the sums the model keeps in
# float32 (the scan's state, dt, the unembedding's logits) stay at f32
PARITY_F32 = {"param_dtype": "float32", "activation_dtype": "float32"}
PARITY_F64 = {"param_dtype": "float64", "activation_dtype": "float64"}
# dist_train:parity's rows: (key, config cut to 2 layers, mesh, dtype)
PARITY_ROWS = (("parity", "qwen2.5-14b", (2, 2), PARITY_F32),
               ("parity_ssm", "falcon-mamba-7b", (1, 4), PARITY_F64))


def sync(dev) -> None:
    """Wait for ``dev``'s queue (a card's; nothing on the CPU)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev) -> None:
    """Collect garbage; on a card, return its cached blocks and restart
    its peak count."""
    import gc

    import torch
    gc.collect()
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev):
    import torch
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else None


def full(t):
    """A DTensor's whole value (gathered); a plain tensor as it is."""
    from repro_torch.models.sharding import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def local(t):
    """This rank's part of a DTensor; a plain tensor as it is."""
    from repro_torch.models.sharding import is_dtensor
    return t.to_local() if is_dtensor(t) else t


def nbytes(ts) -> int:
    """The bytes of ``ts`` this rank holds."""
    return sum(local(t).numel() * t.element_size() for t in ts)


def ways(pls, sizes) -> int:
    """How many ranks split a leaf of placements ``pls`` on a mesh of
    ``sizes``."""
    return math.prod(sizes[i] for i, q in enumerate(pls)
                     if type(q).__name__ == "Shard")


def trace(fn, dev):
    """``fn()`` under ``torch.profiler``: its result and the call's
    device ms, idle share (against the host clock around it) and
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        r = fn()
        sync(dev)
    wall = time.perf_counter() - t0
    evs = [e for e in p.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time for e in evs) / 1e3
    return r, {"wall_ms": 1e3 * wall, "device_ms": busy,
               "idle_share": max(0.0, 1 - busy / (1e3 * wall)),
               "kernels": len(evs)}


def batches(cfg, b: int, s: int, n: int, dev, seed: int = 0) -> list:
    """``n`` synthetic batches of ``b`` x ``s`` on ``dev``."""
    import torch

    from repro_torch.data.pipeline import for_config
    data = for_config(cfg, batch=b, seq=s, seed=seed)
    return [{k: torch.as_tensor(v).to(dev) for k, v in
             data.next().items()} for _ in range(n)]


def train_parity(cfg, mesh_shape, dev, rank: int, seq: int, rules: dict):
    """One step of ``cfg`` (a parity row's cut) on a ``mesh_shape``
    mesh against the same step on rank 0's device alone: loss, grad
    norm, every m and sqrt(v) within PARITY_TOL.  Returns (row, failure
    or None); the row's numbers on rank 0 only."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as LM
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    from repro_torch.train import step as ST
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedules import constant

    free(dev)
    model = build_model(cfg, device=dev)
    opt = AdamW(lr_fn=constant(1e-4))
    b = batches(cfg, 4, min(seq, 128), 1, dev, seed=1)[0]
    ref = None
    if rank == 0:       # the one-device step
        p1 = model.init(torch.Generator(device=dev).manual_seed(0))
        s1 = opt.init(p1)
        _, s1, m1 = ST.make_train_step(model, opt, q_chunk=128,
                                       k_chunk=128)(p1, s1, b)
        ref = ({k: float(v) for k, v in m1.items()},
               {n: (s1.m[n].cpu(), s1.v[n].cpu(), s1.v[n].sqrt().cpu())
                for n in s1.m})
        del p1, s1
        free(dev)
    dist.barrier()
    mesh = LM.make_mesh(mesh_shape, ("data", "model"))
    with S.use_rules(rules):
        _, osh = ST.train_state_shardings(model, mesh, rules)
        p2 = ST.init_sharded(
            model, torch.Generator(device=dev).manual_seed(0), mesh, rules)
        s2 = opt.init(p2, shardings=osh)
        _, s2, m2 = ST.make_train_step(model, opt, q_chunk=128,
                                       k_chunk=128)(p2, s2, b)
        m_full = {n: full(s2.m[n]).cpu() for n in s2.m}
        v_full = {n: full(s2.v[n]).cpu() for n in s2.v}
    rec = {"config": cfg.name, "mesh": list(mesh_shape),
           "dtype": cfg.param_dtype, "batch": 4, "seq": min(seq, 128),
           "tol": PARITY_TOL}
    fail = None
    if rank == 0:
        mets, mv = ref
        rel = {k: abs(float(m2[k]) - mets[k]) / max(abs(mets[k]), 1e-30)
               for k in ("loss", "nll", "grad_norm")}

        def leaf_rel(got, i):
            return max(float((got[n] - mv[n][i]).abs().max())
                       / max(float(mv[n][i].abs().max()), 1e-30)
                       for n in got)
        rec.update(rel_err=rel, m_max_rel_err=leaf_rel(m_full, 0),
                   v_max_rel_err=leaf_rel(v_full, 1),
                   sqrt_v_max_rel_err=leaf_rel(
                       {n: v.sqrt() for n, v in v_full.items()}, 2),
                   loss=float(m2["loss"]), loss_one_card=mets["loss"])
        worst = max(max(rel.values()), rec["m_max_rel_err"],
                    rec["sqrt_v_max_rel_err"])
        if not worst <= PARITY_TOL:
            fail = (f"parity {cfg.name}: {mesh_shape} vs one device "
                    f"{rel}, m {rec['m_max_rel_err']}, sqrt(v) "
                    f"{rec['sqrt_v_max_rel_err']}")
    del p2, s2, model
    free(dev)
    return rec, fail


def worker(rank: int, world: int, a: dict, store_path: str, out_dir: str,
           tag: str) -> None:
    """One rank of the four-rank world (``tag`` "main": every phase) or
    of the two-rank one ("elastic2": the restore onto two ranks); writes
    ``<tag>_rank<r>.json``."""
    sys.path.insert(0, str(SRC))
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.checkpoint import store
    from repro_torch.launch import comm_analysis as CA
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import train as LT
    from repro_torch.models import sharding as S
    from repro_torch.models import transformer as TT
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedules import wsd
    from repro_torch.train import step as ST

    gloo = a["backend"] == "gloo"
    # the rehearsal's batches are small: the CPU runs every phase
    bsz, seq = (4, 32) if a["smoke"] else (8, 256)
    dev = LM.join("cpu" if gloo else None, rank=rank, world=world,
                  store=dist.FileStore(store_path, world),
                  timeout=datetime.timedelta(seconds=a["timeout"]))
    cuda = dev.type == "cuda"
    rules = dict(S.DEFAULT_SINGLE_POD)
    out, fails = {"device": str(dev)}, []

    def cfg_of(name, **kw):
        c = configs.smoke(name) if a["smoke"] else configs.get(name)
        return dataclasses.replace(c, **kw) if kw else c

    def predicted_bytes(model, psh, osh, sizes):
        """Params and optimizer state a rank holds, from the layout
        alone: each leaf's numel over the ranks that split it."""
        tot = 0
        for n, p in model.param_shapes().named_parameters():
            tot += -(-p.numel() // ways(psh[n], sizes)) * p.element_size()
            if p.is_floating_point():
                tot += 3 * 4 * -(-p.numel() // ways(osh.master[n], sizes))
        return tot

    def attn_flops(cfg, b, s):
        hd, tot = cfg.resolved_head_dim, 0
        for kind, _ in TT.layer_kinds(TT.make_plan(cfg, cfg.n_layers)):
            if kind in ("global", "local"):
                w = cfg.window if kind == "local" else s
                pairs = sum(min(i + 1, w) for i in range(s))
                tot += 4 * b * cfg.n_heads * hd * pairs
        return 3 * tot

    def train_run(name, mesh_shape, steps, b, s, cfg=None, record=False,
                  profile=False, keep=False):
        """Build ``name`` on a mesh, train ``steps`` steps of WSD at
        3e-4 over ``LR_HORIZON`` steps (so the first steps run in its
        warmup); the phase's numbers (and the objects, with
        ``keep``)."""
        cfg = cfg or cfg_of(name)
        mesh = LM.make_mesh(mesh_shape, ("data", "model"))
        model = build_model(cfg, device=dev)
        opt = AdamW(lr_fn=wsd(3e-4, LR_HORIZON // 10, LR_HORIZON // 2,
                              LR_HORIZON // 3))
        rec = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "config": cfg.name, "batch": b, "seq": s}
        with S.use_rules(rules):
            psh, osh = ST.train_state_shardings(model, mesh, rules)
            t0 = time.perf_counter()
            params = ST.init_sharded(
                model, torch.Generator(device=dev).manual_seed(0), mesh,
                rules)
            state = opt.init(params, shardings=osh)
            sync(dev)
            rec["init_s"] = time.perf_counter() - t0
            held = nbytes(list(params.parameters())
                               + list(state.m.values())
                               + list(state.v.values())
                               + list(state.master.values()))
            rec["held_bytes"] = held
            rec["predicted_bytes"] = predicted_bytes(model, psh, osh,
                                                     list(mesh.shape))
            rec["params"] = sum(p.numel() for p in params.parameters())
            step = ST.make_train_step(model, opt, q_chunk=128, k_chunk=128)
            data = batches(cfg, b, s, steps + int(record) + int(profile),
                           dev)
            losses, times = [], []
            for i in range(steps):
                dist.barrier()
                t0 = time.perf_counter()
                params, state, m = step(params, state, data[i])
                losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t0)
            rec["losses"] = losses
            rec["step_ms"] = [1e3 * t for t in times]
            med = float(np.median(times[1:] if len(times) > 1 else times))
            rec["ms_per_step_median"] = 1e3 * med
            rec["tokens_per_s"] = b * s / med
            n_act = rec["params"]
            rec["mfu"] = (6 * n_act * b * s + attn_flops(cfg, b, s)) / med \
                / (world * BF16_FLOPS) if cuda else None
            rec["peak_gib"] = peak_gib(dev)
            if record:
                r = CA.StepRecorder()
                with r:
                    params, state, m = step(params, state, data[steps])
                sizes = {}
                for c in r.collectives:
                    if c["op"] == "all-gather":
                        sizes[c["bytes"]] = sizes.get(c["bytes"], 0) + 1
                rec["recorded_step"] = {
                    "flops": r.flops,
                    "collectives": CA.collective_bytes(r.collectives),
                    "all_gather_sizes": sorted(sizes.items(),
                                               reverse=True)}
                rec["hfu"] = r.flops / med / BF16_FLOPS if cuda else None
            if profile and rank == 0 and cuda:
                (params, state, m), rec["trace"] = trace(
                    lambda: step(params, state, data[-1]), dev)
            elif profile:
                params, state, m = step(params, state, data[-1])
        ok = all(np.isfinite(losses))
        if not ok:
            fails.append(f"{name} on {mesh_shape}: a loss is not finite")
        rec["finite"] = ok
        if keep:
            return rec, (model, opt, mesh, params, state, psh, osh)
        return rec, None

    def finish():
        out["fails"] = fails
        (pathlib.Path(out_dir) / f"{tag}_rank{rank}.json").write_text(
            json.dumps(out))
        dist.barrier()
        dist.destroy_process_group()

    ck = os.path.join(out_dir, "elastic_ckpt")
    if tag == "elastic2":
        gem = cfg_of("gemma3-4b")
        cut = dataclasses.replace(gem, n_layers=len(gem.layer_pattern))
        out["elastic2"] = restore_check(ck, cut, (2, 1), bsz, seq)
        finish()
        return

    # ---- qwen2.5-14b, tensor-parallel over four cards ----------------------
    free(dev)
    rec, _ = train_run("qwen2.5-14b", (1, 4), 3 if a["smoke"] else 6,
                       bsz, seq, record=True, profile=True)
    # (the rehearsal's smoke configs barely move at the warmup's lr)
    if not a["smoke"] and not (
            np.mean(rec["losses"][-2:]) < rec["losses"][0]):
        fails.append(f"tp4: losses {rec['losses']} did not fall")
    out["tp4"] = rec
    free(dev)

    # ---- falcon-mamba-7b, tensor-parallel over four cards ------------------
    free(dev)
    rec, _ = train_run("falcon-mamba-7b", (1, 4), 2 if a["smoke"] else 4,
                       bsz, seq, record=True, profile=True)
    if not a["smoke"] and not (
            np.mean(rec["losses"][-2:]) < rec["losses"][0]):
        fails.append(f"falcon tp4: losses {rec['losses']} did not fall")
    if rec["held_bytes"] != rec["predicted_bytes"]:
        fails.append(f"falcon tp4: held {rec['held_bytes']} bytes, the "
                     f"layout says {rec['predicted_bytes']}")
    out["tp4_ssm"] = rec
    free(dev)

    # ---- gemma3-4b with ZeRO-1 on (2, 2) ------------------------------------
    free(dev)
    rec, objs = train_run("gemma3-4b", (2, 2), 2 if a["smoke"] else 4,
                          bsz, seq, record=True, keep=True)
    model, opt, mesh, params, state, psh, osh = objs
    split = {n: ways(pl, list(mesh.shape)) for n, pl in osh.master.items()}
    bad, quarter = [], 0
    for n, w in state.master.items():
        want = -(-w.numel() // split[n])
        if w.to_local().numel() > want:
            bad.append(n)
        quarter += split[n] == 4
    if bad:
        fails.append(f"zero1: masters not split as specified: {bad[:5]}")
    rec["master_leaves"] = len(state.master)
    rec["master_leaves_quartered"] = quarter
    rec["master_leaves_halved"] = sum(v == 2 for v in split.values())
    rec["master_leaves_whole"] = sum(v == 1 for v in split.values())
    rec["master_local_bytes"] = nbytes(state.master.values())
    rec["master_full_bytes"] = sum(w.numel() * 4
                                   for w in state.master.values())
    out["zero1"] = rec
    del model, opt, params, state, objs
    free(dev)

    # ---- elastic restore: (2, 2) -> (4, 1) here, -> 2 ranks later -----------
    free(dev)
    gem = cfg_of("gemma3-4b")
    cut = dataclasses.replace(gem, n_layers=len(gem.layer_pattern))
    rec, objs = train_run("gemma3-4b", (2, 2), 3, bsz, seq, cfg=cut,
                          keep=True)
    model, opt, mesh, params, state, psh, osh = objs
    with S.use_rules(rules):
        t0 = time.perf_counter()
        store.save(ck, 3, (params, state), extra={"losses":
                                                  rec["losses"]},
                   spec_tree=model.param_specs())
        rec["save_s"] = time.perf_counter() - t0
    del params, state, objs
    free(dev)
    rec["restore_4x1"] = restore_check(ck, cut, (4, 1), bsz, seq)
    out["elastic"] = rec
    free(dev)

    # ---- the launcher, data parallel with ZeRO-1 ----------------------------
    free(dev)
    argv = ["--arch", "minicpm-2b", "--mesh", "host", "--steps", "4"]
    if a["smoke"]:
        argv += ["--smoke", "--batch", str(bsz), "--seq", str(seq)]
    if gloo:
        argv += ["--device", "cpu"]
    t0 = time.perf_counter()
    hist = LT.main(argv)
    rec = {"argv": argv, "seconds": time.perf_counter() - t0,
           "losses": hist["losses"], "step_ms": [1e3 * t for t in
                                                 hist["times"]],
           "peak_gib": peak_gib(dev)}
    if not all(np.isfinite(hist["losses"])):
        fails.append("launch: a loss is not finite")
    out["launch"] = rec
    free(dev)

    # ---- sharded against one card: float32, the Mamba row float64 ---------
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for key, name, shape, dt in PARITY_ROWS:
        out[key], fail = train_parity(cfg_of(name, n_layers=2, **dt), shape,
                                      dev, rank, seq, rules)
        if fail:
            fails.append(fail)
    finish()


def restore_check(ck: str, cfg, mesh_shape, bsz: int, seq: int) -> dict:
    """Restore the elastic checkpoint onto a ``mesh_shape`` mesh of this
    world (a target built on ``meta``, placed by ``shardings``): every
    leaf against the saved one bit for bit, the step, one more step."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import for_config
    from repro_torch.launch import mesh as LM
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedules import wsd
    from repro_torch.train import step as ST

    rules = dict(S.DEFAULT_SINGLE_POD)
    mesh = LM.make_mesh(mesh_shape, ("data", "model"))
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    model = build_model(cfg, device=dev)
    opt = AdamW(lr_fn=wsd(3e-4, LR_HORIZON // 10, LR_HORIZON // 2,
                          LR_HORIZON // 3))
    t0 = time.perf_counter()
    with S.use_rules(rules):
        psh, osh = ST.train_state_shardings(model, mesh, rules)
        shapes = model.param_shapes()
        (params, state), extra = store.restore(
            ck, 3, (shapes, opt.init(shapes)), shardings=(psh, osh),
            mesh=mesh)
        restore_s = time.perf_counter() - t0
        metas = {m["name"]: m for m in store.manifest(ck, 3)["leaves"]}
        same = 0
        leaves = store.leaves((params, state))
        for name, t in leaves:
            want = store.load_leaf(ck, 3, metas[name])
            got = (t.full_tensor() if S.is_dtensor(t) else t).cpu()
            same += bool(torch.equal(got.to(want.dtype), want))
        step0 = int(state.step)
        data = for_config(cfg, batch=bsz, seq=seq, seed=3)
        b = {k: torch.as_tensor(v).to(dev) for k, v in data.next().items()}
        params, state, m = ST.make_train_step(model, opt, q_chunk=128,
                                              k_chunk=128)(params, state, b)
    rec = {"mesh": list(mesh_shape), "leaves": len(leaves),
           "leaves_bit_equal": same, "restored_step": step0,
           "step_after": int(state.step), "next_loss": float(m["loss"]),
           "restore_s": restore_s}
    rec["ok"] = (same == len(leaves) and step0 == 3
                 and rec["step_after"] == 4
                 and bool(np.isfinite(rec["next_loss"])))
    return rec


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def run_world(ctx, world: int, a: dict, tmp: str, tag: str,
              deadline: float, target=None, name: str = "dist_train"):
    """``world`` rank processes running ``target``'s ``tag`` (default
    this script's ``worker``); their records, or None after a failure
    (reported on stderr).  A rank that fails ends the others at once:
    they would wait in a collective for the one that is gone."""
    store_path = os.path.join(tmp, f"store_{tag}")
    procs = [ctx.Process(target=target or worker,
                         args=(r, world, a, store_path, tmp, tag))
             for r in range(world)]
    for p in procs:
        p.start()
    while time.monotonic() < deadline:
        codes = [p.exitcode for p in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            break
        time.sleep(0.5)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
    for p in procs:
        p.join()
    if hung or any(p.exitcode != 0 for p in procs):
        print(f"{name}: rank exit codes {[p.exitcode for p in procs]}"
              + (" (ended by the script)" if hung else ""),
              file=sys.stderr)
        return None
    return [json.loads((pathlib.Path(tmp) / f"{tag}_rank{r}.json")
                       .read_text()) for r in range(world)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--smoke", action="store_true",
                    help="the families' smoke configs (rehearsal)")
    ap.add_argument("--timeout", type=int, default=840)
    a = ap.parse_args()
    import torch
    if a.backend == "nccl" and torch.cuda.device_count() < RANKS:
        print(f"dist_train: {RANKS} ranks need {RANKS} CUDA cards; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"dist_train: no repro_torch package under {SRC}",
              file=sys.stderr)
        return 2
    ctx = torch.multiprocessing.get_context("spawn")
    deadline = time.monotonic() + a.timeout
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dist_train_") as tmp:
        ranks = run_world(ctx, RANKS, vars(a), tmp, "main", deadline)
        if ranks is None:
            return 1
        two = run_world(ctx, 2, vars(a), tmp, "elastic2", deadline)
        if two is None:
            return 1
    fails = [f for r in ranks + two for f in r["fails"]]
    label = "published" if not a.smoke else "smoke"
    r0 = ranks[0]["tp4"]
    print(json.dumps({
        "phase": "dist_train:qwen2.5-14b:tp4", "configs": label,
        **{k: v for k, v in r0.items() if k not in ("recorded_step",)},
        "ms_per_step_per_rank": [r["tp4"]["ms_per_step_median"]
                                 for r in ranks],
        "peak_gib_per_rank": [r["tp4"]["peak_gib"] for r in ranks],
        "held_bytes_per_rank": [r["tp4"]["held_bytes"] for r in ranks],
        "flops_per_rank": [r["tp4"]["recorded_step"]["flops"]
                           for r in ranks],
        "collectives_per_rank": [r["tp4"]["recorded_step"]
                                 ["collectives"] for r in ranks]}),
        flush=True)
    f0 = ranks[0]["tp4_ssm"]
    print(json.dumps({
        "phase": "dist_train:falcon-mamba-7b:tp4", "configs": label,
        **{k: v for k, v in f0.items() if k != "recorded_step"},
        "all_gather_sizes": f0["recorded_step"]["all_gather_sizes"],
        "ms_per_step_per_rank": [r["tp4_ssm"]["ms_per_step_median"]
                                 for r in ranks],
        "peak_gib_per_rank": [r["tp4_ssm"]["peak_gib"] for r in ranks],
        "held_bytes_per_rank": [r["tp4_ssm"]["held_bytes"] for r in ranks],
        "flops_per_rank": [r["tp4_ssm"]["recorded_step"]["flops"]
                           for r in ranks],
        "collectives_per_rank": [r["tp4_ssm"]["recorded_step"]
                                 ["collectives"] for r in ranks]}),
        flush=True)
    print(json.dumps({"phase": "dist_train:gemma3-4b:2x2",
                      "configs": label, **ranks[0]["zero1"],
                      "peak_gib_per_rank": [r["zero1"]["peak_gib"]
                                            for r in ranks],
                      "held_bytes_per_rank": [r["zero1"]["held_bytes"]
                                              for r in ranks]}),
          flush=True)
    restores = [r["elastic"]["restore_4x1"] for r in ranks] + \
        [r["elastic2"] for r in two]
    if not all(x["ok"] for x in restores):
        fails.append(f"elastic: {restores}")
    print(json.dumps({"phase": "dist_train:elastic", "configs": label,
                      "cut": "n_layers = one period of the pattern (6)",
                      **ranks[0]["elastic"],
                      "restore_2ranks": two[0]["elastic2"],
                      "all_ranks_ok": all(x["ok"] for x in restores)}),
          flush=True)
    print(json.dumps({"phase": "dist_train:launch:host",
                      "configs": label, **ranks[0]["launch"],
                      "losses_per_rank": [r["launch"]["losses"]
                                          for r in ranks]}), flush=True)
    print(json.dumps({"phase": "dist_train:parity", "configs": label,
                      **ranks[0]["parity"],
                      "rows": {r["config"]: r for r in (
                          ranks[0]["parity"], ranks[0]["parity_ssm"])}}),
          flush=True)
    if a.backend == "nccl":     # the cards the numbers above ran on
        print(nvidia_smi_line(), flush=True)
    if fails:
        print(f"dist_train: failed: {fails}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "backend": a.backend, "ranks": RANKS,
                      "seconds": time.perf_counter() - t_all}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
