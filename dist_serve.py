#!/usr/bin/env python3
"""Serve the port's models across four cards: sharded prefill and
decode (ROADMAP 1.30) in the reference's decode_32k and long_500k
layouts, one process and one card per rank.

    python3 dist_serve.py                              # 4 ranks, 4 cards
    python3 dist_serve.py --backend gloo --smoke       # 4 CPU processes

Every phase drives ``Model.prefill`` and ``Model.decode_step`` with
DTensor params (``train.step.init_sharded``) under
``sharding.use_rules(rules_for("decode", batch, mesh))``, as the
reference's dry-run cells do (``repro/launch/dryrun.py``); after the
prefill each layer's cache is laid out as ``Model.cache_specs()`` says
(``sharding.lay_out_cache``, one layer at a time).  bf16 at published
width and depth, random weights from a seed, greedy decoding; each model
is freed before the next.

``dist_serve:qwen2.5-14b:b16x32k``  decode_32k's layout: mesh (2, 2),
    the batch of 16 on ``data``, the cache's head dim on ``model`` (8 kv
    heads do not divide the production axis of 16); 16 prompts of 1024
    tokens prefilled into caches of 32768 slots (103 GB of cache in
    all, more than a card), then 32 greedy steps.
``dist_serve:gemma3-4b:cp524k``  long_500k's layout: mesh (2, 2), one
    prompt of 2048 tokens (past the 1024 window: the local rings wrap),
    the cache's sequence on ``data`` and head dim on ``model``,
    ``max_len`` 524288, 32 steps; then rank 0's card alone runs the same
    prompt and is fed the same tokens: the largest relative logit
    difference a step and the greedy tokens' agreement (reported).
``dist_serve:deepseek-moe-16b:tp4``  MoE decode over DTensors: mesh
    (1, 4), 16 of the 64 experts a rank, batch 8, prompts of 256, caches
    of 4096, 16 steps; a second run on the same params must give the
    same tokens; dropped assignments (``moe.dropped_assignments`` over
    each call's routing).
``dist_serve:falcon-mamba-7b:tp4``  mesh (1, 4), channels on ``model``,
    batch 4, prompts of 1024, 32 steps: the sharded state written step
    after step.
``dist_serve:parity``  the four configs cut to 2 layers (gemma3-4b to
    one period of 6, so that a global layer is present), float32 with
    TF32 off (falcon-mamba-7b in float64: ``dist_train.PARITY_F64``),
    on the same layouts: prefill, then 16 steps fed the same
    tokens, against rank 0's card alone: every step's logits within
    PARITY_TOL of their max (SERVE_TOL for the MoE), the final caches
    and states within the same bound, positions and counters equal.

Each serving phase reports per rank: ms a decode step (steps 2 to N-2
on the host clock, each ending in a sync; median and quartiles),
tokens/s, prefill ms, the bytes held (weights and cache apart) against
the layout's prediction (each leaf's numel over the ranks that split
it), peak memory, the step's bound (the bytes a rank reads -- its
weights, less an untied embedding table, and every cache slot -- over
3.35 TB/s), one step's collectives by op (``StepRecorder``, step N-1)
and rank 0's ``torch.profiler`` device ms, idle share and kernels of
step N.  Checked: finite logits; each row's insertion counter equal to
prompt plus steps, its newest position one less, and its filled slots
as many as the ring holds.

Rank start-up, ``--timeout`` and the closing lines are
``dist_train.py``'s: one JSON line per phase, ``nvidia-smi``'s name and
power limit, then ``{"ok": true, ...}``; a failed check or rank exits
non-zero, and a rank that fails ends the others.  ``--backend gloo
--smoke`` rehearses every phase on the CPU with the smoke configs at
small sizes (host-clock times that name no device).
"""
from __future__ import annotations

import argparse
import datetime
import json
import pathlib
import sys
import tempfile
import time

from dist_train import (PARITY_F32, PARITY_F64, RANKS, free, full,
                        local, nbytes, nvidia_smi_line, peak_gib,
                        run_world, sync, trace, ways)

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
PARITY_TOL = 1e-5
# the MoE's partial expert outputs meet over the model axis in another
# order than one card sums them (tests/test_torch_dist_train.py)
SERVE_TOL = 1e-4
# (config, mesh, batch, prompt, max_len, steps) of each serving phase;
# the rehearsal's sizes beside them
PHASES = {
    "b16x32k": ("qwen2.5-14b", (2, 2), 16, 1024, 32768, 32),
    "cp524k": ("gemma3-4b", (2, 2), 1, 2048, 524288, 32),
    "tp4_moe": ("deepseek-moe-16b", (1, 4), 8, 256, 4096, 16),
    "tp4_ssm": ("falcon-mamba-7b", (1, 4), 4, 1024, None, 32),
}
SMOKE = {
    "b16x32k": (4, 16, 64, 6),
    "cp524k": (1, 24, 64, 6),       # past the smoke config's window 16
    "tp4_moe": (4, 8, 32, 6),
    "tp4_ssm": (4, 16, None, 6),
}
# parity: (config, mesh, batch, prompt, max_len, layers); 16 steps
PARITY = [("qwen2.5-14b", (2, 2), 4, 64, 128, 2),
          ("gemma3-4b", (2, 2), 1, 1040, 2048, 6),
          ("deepseek-moe-16b", (1, 4), 8, 64, 128, 2),
          ("falcon-mamba-7b", (1, 4), 4, 64, None, 2)]
SMOKE_PARITY = {"gemma3-4b": (1, 24, 64)}
PARITY_STEPS = 16
# dist_train.py's PARITY_F64, for the reason given there
PARITY_DTYPE = {"falcon-mamba-7b": PARITY_F64}


def prompt_tokens(cfg, batch: int, n: int, seed: int):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (batch, n)))


def leaves(tree, pre=""):
    """(name, tensor) of every leaf of a cache (lists and dicts)."""
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from leaves(v, f"{pre}{k}.")
        else:
            yield f"{pre}{k}", v


def predicted(model, mesh, batch: int, max_len: int):
    """Weights and cache a rank holds, from the layout alone: each
    leaf's numel over the ranks that split it."""
    from repro_torch.models import sharding as S
    sizes = list(mesh.shape)
    specs = model.param_specs()
    w = sum(-(-p.numel() // ways(S.placements(specs[n], mesh), sizes))
            * p.element_size()
            for n, p in model.param_shapes().named_parameters())
    shapes = dict(leaves(model.init_cache(batch, max_len, device="meta")))
    c = sum(-(-shapes[n].numel() // ways(S.placements(sp, mesh), sizes))
            * shapes[n].element_size()
            for n, sp in leaves(model.cache_specs()))
    return w, c


def counters_ok(cache, n_tokens: int) -> list:
    """Each attention ring's insertion counter, newest position and
    filled slots after ``n_tokens`` tokens; the leaves that are wrong."""
    bad = []
    for n, t in leaves(cache):
        if n.endswith("ins"):
            ins = full(t)
            if not bool((ins == n_tokens).all()):
                bad.append(f"{n}: {ins.tolist()}")
        elif n.endswith("pos"):
            pos = full(t)
            if not bool((pos.amax(1) == n_tokens - 1).all()):
                bad.append(f"{n}: newest {pos.amax(1).tolist()}")
            filled = (pos >= 0).sum(1)
            if not bool((filled == min(n_tokens, pos.shape[1])).all()):
                bad.append(f"{n}: filled {filled.tolist()}")
    return bad


def rel_err(a_, b_, vocab: int) -> float:
    """The largest difference over the real vocab, over ``b_``'s max."""
    a_, b_ = a_[..., :vocab].float(), b_[..., :vocab].float()
    return float((a_ - b_).abs().max() / b_.abs().max())


def prefill_and_decode(model, params, toks, max_len: int, steps: int, *,
                       fed=None, mesh=None, after_prefill=None,
                       run_step=None, seen=None):
    """Prefill ``toks`` (B, S), then ``steps`` decode steps, step i fed
    ``fed[:, i - 1]`` or, without ``fed``, the greedy token of the last
    call.  With ``mesh`` every input is placed on it and, after the
    prefill, the cache laid out as ``Model.cache_specs()`` says (under
    the installed rules).  ``after_prefill(cache)`` runs once the cache
    is laid out; ``run_step(i, fn)`` runs step i's ``fn`` (returning
    (cache, logits)) as the caller times or records it; ``seen(i, lf)``
    gets every call's full logits (i = 0: the prefill's).  Returns the
    cache and the greedy token of each call ((B,) lists)."""
    import torch

    from repro_torch.models import sharding as S
    from repro_torch.train import step as ST

    def place(x):
        return x if mesh is None else ST.place_batch(x, mesh)
    b, s = toks.shape
    cache, logits = model.prefill(params, place({"tokens": toks}),
                                  max_len=max_len)
    if mesh is not None:
        S.lay_out_cache(cache, model.cache_specs(), mesh)
    if after_prefill:
        after_prefill(cache)
    tokens = []
    for i in range(steps + 1):
        if i:
            t = fed[:, i - 1:i] if fed is not None else nxt[:, None]
            pos = torch.full((b,), s + i - 1, dtype=torch.int32,
                             device=toks.device)
            x = place({"t": t, "p": pos})

            def step():
                return model.decode_step(params, cache, x["t"], x["p"])
            cache, logits = run_step(i, step) if run_step else step()
        lf = full(logits)
        if seen:
            seen(i, lf)
        nxt = lf[:, -1, :model.cfg.vocab].argmax(-1)
        tokens.append(nxt.tolist())
    return cache, tokens


def one_device(cfg, toks, fed, max_len: int, dev):
    """``cfg`` alone on ``dev`` from the phases' seed, prefilled with
    ``toks`` and fed ``fed`` (B, steps): each call's logits (on the
    host) and the final cache."""
    import torch

    from repro_torch.models.api import build_model
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    outs = []
    cache, _ = prefill_and_decode(model, params, toks, max_len,
                                  fed.shape[1], fed=fed,
                                  seen=lambda i, lf: outs.append(lf.cpu()))
    return outs, cache


def serve_parity(cfg, shape, b: int, s: int, max_len: int, dev,
                 rank: int):
    """``cfg`` (a parity row's cut) on a ``shape`` mesh under
    ``rules_for("decode", b, ...)``: prefill ``s`` tokens, then
    PARITY_STEPS steps fed the next ones, against rank 0's device
    alone: every call's logits, and the final cache's float leaves,
    within the row's bound of their max; positions and counters equal.
    Returns (row, failure or None); the row's numbers on rank 0 only."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as LM
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    from repro_torch.train import step as ST

    steps = PARITY_STEPS
    tol = SERVE_TOL if cfg.n_experts else PARITY_TOL
    model = build_model(cfg, device=dev)
    mesh = LM.make_mesh(shape, ("data", "model"))
    rules = S.rules_for("decode", b, dict(zip(mesh.mesh_dim_names,
                                              mesh.shape)))
    toks = prompt_tokens(cfg, b, s + steps, seed=2).to(dev)
    got = []
    free(dev)
    with S.use_rules(rules):
        params = ST.init_sharded(
            model, torch.Generator(device=dev).manual_seed(0), mesh, rules)
        cache, _ = prefill_and_decode(
            model, params, toks[:, :s], max_len, steps, fed=toks[:, s:],
            mesh=mesh, seen=lambda i, lf: got.append(lf.cpu()))
        final = {n: full(t).cpu() for n, t in leaves(cache)}
    del params, cache
    free(dev)
    row = {"config": cfg.name, "mesh": list(shape),
           "dtype": cfg.param_dtype,
           "rules": {k: v for k, v in rules.items() if v},
           "batch": b, "prompt": s, "max_len": max_len, "steps": steps,
           "tol": tol}
    fail = None
    if rank == 0:
        outs, c1 = one_device(cfg, toks[:, :s], toks[:, s:], max_len, dev)
        errs = [rel_err(a_, b_, cfg.vocab) for a_, b_ in zip(got, outs)]
        want = {n: t.cpu() for n, t in leaves(c1)}
        cache_err, exact = 0.0, True
        for n, t in final.items():
            if t.is_floating_point():
                cache_err = max(cache_err, float(
                    (t - want[n]).abs().max()
                    / max(float(want[n].abs().max()), 1e-30)))
            else:
                exact &= bool(torch.equal(t, want[n]))
        row.update(logit_errs=errs, max_logit_err=max(errs),
                   cache_max_rel_err=cache_err, counters_equal=exact,
                   leaves=len(final))
        if not (max(errs) <= tol and cache_err <= tol and exact):
            fail = (f"parity {cfg.name}: logits {max(errs)}, cache "
                    f"{cache_err}, counters {exact} (tol {tol})")
        del outs, c1
    del model, got, final
    free(dev)
    dist.barrier()
    return row, fail


def worker(rank: int, world: int, a: dict, store_path: str, out_dir: str,
           tag: str) -> None:
    """One rank: every phase; writes ``<tag>_rank<r>.json``."""
    sys.path.insert(0, str(SRC))
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import comm_analysis as CA
    from repro_torch.launch import mesh as LM
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    from repro_torch.train import step as ST

    gloo = a["backend"] == "gloo"
    smoke = a["smoke"]
    dev = LM.join("cpu" if gloo else None, rank=rank, world=world,
                  store=dist.FileStore(store_path, world),
                  timeout=datetime.timedelta(seconds=a["timeout"]))
    cuda = dev.type == "cuda"
    out, fails = {"device": str(dev)}, []

    def cfg_of(name, **kw):
        c = configs.smoke(name) if smoke else configs.get(name)
        return dataclasses.replace(c, **kw) if kw else c

    def serve_run(key, *, repeat=False, keep=False):
        """Build the phase's model on its mesh, prefill, lay out the
        cache, decode greedily; the phase's numbers."""
        t_phase = time.perf_counter()
        name, shape, b, s, max_len, steps = PHASES[key]
        if smoke:
            b, s, max_len, steps = SMOKE[key]
        cfg = cfg_of(name)
        mesh = LM.make_mesh(shape, ("data", "model"))
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        rules = S.rules_for("decode", b, sizes)
        model = build_model(cfg, device=dev)
        max_len = max_len or s + steps
        rec = {"config": cfg.name, "mesh": sizes,
               "rules": {k: v for k, v in rules.items() if v},
               "batch": b, "prompt": s, "max_len": max_len, "steps": steps}
        toks = prompt_tokens(cfg, b, s, seed=1).to(dev)
        routed = []
        route = MOE.route

        def recording_route(p, cfg_, xt):
            r = route(p, cfg_, xt)
            routed.append(local(r[2]).detach().clone())
            return r

        with S.use_rules(rules):
            sync(dev)
            t0 = time.perf_counter()
            params = ST.init_sharded(
                model, torch.Generator(device=dev).manual_seed(0), mesh,
                rules)
            sync(dev)
            rec["build_s"] = time.perf_counter() - t0
            names = dict(params.named_parameters())
            rec["weight_bytes"] = nbytes(names.values())
            embed = names["embed.w"]
            read_w = rec["weight_bytes"] - (
                0 if cfg.tie_embeddings else nbytes([embed]))
            runs = []
            for run in range(2 if repeat else 1):
                routed.clear()
                MOE.route = recording_route
                try:
                    r = decode_run(model, params, mesh, toks, max_len,
                                   steps, cfg, measure=run == 0,
                                   keep=keep, routed=routed)
                finally:
                    MOE.route = route
                n = r.pop("prefill_routes")
                if run == 0 and cfg.n_experts:
                    r["dropped_prefill"] = sum(
                        MOE.dropped_assignments(cfg, e) for e in routed[:n])
                    r["dropped_decode"] = sum(
                        MOE.dropped_assignments(cfg, e) for e in routed[n:])
                    r["routed_calls"] = len(routed)
                    r["routed_assignments"] = sum(e.numel() for e in routed)
                runs.append(r)
            r = runs[0]
            rec.update({k: v for k, v in r.items()
                        if k not in ("cache", "logits")})
            rec["read_bytes"] = read_w + r["cache_bytes"]
            rec["bound_ms"] = 1e3 * rec["read_bytes"] / HBM_BYTES_PER_S
            w_pred, c_pred = predicted(model, mesh, b, max_len)
            rec["predicted_weight_bytes"] = w_pred
            rec["predicted_cache_bytes"] = c_pred
            rec["held_bytes"] = rec["weight_bytes"] + r["cache_bytes"]
            rec["predicted_bytes"] = w_pred + c_pred
            if repeat:
                rec["tokens_repeat_equal"] = runs[1]["tokens"] == \
                    r["tokens"]
                if not rec["tokens_repeat_equal"]:
                    fails.append(f"{key}: a second run's tokens differ")
            extra = (model, params, r["logits"]) if keep else None
            del runs, r
        rec["seconds"] = time.perf_counter() - t_phase
        return rec, extra

    def decode_run(model, params, mesh, toks, max_len, steps, cfg, *,
                   measure=True, keep=False, routed=()):
        """Prefill ``toks``, then ``steps`` greedy steps; with
        ``measure`` the last two steps are recorded and traced, with
        ``keep`` every call's full logits kept (on the host)."""
        b, s = toks.shape
        r, times, kept, finite = {}, [], [], [True]

        def after_prefill(cache):
            sync(dev)
            r["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            r["prefill_routes"] = len(routed)
            r["cache_bytes"] = nbytes([t for _, t in leaves(cache)])
            r["peak_after_prefill_gib"] = peak_gib(dev)

        def run_step(i, step):
            if measure and i == steps - 1:
                rec_ = CA.StepRecorder()
                with rec_:
                    out_ = step()
                r["collectives"] = CA.collective_bytes(rec_.collectives)
                r["step_flops"] = rec_.flops
                return out_
            if measure and i == steps and cuda:
                if rank != 0:
                    return step()
                out_, r["trace"] = trace(step, dev)
                return out_
            sync(dev)
            t1 = time.perf_counter()
            out_ = step()
            sync(dev)
            times.append(time.perf_counter() - t1)
            return out_

        def seen(i, lf):
            finite[0] &= bool(torch.isfinite(lf[..., :cfg.vocab]).all())
            if keep:
                kept.append(lf.cpu())

        sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        cache, tokens = prefill_and_decode(
            model, params, toks, max_len, steps, mesh=mesh,
            after_prefill=after_prefill, run_step=run_step, seen=seen)
        r["finite"] = finite[0]
        if not finite[0]:
            fails.append(f"{cfg.name}: non-finite logits")
        bad = counters_ok(cache, s + steps)
        r["counters_ok"] = not bad
        if bad:
            fails.append(f"{cfg.name}: cache counters {bad[:4]}")
        ts = times[1:] if len(times) > 1 else times
        q = np.percentile(ts, [50, 25, 75]) * 1e3
        r["step_ms"] = [float(v) for v in q]
        r["step_ms_all"] = [1e3 * t for t in times]
        r["tokens_per_s"] = b / (q[0] / 1e3)
        r["peak_gib"] = peak_gib(dev)
        r["tokens"] = tokens
        r["logits"] = kept
        del cache
        return r

    # ---- qwen2.5-14b in decode_32k's layout ---------------------------------
    free(dev)
    out["b16x32k"], _ = serve_run("b16x32k")
    free(dev)

    # ---- gemma3-4b in long_500k's layout, then one card ---------------------
    rec, extra = serve_run("cp524k", keep=True)
    model, params, sharded_logits = extra
    del params, extra
    free(dev)
    dist.barrier()
    if rank == 0:
        cfg = model.cfg
        toks = prompt_tokens(cfg, rec["batch"], rec["prompt"], 1).to(dev)
        fed = torch.as_tensor(rec["tokens"][:-1], device=dev).T
        outs, cache = one_device(cfg, toks, fed, rec["max_len"], dev)
        errs = [rel_err(a_, b_, cfg.vocab)
                for a_, b_ in zip(sharded_logits, outs)]
        agree = [int(o[:, -1, :cfg.vocab].argmax(-1).tolist() == t)
                 for o, t in zip(outs, rec["tokens"])]
        rec["one_card"] = {"max_rel_logit_err_per_step": errs,
                           "greedy_agreement": sum(agree) / len(agree),
                           "greedy_agree_per_step": agree,
                           "peak_gib": peak_gib(dev)}
        del outs, cache
    del model, sharded_logits
    free(dev)
    dist.barrier()
    out["cp524k"] = rec

    # ---- deepseek-moe-16b, experts over four ranks --------------------------
    free(dev)
    out["tp4_moe"], _ = serve_run("tp4_moe", repeat=True)
    free(dev)

    # ---- falcon-mamba-7b, channels over four ranks --------------------------
    free(dev)
    out["tp4_ssm"], _ = serve_run("tp4_ssm")
    free(dev)

    # ---- parity: 2 layers against one card, float32 (Mamba float64) --------
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    par, t_par = {}, time.perf_counter()
    for name, shape, b, s, max_len, layers in PARITY:
        if smoke:
            b, s, max_len = SMOKE_PARITY.get(name, (b, 16, 48))
        cfg = cfg_of(name, n_layers=layers, **PARITY_DTYPE.get(name,
                                                               PARITY_F32))
        row, fail = serve_parity(cfg, shape, b, s,
                                 max_len or s + PARITY_STEPS, dev, rank)
        par[cfg.name] = row
        if fail:
            fails.append(fail)
    out["parity"] = par
    out["parity_seconds"] = time.perf_counter() - t_par

    out["fails"] = fails
    (pathlib.Path(out_dir) / f"{tag}_rank{rank}.json").write_text(
        json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


SERVE_LINES = {"b16x32k": "dist_serve:qwen2.5-14b:b16x32k",
               "cp524k": "dist_serve:gemma3-4b:cp524k",
               "tp4_moe": "dist_serve:deepseek-moe-16b:tp4",
               "tp4_ssm": "dist_serve:falcon-mamba-7b:tp4"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--smoke", action="store_true",
                    help="the families' smoke configs (rehearsal)")
    ap.add_argument("--timeout", type=int, default=900)
    a = ap.parse_args()
    import torch
    if a.backend == "nccl" and torch.cuda.device_count() < RANKS:
        print(f"dist_serve: {RANKS} ranks need {RANKS} CUDA cards; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"dist_serve: no repro_torch package under {SRC}",
              file=sys.stderr)
        return 2
    ctx = torch.multiprocessing.get_context("spawn")
    deadline = time.monotonic() + a.timeout
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dist_serve_") as tmp:
        ranks = run_world(ctx, RANKS, vars(a), tmp, "serve", deadline,
                          target=worker, name="dist_serve")
    if ranks is None:
        return 1
    fails = [f for r in ranks for f in r["fails"]]
    label = "published" if not a.smoke else "smoke"
    per_rank = ("step_ms", "tokens_per_s", "prefill_ms", "weight_bytes",
                "cache_bytes", "held_bytes", "peak_gib", "bound_ms",
                "collectives")
    for key, phase in SERVE_LINES.items():
        r0 = ranks[0][key]
        row = {"phase": phase, "configs": label,
               **{k: v for k, v in r0.items() if k != "collectives"},
               "collectives": r0.get("collectives")}
        for k in per_rank:
            row[f"{k}_per_rank"] = [r[key].get(k) for r in ranks]
        if key == "b16x32k":
            held = [r[key]["held_bytes"] for r in ranks]
            pred = r0["predicted_bytes"]
            row["held_over_predicted"] = [h / pred for h in held]
            row["held_total_bytes"] = sum(held)
            if not all(abs(h / pred - 1) <= 0.05 for h in held):
                fails.append(f"{phase}: held {held} vs predicted {pred}")
            if a.backend == "nccl" and not a.smoke:   # published sizes
                card = torch.cuda.get_device_properties(0).total_memory
                row["one_card_bytes"] = card
                if not sum(held) > card:
                    fails.append(f"{phase}: the ranks hold {sum(held)} "
                                 f"bytes, no more than one card's {card}")
        print(json.dumps(row), flush=True)
    print(json.dumps({"phase": "dist_serve:parity", "configs": label,
                      "seconds": ranks[0]["parity_seconds"],
                      "rows": ranks[0]["parity"]}), flush=True)
    if a.backend == "nccl":     # the cards the numbers above ran on
        print(nvidia_smi_line(), flush=True)
    if fails:
        print(f"dist_serve: failed: {fails}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "backend": a.backend, "ranks": RANKS,
                      "seconds": time.perf_counter() - t_all}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
