"""Multi-pod dry run: every (architecture x input shape x mesh) cell's
step on a fake production mesh, with its per-rank memory, flops and
collectives.

Port of ``repro/launch/dryrun.py``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--mesh both] [--out experiments/dryrun_torch]

Each cell runs in one CPU process as rank 0 of PyTorch's fake process
group (``torch.testing._internal.distributed.fake_pg``: collectives
return at once) of 256 ranks -- the (16, 16) (data, model) mesh -- or
512 -- (2, 16, 16) (pod, data, model) -- under ``FakeTensorMode``, so no
tensor holds storage and nothing is computed.  The cell's own step is
the one the reference lowers: the train step (``make_train_step``,
rematerialised, AdamW with ZeRO-1), ``prefill`` or ``decode_step``,
under ``sharding.rules_for``'s rules; its state laid out by
``train_state_shardings`` and its inputs by ``input_specs``.  Per rank
the record holds the bytes of params, optimizer state, cache and batch
(``memory.argument_size_in_bytes``, and each part), the flops, the
collectives and the step's memory and traffic, all counted by
``comm_analysis.StepRecorder`` on the rank's local shapes, with no
device:

* ``memory.peak_bytes``: the most live storage at once, the arguments
  included (the recorder's peak, which leaves out the global-shape
  tensors of DTensor's sharding propagation -- what made
  ``torch.distributed._tools.mem_tracker.MemTracker`` report 208 GB for
  a cell whose arguments are 0.95 GB a rank);
* ``memory.temp_size_in_bytes``: that peak less the arguments;
* ``memory.output_size_in_bytes``: the storages of the tensors the step
  returns (the train step updates params and state in place, so its
  outputs are mostly its arguments);
* ``hlo_bytes_raw`` and ``cost["bytes"]``: every local operation's
  tensor inputs and outputs, once each -- the unfused traffic of the
  eager step (``cost["bytes_kind"]``), not XLA's bytes accessed after
  fusion, which the reference records under the same keys.

``q_chunk`` and ``k_chunk`` name the attention chunks the cell was
traced at, ``attn_impl`` the attention schedule (``"pairs"`` or
``"qloop"``, :func:`repro_torch.models.attention.use_attn_impl`), which
every trace enters in its own process.

The record comes from the depth plan (:func:`_depth_variants`,
:func:`extrapolated_cost`): the cell's step traced at one and two units
of its pattern (a layer; of a multi-kind pattern a whole period), a
train or decode step also at three, at the cell's own sequence and
chunks, each trace in a process of its own, and the counts carried to
the full depth in integer arithmetic -- every unit adds the same flops,
bytes and collectives, so they come out exact -- and the peak along the
line of what each unit after the first keeps (:func:`extrapolate`).  A
layer of a 32k prefill traces in one to three minutes where the full
depth took most of an hour.  The arguments are laid out at full depth
with no step.  ``cost["extrapolated"]``, ``cost["variants"]``,
``cost["traced"]`` and ``cost["n_variant_traces"]`` say how;
``trace_s`` sums the variants' traces.  ``with_cost=False``
(``--no-cost``) traces the full depth, as does a cell no deeper than its
plan's configs.  No sequence polynomial is fitted: the reference fits
one because XLA counts a ``while`` body once and an unrolled 32k compile
cost too much.

Each cell writes ``<out>/<mesh>/<arch>__<shape>.json`` (existing files
are skipped, so the sweep is resumable).  The ``SKIP`` table is the
reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

__all__ = ["SKIP", "DepthVariant", "dryrun_cell", "extrapolate",
           "extrapolated_cost", "main", "traced_configs"]

# the kind of byte count the record carries (``cost["bytes_kind"]``)
BYTES_KIND = "unfused eager traffic: each local op's tensor inputs and " \
    "outputs once"

SKIP = {
    # long_500k only for sub-quadratic archs
    ("llava-next-mistral-7b", "long_500k"): "full attention at 500k",
    ("granite-moe-3b-a800m", "long_500k"): "full attention at 500k",
    ("deepseek-moe-16b", "long_500k"): "full attention at 500k",
    ("starcoder2-15b", "long_500k"): "full attention at 500k",
    ("minicpm-2b", "long_500k"): "full attention at 500k",
    ("qwen2.5-14b", "long_500k"): "full attention at 500k",
    ("seamless-m4t-medium", "long_500k"): "enc-dec full attention at 500k",
}


# what every trace imports: a forkserver holding them starts each trace's
# process in a fraction of a second, where a spawned one spends seconds
# importing them
_PRELOAD = ["torch", "torch.distributed.tensor",
            "torch._subclasses.fake_tensor",
            "torch.testing._internal.distributed.fake_pg",
            "repro_torch.launch.comm_analysis", "repro_torch.launch.mesh",
            "repro_torch.models.api", "repro_torch.sparse.sparse_ffn",
            "repro_torch.train.step"]


def _fake_world(n: int) -> None:
    """Rank 0 of a fake process group of ``n`` ranks (the one use of
    PyTorch's private fake group)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def _local_bytes(tensors) -> int:
    from repro_torch.models.sharding import is_dtensor
    n = 0
    for t in tensors:
        loc = t.to_local() if is_dtensor(t) else t
        n += loc.numel() * loc.element_size()
    return n


def _storage_bytes(tree) -> int:
    """The bytes of the distinct local storages of ``tree``."""
    from repro_torch.launch.comm_analysis import tree_tensors
    seen = {}
    for t in tree_tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = int(st.nbytes())
    return sum(seen.values())


def _place_tree(tree, specs, mesh, rules):
    """Every tensor of ``tree`` laid out by its logical spec in
    ``specs`` (the same structure, tuples at the leaves); each rank's
    slice a storage of its own, as a rank would hold it."""
    import torch
    from repro_torch.models import sharding as S
    if isinstance(tree, torch.Tensor):
        return S.place(tree, mesh, S.placements(specs, mesh, rules))
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh, rules)
                for k, v in tree.items()}
    return [_place_tree(v, s, mesh, rules) for v, s in zip(tree, specs)]


def _trace_cell(cfg, shape, mesh_name: str, q_chunk: int, k_chunk: int,
                step: bool = True, attn_impl: str = "pairs") -> dict:
    """One config's state laid out on the fake mesh and, with ``step``,
    its step traced under the recorder with attention schedule
    ``attn_impl``.  Returns the rank's argument bytes (``memory``), and
    with ``step`` its peak, temporaries, output, flops, unfused bytes and
    collective records; ``attn_impl`` is the schedule the step ran under,
    read inside the step's process."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.comm_analysis import StepRecorder, tree_tensors
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import common as C
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    from repro_torch.models.attention import get_attn_impl, use_attn_impl
    # the FFN imports it on its first call: imported under the recorder,
    # its module-level constants would count in a process's first trace
    from repro_torch.sparse import sparse_ffn  # noqa: F401
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedules import cosine
    from repro_torch.train.step import (make_train_step, place_batch,
                                        train_state_shardings)

    multi = mesh_name == "multi"
    _fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rules = S.rules_for(shape.kind, shape.global_batch, mesh_shape)
    model = build_model(cfg, device="cpu")
    t0 = time.time()
    mem = {}
    rec = StepRecorder()
    with FakeTensorMode(allow_non_fake_inputs=True), S.use_rules(rules), \
            use_attn_impl(attn_impl):
        ran_under = get_attn_impl()
        param_sh, opt_sh = train_state_shardings(model, mesh, rules)

        def placer(t, spec):
            return S.place(t, mesh, S.placements(spec, mesh, rules))
        with C.placing(placer):
            params = model.build(C.NoDraw("cpu"))
        mem["params_bytes"] = _local_bytes(params.parameters())
        batch, specs = model.input_specs(shape, device="cpu")
        if shape.kind == "train":
            opt = AdamW(lr_fn=cosine(3e-4, 100, 10_000))
            opt_state = opt.init(params, shardings=opt_sh)
            mem["opt_state_bytes"] = _local_bytes(
                [*opt_state.m.values(), *opt_state.v.values(),
                 *opt_state.master.values()])
            batch = place_batch(batch, mesh)
            mem["batch_bytes"] = _local_bytes(batch.values())
            args = (params, opt_state, batch)
            run = make_train_step(model, opt, remat=True, q_chunk=q_chunk,
                                  k_chunk=k_chunk)
        elif shape.kind == "prefill":
            batch = place_batch(batch, mesh)
            mem["batch_bytes"] = _local_bytes(batch.values())
            args = (params, batch)

            def run(params, batch):
                return model.prefill(params, batch, max_len=shape.seq_len,
                                     q_chunk=q_chunk, k_chunk=k_chunk)
        else:
            cache = _place_tree(batch["cache"], specs["cache"], mesh, rules)
            toks = _place_tree({"tokens": batch["tokens"],
                                "pos": batch["pos"]},
                               {"tokens": specs["tokens"],
                                "pos": specs["pos"]}, mesh, rules)
            mem["cache_bytes"] = _local_bytes(tree_tensors(cache))
            mem["batch_bytes"] = _local_bytes(toks.values())
            args = (params, cache, toks["tokens"], toks["pos"])
            run = model.decode_step
        if step:
            rec.hold(*args)
            with rec:
                out = run(*args)
            mem["output_size_in_bytes"] = _storage_bytes(out)
            del out
        del args
    mem["argument_size_in_bytes"] = (mem["params_bytes"]
                                     + mem.get("opt_state_bytes", 0)
                                     + mem.get("cache_bytes", 0)
                                     + mem["batch_bytes"])
    if step:
        mem["peak_bytes"] = rec.peak_bytes
        mem["temp_size_in_bytes"] = (rec.peak_bytes
                                     - mem["argument_size_in_bytes"])
    return {"memory": mem, "flops": rec.flops, "bytes": rec.bytes,
            "collectives": rec.collectives,
            "seconds": time.time() - t0, "chips": mesh.size(),
            "rules": rules, "attn_impl": ran_under}


@dataclasses.dataclass(frozen=True)
class DepthVariant:
    """One layer kind of a depth plan: ``small1`` holds the base (the
    layers outside the periods) and one unit of ``kind`` (a layer, or
    of a multi-kind pattern a period), ``small2`` one unit more;
    ``count`` is the kind's units over the full depth."""
    kind: str
    small1: object
    small2: object
    count: int


def _depth_variants(cfg) -> list:
    """The depth plan: the shallow configs whose traces give the full
    depth's counts, as a list of :class:`DepthVariant`.

    A pattern is taken a period at a time: base + 1 and base + 2
    periods, the base the layers outside the periods (deepseek-moe-16b's
    dense first layer, gemma3-4b's four trailing local layers), the kind
    counted over the periods.  For a uniform pattern (one layer a
    period) this is the reference's plan.  For a multi-kind one
    (gemma3's 5:1 local:global, recurrentgemma's recurrent/local; kind
    ``"period"``) the reference traces each kind alone at 1 and 2
    layers; in the port a layer's counts depend on the layers around
    it -- DTensor redistributes a layer's input from the layout the
    layer before it left (recurrentgemma-2b's long_500k decode: a
    recurrent layer after a recurrent one reads 8 x the flops of the
    first), and the train step recomputes a whole period in its
    backward and runs the layers outside the periods without remat.

    An encoder-decoder's encoder scales with its decoder (1 and 2
    encoder layers); when its depth differs from the decoder's it is a
    kind of its own (``"encoder"``), whose pair shares the decoder's
    first config."""
    from repro_torch.models.transformer import make_plan
    plan = make_plan(cfg, cfg.n_layers)
    replace = dataclasses.replace
    k = len(plan.period_kinds)
    base = len(plan.prefix_kinds) + len(plan.suffix_kinds)
    kind = plan.period_kinds[0] if k == 1 else "period"
    count = plan.n_periods
    if cfg.is_encdec and cfg.enc_layers != count:
        small1 = replace(cfg, n_layers=base + k, enc_layers=1)
        return [DepthVariant(kind, small1,
                             replace(small1, n_layers=base + 2 * k), count),
                DepthVariant("encoder", small1,
                             replace(small1, enc_layers=2), cfg.enc_layers)]
    e1, e2 = (1, 2) if cfg.is_encdec else (0, 0)
    return [DepthVariant(kind, replace(cfg, n_layers=base + k, enc_layers=e1),
                         replace(cfg, n_layers=base + 2 * k, enc_layers=e2),
                         count)]


def _at(variants, units):
    """The config with ``units[i]`` units of ``variants[i]``'s kind."""
    c = variants[0].small1
    for v, u in zip(variants, units):
        c = dataclasses.replace(
            c, n_layers=c.n_layers + (u - 1) * (v.small2.n_layers
                                                - v.small1.n_layers),
            enc_layers=c.enc_layers + (u - 1) * (v.small2.enc_layers
                                                 - v.small1.enc_layers))
    return c


def _peak_configs(variants, step_kind: str):
    """The peak's configs: two units of every kind, and for each kind
    that config with one unit more (one unit less for a prefill)."""
    n, d = len(variants), -1 if step_kind == "prefill" else 1
    return (_at(variants, [2] * n),
            [_at(variants, [2 + d * (i == j) for j in range(n)])
             for i in range(n)])


def traced_configs(variants, step_kind: str) -> list:
    """Every config the plan traces for a step of ``step_kind``: the
    counts' (:func:`_depth_variants`' pairs) and the peak's."""
    two, side = _peak_configs(variants, step_kind)
    return list(dict.fromkeys([variants[0].small1,
                               *(v.small2 for v in variants), two, *side]))


def _needs_variants(cfg, variants, step_kind: str) -> bool:
    """Whether the full depth is deeper than the plan's deepest config
    (else the cell is traced whole)."""
    cfgs = traced_configs(variants, step_kind)
    return (cfg.n_layers > max(c.n_layers for c in cfgs)
            or cfg.enc_layers > max(c.enc_layers for c in cfgs))


def _counts(trace: dict) -> dict:
    """A trace's additive counts, all integers: flops, unfused bytes,
    output bytes, and per (op, group) the collectives and their result
    bytes."""
    out = {"flops": trace["flops"], "bytes": trace["bytes"],
           "output": trace["memory"]["output_size_in_bytes"]}
    for r in trace["collectives"]:
        for key, v in ((("n", r["op"], r["group"]), 1),
                       (("bytes", r["op"], r["group"]), r["bytes"])):
            out[key] = out.get(key, 0) + v
    return out


def _combine(terms) -> dict:
    """sum(a * c for a, c in terms), key by key."""
    out = {}
    for a, c in terms:
        for k, v in c.items():
            out[k] = out.get(k, 0) + a * v
    return out


def extrapolate(variants, traces, args_bytes: int, step_kind: str) -> dict:
    """The full depth's counts from the plan's traces (``traces[cfg]``
    for every config of :func:`traced_configs`, each ``_trace_cell``'s),
    in integer arithmetic.

    Every additive count ``c`` is ``c(small1) + sum_k (count_k - 1) *
    (c(small2_k) - c(small1))``: every unit adds the same.

    The peak is ``args + temp(two) + sum_k (count_k - 2) * slope_k``,
    ``two`` the config with two units of every kind: a model's first
    unit takes its input from the embedding and its step may peak in
    another phase (qwen2.5-14b's prefill keeps 58.7 MB at its first
    layer, 16.8 MB at each after), so the line starts at the second.
    ``slope_k`` is what a unit of the kind keeps to the peak, read off
    ``two`` and the config one unit of the kind away from it: a train or
    decode step's temporaries one unit deeper (a train step's saved
    activations and gradients, where its backward peaks; qwen2.5-14b's
    decode temporaries grow 80 kB from one layer to two and not after),
    a prefill's output one unit shallower (the cache a layer adds: its
    third unit at 32k tokens would not trace in ten minutes).  Returns ``{"counts", "peak_bytes", "slopes"}``."""
    first = variants[0].small1
    c1 = _counts(traces[first])
    counts = _combine([(1, c1)] + [
        (v.count - 1, _combine([(1, _counts(traces[v.small2])), (-1, c1)]))
        for v in variants])
    key = "output_size_in_bytes" if step_kind == "prefill" \
        else "temp_size_in_bytes"
    two, side = _peak_configs(variants, step_kind)
    d = -1 if step_kind == "prefill" else 1
    slopes = [d * (traces[c]["memory"][key] - traces[two]["memory"][key])
              for c in side]
    peak = (args_bytes + traces[two]["memory"]["temp_size_in_bytes"]
            + sum((v.count - 2) * s for v, s in zip(variants, slopes)))
    return {"counts": counts, "peak_bytes": peak, "slopes": slopes}


def extrapolated_cost(cfg, shape, mesh_name: str, *, q_chunk: int = 512,
                      k_chunk: int = 512, attn_impl: str = "pairs") -> dict:
    """The full depth's counts of one cell from the depth plan's
    traces (:func:`_depth_variants`, :func:`traced_configs`), each at
    the cell's own sequence and chunks and in a process of its own, all
    at once (a prefill_32k cell's longest trace, seamless-m4t-medium's
    two encoder and two decoder layers over 32k frames and tokens,
    takes about six minutes); the arguments laid out at full depth with
    no step.  Unlike the reference's, no sequence polynomial is fitted:
    the reference fits one because an unrolled 32k compile cost too
    much, while a layer of the port's trace at 32k takes one to three
    minutes.  Returns ``{"flops", "bytes", "collective_raw", "memory",
    "chips", "rules", "n_variant_traces", "variants", "trace_s",
    "state_s", "wall_s", "traced"}``: ``variants`` each kind's count
    and its pair's depths, ``traced`` every config traced with its
    temporaries, output bytes and the attention schedule its process ran
    (``attn_impl``, passed to each trace: the parent's switch does not
    reach a process forked from the forkserver), ``trace_s`` the sum of
    the variants' traces, ``wall_s`` the whole call's."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch.comm_analysis import collective_bytes
    t0 = time.time()
    variants = _depth_variants(cfg)
    cfgs = traced_configs(variants, shape.kind)
    work = [(c, True) for c in cfgs] + [(cfg, False)]
    n = len(work)
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    with ProcessPoolExecutor(n, mp_context=ctx) as pool:
        done = list(pool.map(_trace_cell, [c for c, _ in work], [shape] * n,
                             [mesh_name] * n, [q_chunk] * n, [k_chunk] * n,
                             [step for _, step in work], [attn_impl] * n))
    traces, state = dict(zip(cfgs, done[:-1])), done[-1]
    mem = dict(state["memory"])
    ex = extrapolate(variants, traces, mem["argument_size_in_bytes"],
                     shape.kind)
    counts = ex["counts"]
    mem["output_size_in_bytes"] = counts["output"]
    mem["peak_bytes"] = ex["peak_bytes"]
    mem["temp_size_in_bytes"] = (ex["peak_bytes"]
                                 - mem["argument_size_in_bytes"])
    coll = collective_bytes(
        [{"op": op, "group": g, "count": n,
          "bytes": counts[("bytes", op, g)]}
         for (what, op, g), n in ((k, v) for k, v in counts.items()
                                  if isinstance(k, tuple))
         if what == "n"])
    return {"flops": counts["flops"], "bytes": counts["bytes"],
            "collective_raw": coll, "memory": mem,
            "chips": state["chips"], "rules": state["rules"],
            "n_variant_traces": len(traces),
            "variants": [{"kind": v.kind, "count": v.count,
                          "n_layers": [v.small1.n_layers, v.small2.n_layers],
                          "enc_layers": [v.small1.enc_layers,
                                         v.small2.enc_layers]}
                         for v in variants],
            "traced": [{"n_layers": c.n_layers, "enc_layers": c.enc_layers,
                        **{k: traces[c]["memory"][k] for k in (
                            "temp_size_in_bytes", "output_size_in_bytes")},
                        "attn_impl": traces[c]["attn_impl"]}
                       for c in cfgs],
            "trace_s": sum(t["seconds"] for t in traces.values()),
            "state_s": state["seconds"], "wall_s": time.time() - t0}


def dryrun_cell(arch: str, shape_name: str, mesh_name: str,
                q_chunk: int = 512, k_chunk: int = 512,
                with_cost: bool = True, attn_impl: str = "pairs",
                overrides: dict | None = None) -> dict:
    """One cell's record on the fake mesh: with ``with_cost`` from the
    depth plan's traces (:func:`extrapolated_cost`), without it (or
    when the full depth is no deeper than the plan's configs) from a
    trace of the full depth; attention under schedule ``attn_impl``
    (the reference's knob, in the record as ``"attn_impl"``)."""
    from repro_torch.models.attention import ATTN_IMPLS
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: not one of {ATTN_IMPLS}")
    if (arch, shape_name) in SKIP:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": SKIP[(arch, shape_name)]}
    from repro_torch import configs
    from repro_torch.launch.comm_analysis import collective_bytes

    cfg = configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = configs.SHAPES[shape_name]
    extrapolated = with_cost and _needs_variants(cfg, _depth_variants(cfg),
                                                 shape.kind)
    if extrapolated:
        ex = extrapolated_cost(cfg, shape, mesh_name, q_chunk=q_chunk,
                               k_chunk=k_chunk, attn_impl=attn_impl)
        flops, byts, coll = ex["flops"], ex["bytes"], ex["collective_raw"]
        seconds = ex["trace_s"]
    else:
        ex = _trace_cell(cfg, shape, mesh_name, q_chunk, k_chunk,
                         attn_impl=attn_impl)
        flops, byts = ex["flops"], ex["bytes"]
        coll = collective_bytes(ex["collectives"])
        seconds = ex["seconds"]
    out = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": ex["chips"],
        "attn_impl": attn_impl,
        "overrides": overrides or {},
        "trace_s": round(seconds, 1),
        "q_chunk": q_chunk, "k_chunk": k_chunk,
        "flops_per_rank": flops,
        "hlo_bytes_raw": byts,
        "collective_raw": coll,
        "memory": ex["memory"],
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "tokens": shape.global_batch * (1 if shape.kind == "decode"
                                        else shape.seq_len),
        "rules": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in ex["rules"].items()},
    }
    if with_cost:
        out["cost"] = {"flops": float(flops), "bytes": float(byts),
                       "bytes_kind": BYTES_KIND,
                       "collective_bytes": coll["total"],
                       "extrapolated": extrapolated}
        if extrapolated:
            out["cost"].update({k: ex[k] for k in (
                "n_variant_traces", "variants", "traced", "state_s",
                "wall_s")})
    return out


def main(argv=None) -> None:
    from repro_torch import configs
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the depth variants: trace the full depth, "
                    "no cost entry")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--k-chunk", type=int, default=512)
    ap.add_argument("--attn-impl", default="pairs", choices=["pairs",
                                                             "qloop"])
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    for mesh_name in meshes:
        outdir = os.path.join(args.out, mesh_name)
        os.makedirs(outdir, exist_ok=True)
        for arch in archs:
            for shape in shapes:
                fname = os.path.join(outdir, f"{arch}__{shape}.json")
                if os.path.exists(fname) and not args.force:
                    print(f"[skip-existing] {mesh_name}/{arch}/{shape}")
                    continue
                print(f"[dryrun] {mesh_name}/{arch}/{shape} ...", flush=True)
                try:
                    rec = dryrun_cell(arch, shape, mesh_name,
                                      q_chunk=args.q_chunk,
                                      k_chunk=args.k_chunk,
                                      with_cost=not args.no_cost,
                                      attn_impl=args.attn_impl)
                except Exception as e:  # noqa: BLE001 - record and continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-2000:]}
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
                extra = ""
                if rec["status"] == "ok":
                    extra = (f" flops/rank={rec['flops_per_rank']:.3e}"
                             f" bytes={rec['hlo_bytes_raw']:.3e}"
                             f" peak={rec['memory']['peak_bytes']:.3e}"
                             f" coll={rec['collective_raw']['total']:.3e}B"
                             f" {rec['trace_s']}s")
                print(f"[done] {mesh_name}/{arch}/{shape}: "
                      f"{rec['status']}{extra}", flush=True)


if __name__ == "__main__":
    main()
