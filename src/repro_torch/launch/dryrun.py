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
traced at.

No depth or sequence extrapolation is needed, unlike the reference's
(``unroll.py`` and ``extrapolated_cost`` exist because XLA counts a
``while`` body once): the port's stack and attention are Python loops,
and the recorder sees every layer and every chunk pair; ``cost`` is
the traced step's own count.

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

__all__ = ["SKIP", "dryrun_cell", "main"]

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


def dryrun_cell(arch: str, shape_name: str, mesh_name: str,
                q_chunk: int = 512, k_chunk: int = 512,
                with_cost: bool = True, overrides: dict | None = None
                ) -> dict:
    """Trace one cell's step on the fake mesh; returns its record."""
    if (arch, shape_name) in SKIP:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": SKIP[(arch, shape_name)]}
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import configs
    from repro_torch.launch.comm_analysis import (StepRecorder,
                                                  collective_bytes,
                                                  tree_tensors)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import common as C
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedules import cosine
    from repro_torch.train.step import (make_train_step, place_batch,
                                        train_state_shardings)

    cfg = configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = configs.SHAPES[shape_name]
    multi = mesh_name == "multi"
    _fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rules = S.rules_for(shape.kind, shape.global_batch, mesh_shape)
    model = build_model(cfg, device="cpu")
    t0 = time.time()
    mem = {}
    with FakeTensorMode(allow_non_fake_inputs=True), S.use_rules(rules):
        param_sh, opt_sh = train_state_shardings(model, mesh, rules)

        def placer(t, spec):
            return S.place(t, mesh, S.placements(spec, mesh, rules))
        with C.placing(placer):
            params = model.build(C.NoDraw("cpu"))
        mem["params_bytes"] = _local_bytes(params.parameters())
        batch, specs = model.input_specs(shape, device="cpu")
        rec = StepRecorder()
        if shape.kind == "train":
            opt = AdamW(lr_fn=cosine(3e-4, 100, 10_000))
            opt_state = opt.init(params, shardings=opt_sh)
            mem["opt_state_bytes"] = _local_bytes(
                [*opt_state.m.values(), *opt_state.v.values(),
                 *opt_state.master.values()])
            batch = place_batch(batch, mesh)
            mem["batch_bytes"] = _local_bytes(batch.values())
            step = make_train_step(model, opt, remat=True, q_chunk=q_chunk,
                                   k_chunk=k_chunk)
            rec.hold(params, opt_state, batch)
            with rec:
                out = step(params, opt_state, batch)
        elif shape.kind == "prefill":
            batch = place_batch(batch, mesh)
            mem["batch_bytes"] = _local_bytes(batch.values())
            rec.hold(params, batch)
            with rec:
                out = model.prefill(params, batch, max_len=shape.seq_len,
                                    q_chunk=q_chunk, k_chunk=k_chunk)
        else:
            cache = _place_tree(batch["cache"], specs["cache"], mesh, rules)
            toks = _place_tree({"tokens": batch["tokens"],
                                "pos": batch["pos"]},
                               {"tokens": specs["tokens"],
                                "pos": specs["pos"]}, mesh, rules)
            mem["cache_bytes"] = _local_bytes(tree_tensors(cache))
            mem["batch_bytes"] = _local_bytes(toks.values())
            rec.hold(params, cache, toks)
            with rec:
                out = model.decode_step(params, cache, toks["tokens"],
                                        toks["pos"])
        mem["output_size_in_bytes"] = _storage_bytes(out)
        del out
    seconds = time.time() - t0
    mem["argument_size_in_bytes"] = (mem["params_bytes"]
                                     + mem.get("opt_state_bytes", 0)
                                     + mem.get("cache_bytes", 0)
                                     + mem["batch_bytes"])
    mem["peak_bytes"] = rec.peak_bytes
    mem["temp_size_in_bytes"] = (rec.peak_bytes
                                 - mem["argument_size_in_bytes"])
    coll = collective_bytes(rec.collectives)
    chips = mesh.size()
    out = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": chips,
        "overrides": overrides or {},
        "trace_s": round(seconds, 1),
        "q_chunk": q_chunk, "k_chunk": k_chunk,
        "flops_per_rank": rec.flops,
        "hlo_bytes_raw": rec.bytes,
        "collective_raw": coll,
        "memory": mem,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "tokens": shape.global_batch * (1 if shape.kind == "decode"
                                        else shape.seq_len),
        "rules": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in rules.items()},
    }
    if with_cost:
        out["cost"] = {"flops": float(rec.flops),
                       "bytes": float(rec.bytes),
                       "bytes_kind": BYTES_KIND,
                       "collective_bytes": coll["total"],
                       "extrapolated": False}
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
                    help="leave the cost entry out of the record")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--k-chunk", type=int, default=512)
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
                                      with_cost=not args.no_cost)
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
