"""Training launcher.

Port of ``repro/launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        [--smoke] [--steps N] [--mesh host|single] [--ckpt DIR] \\
        [--device cpu] [--n-layers N] [--enc-layers N]

The reference's flags, plus ``--device``: the model trains on CUDA
unless ``--device cpu`` is given, and with neither it raises.  The
published config is the default; ``--smoke`` builds the family's reduced
one.  ``--n-layers`` / ``--enc-layers`` cut the chosen config's depth
(decoder layers, an encoder-decoder's encoder layers) and keep its
widths: a quick run of a published model's layer shapes.  Weights are random (``torch.Generator`` seeded 0), the data
synthetic (``data.pipeline.for_config``, seed 0); the step is
``make_train_step(model, AdamW(schedule), q_chunk=128, k_chunk=128)``
with rematerialisation, the schedule WSD (or cosine) over ``--steps``
at peak ``--lr``.  It auto-resumes from the latest committed checkpoint
in ``--ckpt``.  :func:`main` returns the loop's history.

Meshes.  Run alone (no process group, no ``WORLD_SIZE`` above 1) the
launcher trains on one device, as before.  Under ``torchrun`` (or any
launcher that sets ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and the
rendezvous address; or with a process group already joined) every rank
runs :func:`main`, one card each (NCCL; gloo with ``--device cpu``):

--mesh host   : the reference's 1-D ``data`` mesh over the world with
                rules ``model=None``: data parallelism, the batch split
                over the ranks and the optimizer state ZeRO-1-sharded
                over ``data``.
--mesh single : the production (16, 16) (data, model) mesh with
                ``DEFAULT_SINGLE_POD``; it raises off a 256-rank world,
                as the reference says it is only valid on hardware of
                that size (``launch.dryrun`` builds a fake one).

Every rank draws the same weights and batches; each keeps its slices
(``train.step.init_sharded``, ``place_batch``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from repro_torch import configs
from repro_torch.data.pipeline import for_config
from repro_torch.kernels._backend import resolve_device
from repro_torch.launch import mesh as LM
from repro_torch.models import sharding as S
from repro_torch.models.api import build_model
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamW
from repro_torch.train.schedules import cosine, wsd
from repro_torch.train.step import (init_sharded, make_train_step,
                                    train_state_shardings)

HOST_RULES = {"batch": ("data",), "model": None, "expert": None,
              "seq": None, "kvseq": None}


def _multi_rank() -> bool:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return True
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="wsd", choices=["wsd", "cosine"])
    ap.add_argument("--mesh", default="host", choices=["host", "single"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (decoder layers); widths stay")
    ap.add_argument("--enc-layers", type=int, default=None,
                    help="cut an encoder-decoder's encoder layers")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    depth = {k: v for k, v in (("n_layers", args.n_layers),
                               ("enc_layers", args.enc_layers))
             if v is not None}
    if depth:
        cfg = dataclasses.replace(cfg, **depth)
    dev = resolve_device(args.device)
    sharded = args.mesh == "single" or _multi_rank()
    if sharded:
        import torch.distributed as dist
        if _multi_rank() and not dist.is_initialized():
            dev = LM.join(dev)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        if args.mesh == "single":
            mesh = LM.make_production_mesh()
            rules = dict(S.DEFAULT_SINGLE_POD)
        else:
            mesh = LM.make_host_mesh()
            rules = dict(HOST_RULES)
    model = build_model(cfg, device=dev)
    lr_fn = (wsd(args.lr, warmup=max(args.steps // 10, 1),
                 stable=args.steps // 2, decay=args.steps // 3)
             if args.schedule == "wsd"
             else cosine(args.lr, max(args.steps // 10, 1), args.steps))
    opt = AdamW(lr_fn=lr_fn)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = make_train_step(model, opt, q_chunk=128, k_chunk=128)
    data = for_config(cfg, batch=args.batch, seq=args.seq)
    if not sharded:
        params = model.init(gen)
        opt_state = opt.init(params)
        n = sum(p.numel() for p in params.parameters())
        print(f"arch={cfg.name} params={n/1e6:.1f}M device={dev}")
        _, _, history = train(step_fn=step, params=params,
                              opt_state=opt_state, data=data,
                              steps=args.steps, ckpt_dir=args.ckpt,
                              ckpt_every=args.ckpt_every)
        return history
    with S.use_rules(rules):
        _, opt_sh = train_state_shardings(model, mesh, rules)
        params = init_sharded(model, gen, mesh, rules)
        opt_state = opt.init(params, shardings=opt_sh)
        n = sum(p.numel() for p in params.parameters())
        print(f"arch={cfg.name} params={n/1e6:.1f}M "
              f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"devices={mesh.size()}")
        _, _, history = train(step_fn=step, params=params,
                              opt_state=opt_state, data=data,
                              steps=args.steps, ckpt_dir=args.ckpt,
                              ckpt_every=args.ckpt_every)
    return history


if __name__ == "__main__":
    main()
