"""Training launcher.

Port of ``repro/launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        [--smoke] [--steps N] [--ckpt DIR] [--device cpu]

The reference's flags, plus ``--device``: the model trains on CUDA
unless ``--device cpu`` is given, and with neither it raises.  The
published config is the default; ``--smoke`` builds the family's reduced
one.  ``--mesh host`` (the default) is one device; ``--mesh single``,
the production mesh, comes with the model across cards (ROADMAP 1.28)
and raises.  Weights are random (``torch.Generator`` seeded 0), the data
synthetic (``data.pipeline.for_config``, seed 0); the step is
``make_train_step(model, AdamW(schedule), q_chunk=128, k_chunk=128)``
with rematerialisation, the schedule WSD (or cosine) over ``--steps``
at peak ``--lr``.  It auto-resumes from the latest committed checkpoint
in ``--ckpt``.  :func:`main` returns the loop's history.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch._todo import not_ported
from repro_torch.data.pipeline import for_config
from repro_torch.kernels._backend import resolve_device
from repro_torch.models.api import build_model
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamW
from repro_torch.train.schedules import cosine, wsd
from repro_torch.train.step import make_train_step


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
    args = ap.parse_args(argv)

    if args.mesh == "single":
        raise not_ported("launch.train --mesh single (the production "
                         "mesh)", "multi_card")
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev)
    lr_fn = (wsd(args.lr, warmup=max(args.steps // 10, 1),
                 stable=args.steps // 2, decay=args.steps // 3)
             if args.schedule == "wsd"
             else cosine(args.lr, max(args.steps // 10, 1), args.steps))
    opt = AdamW(lr_fn=lr_fn)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = opt.init(params)
    n = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n/1e6:.1f}M device={dev}")
    step = make_train_step(model, opt, q_chunk=128, k_chunk=128)
    data = for_config(cfg, batch=args.batch, seq=args.seq)
    _, _, history = train(step_fn=step, params=params, opt_state=opt_state,
                          data=data, steps=args.steps, ckpt_dir=args.ckpt,
                          ckpt_every=args.ckpt_every)
    return history


if __name__ == "__main__":
    main()
