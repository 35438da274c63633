"""Serving launcher: the continuous-batching engine over a request stream.

Port of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
        [--slots 4] [--requests 8] [--max-new 16] [--device cpu]

``--arch`` takes any of the ten ids of ``repro_torch.configs.ARCH_IDS``.
The model runs on CUDA unless ``--device cpu`` is given.  ``--smoke``
(the default) builds the family's reduced config; ``--no-smoke`` builds
the published one.  That is a deliberate difference: the reference's
flag is ``store_true`` with ``default=True``, so its full-size branch
can never run.  Weights are random, drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels._backend import resolve_device
from repro_torch.models.api import build_model
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)

    eng = Engine(model, params, batch_slots=args.slots, max_len=args.max_len)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, (4 + i % 13,))
                    .astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    eng.run(reqs)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs)
    print(f"{len(reqs)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s, {args.slots} slots, {dev})")
    for r in reqs[:4]:
        print(f"  req {r.rid}: {list(r.prompt[:4])}... -> {r.out[:8]}")


if __name__ == "__main__":
    main()
