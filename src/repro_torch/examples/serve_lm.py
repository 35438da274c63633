"""Batched serving: continuous batching with the LM ``Engine``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Six greedy requests of 4 + 3 i prompt tokens over four cache slots of
128 positions, on gemma3-4b's smoke config (its local:global attention
pattern, windows included), with random weights from seed 0.
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

ARCH = "gemma3-4b"
SLOTS, MAX_LEN, N_REQUESTS, MAX_NEW = 4, 128, 6, 8


def build(device):
    """(cfg, model, params) of the example, on ``device``."""
    cfg = configs.smoke(ARCH)   # local:global pattern incl. windows
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    return cfg, model, params


def requests(cfg) -> list:
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, (4 + 3 * i,))
                    .astype(np.int32),
                    max_new=MAX_NEW)
            for i in range(N_REQUESTS)]


def serve(model, params, reqs, slots: int = SLOTS) -> list:
    eng = Engine(model, params, batch_slots=slots, max_len=MAX_LEN)
    eng.run(reqs, max_ticks=500)
    return reqs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, model, params = build(dev)
    reqs = requests(cfg)
    t0 = time.perf_counter()
    serve(model, params, reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out) for r in reqs)
    for r in reqs:
        print(f"req {r.rid}: prompt_len={len(r.prompt)} -> {r.out}")
    print(f"{total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s on {dev.type}, batched over "
          f"{SLOTS} slots)")
    return {"arch": cfg.name, "slots": SLOTS, "max_len": MAX_LEN,
            "prompts": [r.prompt.tolist() for r in reqs],
            "tokens": [list(map(int, r.out)) for r in reqs],
            "done": [bool(r.done) for r in reqs],
            "new_tokens": total_new, "seconds": dt,
            "tokens_per_s": total_new / dt}


if __name__ == "__main__":
    main()
