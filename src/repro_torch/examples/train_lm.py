"""End-to-end training driver: a ~100 M-parameter model of a chosen
family for a few hundred steps with the production substrate (AdamW +
WSD, checkpoints, auto-resume, the straggler watchdog).

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        [--steps 200] [--arch ID] [--batch 8] [--seq 256] [--ckpt DIR] \\
        [--device cpu]

Weights are random (``torch.Generator`` seeded 0), the data synthetic
(``data.pipeline.for_config``).  Without ``--ckpt`` the checkpoints go
to a temporary directory that is removed at the end; with it, a second
run resumes from the latest committed step.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch import configs
from repro_torch.data.pipeline import for_config
from repro_torch.kernels._backend import resolve_device
from repro_torch.models.api import build_model
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamW
from repro_torch.train.schedules import wsd
from repro_torch.train.step import make_train_step


def hundred_m(arch: str) -> configs.ArchConfig:
    """Scale the chosen architecture family down to ~100M params."""
    cfg = configs.get(arch)
    return dataclasses.replace(
        cfg, n_layers=8, d_model=640, n_heads=10,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 5)), d_ff=2048,
        head_dim=64, vocab=32_000, window=min(cfg.window, 256),
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_inner=1024 if cfg.d_inner else 0,
        dt_rank=32 if cfg.dt_rank else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        frontend_seq=64 if cfg.frontend_seq else 0,
        param_dtype="float32", activation_dtype="float32",
        name=f"{arch}-100m")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = hundred_m(args.arch)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch} seq={args.seq}")

    opt = AdamW(lr_fn=wsd(3e-4, warmup=20, stable=args.steps // 2,
                          decay=args.steps // 3))
    opt_state = opt.init(params)
    step = make_train_step(model, opt, q_chunk=128, k_chunk=128)
    data = for_config(cfg, batch=args.batch, seq=args.seq)

    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        params, opt_state, hist = train(
            step_fn=step, params=params, opt_state=opt_state, data=data,
            steps=args.steps, ckpt_dir=args.ckpt or tmp, ckpt_every=50,
            log_every=10)
    losses = hist["losses"]
    if losses:
        print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f}); "
              f"stragglers flagged: {len(hist['stragglers'])}")
    return {"arch": cfg.name, "n_params": int(n), "steps": args.steps,
            "batch": args.batch, "seq": args.seq, "losses": losses,
            "stragglers": len(hist["stragglers"]),
            "step_s": list(hist["times"])}


if __name__ == "__main__":
    main()
