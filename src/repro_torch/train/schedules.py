"""LR schedules, including WSD (warmup-stable-decay) from MiniCPM
(arXiv:2404.06395) -- the schedule minicpm-2b was trained with -- plus
cosine for the other archs.

Port of ``repro/train/schedules.py``: each schedule is a function of a
step tensor (any integer or float dtype, on any device) returning a
float32 lr tensor on the step's device, computed in float32 as the
reference computes it, with no host read.
"""
from __future__ import annotations

import math

import torch

__all__ = ["wsd", "cosine", "constant"]


def wsd(peak_lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.1):
    """Warmup-Stable-Decay: linear warmup, flat plateau, exponential-ish
    decay to final_frac * peak over the decay window."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        dec_t = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
        # log(final_frac) in float32, made on the step's device (no copy)
        dec = peak_lr * torch.exp(torch.log(torch.full_like(s, final_frac))
                                  * dec_t)
        return torch.where(s < warmup, warm,
                           torch.where(s < warmup + stable,
                                       torch.full_like(s, peak_lr), dec))
    return fn


def cosine(peak_lr: float, warmup: int, total: int,
           final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * t))
        return torch.where(s < warmup, warm, peak_lr * cos)
    return fn


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)
