"""RG-LRU recurrent block: recurrentgemma-2b's temporal-mixing layer.

Port of ``repro/models/rglru.py`` (arXiv:2402.19427, with the
reference's per-channel gates in place of the published block-diagonal
ones)::

    r_t = sigmoid(w_a x_t + b_a)        recurrence gate
    i_t = sigmoid(w_x x_t + b_x)        input gate
    a_t = exp(-c softplus(lam) r_t)     per-channel decay, c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

wrapped in the conv1d and the GeLU-gated output of the paper's
recurrent block.  As in ``ssm.py``, prefill runs the chunked scan and
:func:`rglru_apply_decode` writes the conv tail and ``h`` (float32)
into the cache it is given, in place.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import common as C
from .scan_utils import causal_conv1d, chunked_linear_scan
from .sharding import shard

__all__ = ["rglru_init", "rglru_apply_train", "rglru_apply_decode",
           "rglru_cache_init", "rglru_cache_specs"]

_C = 8.0


def rglru_init(gen: torch.Generator, cfg, dtype) -> nn.ParameterDict:
    d, di, cw = cfg.d_model, cfg.d_inner, cfg.conv_width
    dev = gen.device

    def zeros(dt=torch.float32):
        return C.param(torch.zeros(di, dtype=dt, device=dev), ("model",))
    col, row = (None, "model"), ("model", None)
    p = nn.ParameterDict()
    p["in_x"] = C.dense_init(gen, d, di, dtype, spec=col)
    p["in_gate"] = C.dense_init(gen, d, di, dtype, spec=col)
    p["conv_w"] = C.param(C.normal(gen, (cw, di), 1.0 / math.sqrt(cw),
                                   dtype), col)
    p["conv_b"] = zeros(dtype)
    for k in ("w_a", "b_a", "w_x", "b_x"):     # the diagonal gates
        p[k] = zeros()
    # lam such that a^c lies in [0.9, 0.999], as in the paper
    u = C.uniform(gen, (di,), 0.9 ** 2, 0.999 ** 2)
    p["lam"] = C.param(torch.log(torch.expm1(-torch.log(u) / _C)),
                       ("model",))
    p["out"] = C.dense_init(gen, di, d, dtype, spec=row)
    return p


def _gates(p, xc: torch.Tensor):
    x32 = xc.float()
    r = torch.sigmoid(p["w_a"] * x32 + p["b_a"])
    i = torch.sigmoid(p["w_x"] * x32 + p["b_x"])
    log_a = -_C * nn.functional.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x32)
    return a, b


def rglru_apply_train(p, cfg, x: torch.Tensor,
                      scan_chunk: int | None = None):
    """x (B, S, D), normalised.  Returns (out, {"conv", "h"})."""
    b = x.shape[0]
    gelu = C.activation("gelu")
    gate = gelu(C.dense_apply(p["in_gate"], x))
    xs = shard(C.dense_apply(p["in_x"], x), "batch", None, "model")
    xc, conv_state = causal_conv1d(xs, p["conv_w"], p["conv_b"])
    a, bb = _gates(p, xc)
    h0 = torch.zeros((b, cfg.d_inner), dtype=torch.float32, device=x.device)
    chunk = scan_chunk if scan_chunk is not None else cfg.ssm_scan_chunk
    h_all, h_last = chunked_linear_scan(a, bb, h0, chunk=chunk)
    out = C.dense_apply(p["out"], h_all.to(x.dtype) * gate)
    return shard(out, "batch", None, None), {"conv": conv_state,
                                             "h": h_last}


def rglru_apply_decode(p, cfg, x: torch.Tensor, cache: dict):
    """One step.  x (B, 1, D); ``cache`` {"conv", "h"} is written in
    place.  Returns (out, cache)."""
    gelu = C.activation("gelu")
    gate = gelu(C.dense_apply(p["in_gate"], x))
    xs = C.dense_apply(p["in_x"], x)
    xc, conv_state = causal_conv1d(xs, p["conv_w"], p["conv_b"],
                                   state=cache["conv"])
    a, b = _gates(p, xc)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = C.dense_apply(p["out"], h[:, None].to(x.dtype) * gate)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return out, cache


def rglru_cache_specs() -> dict:
    return {"conv": ("batch", None, "model"), "h": ("batch", "model")}


def rglru_cache_init(cfg, batch: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    di = cfg.d_inner
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, di), dtype=torch.float32, device=device),
    }
