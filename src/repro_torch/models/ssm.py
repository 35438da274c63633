"""Mamba-1 (selective SSM) block: falcon-mamba-7b's layer kind.

Port of ``repro/models/ssm.py``.  Prefill (``mamba_apply_train``) runs
the recurrence through :func:`~.scan_utils.chunked_linear_scan`;
decode is one step of it on the carried state: the conv tail (B, W-1,
d_inner) and ``h`` (B, d_inner, d_state) in float32.
:func:`mamba_apply_decode` writes both into the cache it is given, in
place, so a cache built of views (the LM engine's batch-1 slot) is
updated through.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import common as C
from .scan_utils import causal_conv1d, chunked_linear_scan
from .sharding import is_dtensor, shard

__all__ = ["mamba_init", "mamba_apply_train", "mamba_apply_decode",
           "mamba_cache_init", "mamba_cache_specs"]


def mamba_init(gen: torch.Generator, cfg, dtype) -> nn.ParameterDict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r, cw = max(cfg.dt_rank, 1), cfg.conv_width
    dev = gen.device
    p = nn.ParameterDict()
    col, row = (None, "model"), ("model", None)
    p["in_proj"] = C.dense_init(gen, d, 2 * di, dtype, spec=col)
    p["conv_w"] = C.param(C.normal(gen, (cw, di), 1.0 / math.sqrt(cw),
                                   dtype), col)
    p["conv_b"] = C.param(torch.zeros(di, dtype=dtype, device=dev),
                          ("model",))
    p["x_proj"] = C.dense_init(gen, di, r + 2 * n, dtype, spec=row)
    p["dt_proj"] = C.dense_init(gen, r, di, dtype, bias=True, spec=col)
    # S4D-real initialisation of A
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    p["A_log"] = C.param(torch.log(a).expand(di, n).contiguous(), row)
    p["D"] = C.param(torch.ones(di, dtype=torch.float32, device=dev),
                     ("model",))
    p["out_proj"] = C.dense_init(gen, di, d, dtype, spec=row)
    return p


def _split_in_proj(xz: torch.Tensor):
    """(x, z) halves of the packed in-projection.  Its packed dim is
    split over the model axis, so the halves live on different ranks:
    the packed output is gathered first, whose backward slices the
    gradient back to each rank's columns (the in-projection's weight
    gradient then stays a rank's own)."""
    if is_dtensor(xz):
        from torch.distributed.tensor import Replicate, Shard
        pls = [Replicate() if isinstance(pl, Shard) and pl.dim == 2 else pl
               for pl in xz.placements]
        xz = xz.redistribute(xz.device_mesh, pls)
    return xz.chunk(2, dim=-1)


def _ssm_inputs(p, cfg, x_conv: torch.Tensor):
    """x_conv (B, S, di), the activations after the conv.  Returns the
    discretised decay and input (B, S, di, n), float32, and C (B, S,
    n)."""
    n, r = cfg.ssm_state, max(cfg.dt_rank, 1)
    # the small (r + 2n) row-parallel projection reduced once, so that
    # dt_proj runs column-parallel on it (left partial, DTensor gathers
    # dt_proj's weight and reduces the full-width dt instead)
    proj = shard(C.dense_apply(p["x_proj"], x_conv), "batch", None, None)
    dt_in, b_in, c_in = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(C.dense_apply(p["dt_proj"], dt_in).float())
    a_mat = -torch.exp(p["A_log"].float())                    # (di, n)
    da = torch.exp(dt[..., None] * a_mat)                     # (B,S,di,n)
    dbx = (dt * x_conv.float())[..., None] * b_in.float()[..., None, :]
    return da, dbx, c_in


def mamba_apply_train(p, cfg, x: torch.Tensor, ssm_chunk: int | None = None):
    """x (B, S, D), normalised.  Returns (out, {"conv", "h"}): the state
    after the sequence, conv tail in x's dtype, h float32."""
    b = x.shape[0]
    xs, z = _split_in_proj(C.dense_apply(p["in_proj"], x))
    xs = shard(xs, "batch", None, "model")
    xc, conv_state = causal_conv1d(xs, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    da, dbx, c_in = _ssm_inputs(p, cfg, xc)
    h0 = torch.zeros((b, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                     device=x.device)
    chunk = ssm_chunk if ssm_chunk is not None else cfg.ssm_scan_chunk
    h_all, h_last = chunked_linear_scan(da, dbx, h0, chunk=chunk)
    y = torch.einsum("bsdn,bsn->bsd", h_all, c_in.float())
    y = y + p["D"].float() * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = shard(C.dense_apply(p["out_proj"], y), "batch", None, None)
    return out, {"conv": conv_state, "h": h_last}


def mamba_apply_decode(p, cfg, x: torch.Tensor, cache: dict):
    """One step.  x (B, 1, D); ``cache`` {"conv", "h"} is written in
    place.  Returns (out, cache)."""
    xs, z = _split_in_proj(C.dense_apply(p["in_proj"], x))
    xc, conv_state = causal_conv1d(xs, p["conv_w"], p["conv_b"],
                                   state=cache["conv"])
    xc = F.silu(xc)
    da, dbx, c_in = _ssm_inputs(p, cfg, xc)                   # S = 1
    h = da[:, 0] * cache["h"] + dbx[:, 0]                      # (B,di,n)
    y = torch.einsum("bdn,bn->bd", h, c_in[:, 0].float())
    y = y + p["D"].float() * xc[:, 0].float()
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = C.dense_apply(p["out_proj"], y[:, None])
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return out, cache


def mamba_cache_specs() -> dict:
    return {"conv": ("batch", None, "model"), "h": ("batch", "model", None)}


def mamba_cache_init(cfg, batch: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    di = cfg.d_inner
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }
