"""Shared model pieces: init helpers, RMSNorm, RoPE, activations.

Port of ``repro/models/common.py``.  Parameters live in the reference's
tree shape: a dense layer is an ``nn.ParameterDict`` with ``"w"`` (and
``"b"`` with a bias), a norm one with ``"g"``, and blocks nest them in
``nn.ModuleDict``s under the reference's keys, so carried weights
(``convert.model_params``) keep their names.  A dense weight is kept
``(in, out)`` and applied as ``x @ w``, as the reference does, so it
needs no transpose.

Init draws from an explicit ``torch.Generator`` (the tensors go to its
device).  It does not reproduce JAX's PRNG: parity with the reference
runs on carried weights.  Parameters are made with
``requires_grad=False``, as serving wants; training switches it on for
the floating ones (``train.optimizer.AdamW.init``).
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

__all__ = ["dtype_of", "param", "normal", "dense_init", "dense_apply",
           "rmsnorm_init",
           "rmsnorm", "activation", "rope_freqs", "apply_rope", "VOCAB_PAD",
           "padded_vocab", "embed_init"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def normal(gen: torch.Generator, shape, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 on the generator's device, then
    cast, as the reference draws."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w.mul_(scale)).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               bias: bool = False,
               scale: float | None = None) -> nn.ParameterDict:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    p = nn.ParameterDict({"w": param(normal(gen, (in_dim, out_dim), scale,
                                             dtype))})
    if bias:
        p["b"] = param(torch.zeros(out_dim, dtype=dtype, device=gen.device))
    return p


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(dim: int, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({"g": param(torch.ones(dim, dtype=dtype,
                                                   device=device))})


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize in float32, cast to x's dtype, then scale by ``g`` in
    that dtype: the reference's order of casts."""
    dt = x.dtype
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(dt) * p["g"].to(dt)


def activation(name: str):
    """``jax.nn.gelu`` is the tanh approximation; so is this one."""
    if name in ("silu", "geglu_silu"):
        return nn.functional.silu
    if name in ("gelu", "geglu"):
        return functools.partial(nn.functional.gelu, approximate="tanh")
    raise ValueError(name)


# ----------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: (..., S, H, D); positions broadcastable to
    (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # (D/2,)
    angles = positions[..., None].float() * freqs         # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


VOCAB_PAD = 128  # the reference pads the vocab so the table shards evenly


def padded_vocab(vocab: int) -> int:
    return (vocab + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype) -> nn.ParameterDict:
    """Embedding table with the vocab padded to a multiple of 128."""
    return nn.ParameterDict({"w": param(normal(gen, (padded_vocab(vocab),
                                                      dim), 0.02, dtype))})
