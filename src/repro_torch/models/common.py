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

Every parameter is made by :func:`param` with its logical-axis spec
(``models.sharding``), the reference's spec from the same init helper,
kept on the parameter as ``logical_axes``; so the spec tree
(``Model.param_specs``) cannot drift from the params.  Inside
:func:`placing` each new parameter goes through a placer as soon as it
is drawn (``train.step.init_sharded``: this rank's slice as a DTensor,
the full draw freed).  A :class:`NoDraw` in place of the generator
builds shapes only: on the ``meta`` device (``Model.param_shapes``), or
under a fake tensor mode (the dry run).
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
from torch import nn

__all__ = ["dtype_of", "NoDraw", "placing", "param", "replace_params",
           "normal", "uniform",
           "dense_init", "dense_apply", "rmsnorm_init",
           "rmsnorm", "activation", "rope_freqs", "apply_rope", "VOCAB_PAD",
           "padded_vocab", "embed", "embed_init"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


class NoDraw:
    """Stands in for a generator when only shapes are wanted: draws
    become ``torch.empty`` on ``device``."""

    def __init__(self, device="meta"):
        self.device = torch.device(device)


_PLACER = None


@contextlib.contextmanager
def placing(placer):
    """Within: every new parameter's tensor ``t`` becomes ``placer(t,
    spec)``."""
    global _PLACER
    prev, _PLACER = _PLACER, placer
    try:
        yield
    finally:
        _PLACER = prev


def param(t: torch.Tensor, spec=None) -> nn.Parameter:
    """A parameter of logical axes ``spec`` (default: replicated)."""
    spec = tuple(spec) if spec is not None else (None,) * t.dim()
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a {t.dim()}-d parameter")
    if _PLACER is not None:
        t = _PLACER(t, spec)
    p = nn.Parameter(t, requires_grad=False)
    p.logical_axes = spec
    return p


def replace_params(module: nn.Module, fn, prefix: str = "") -> nn.Module:
    """Swap each parameter ``p`` of ``module`` (named ``n``) for a new
    one of tensor ``fn(prefix + n, p)``, in place, keeping its
    ``requires_grad`` and ``logical_axes``; returns ``module``."""
    for name, p in list(module.named_parameters()):
        *path, key = name.split(".")
        parent = module.get_submodule(".".join(path)) if path else module
        new = nn.Parameter(fn(prefix + name, p),
                           requires_grad=p.requires_grad)
        if hasattr(p, "logical_axes"):
            new.logical_axes = p.logical_axes
        if hasattr(parent, "__setitem__"):
            parent[key] = new
        else:
            setattr(parent, key, new)
    return module


def normal(gen: torch.Generator, shape, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 on the generator's device, then
    cast, as the reference draws."""
    if isinstance(gen, NoDraw):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w.mul_(scale)).to(dtype)


def uniform(gen: torch.Generator, shape, lo: float,
            hi: float) -> torch.Tensor:
    """U(lo, hi) in float32 on the generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return t if isinstance(gen, NoDraw) else t.uniform_(lo, hi,
                                                         generator=gen)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               bias: bool = False, scale: float | None = None,
               spec=(None, None)) -> nn.ParameterDict:
    """``{"w": (in, out)}`` of logical axes ``spec``, with ``{"b":
    (out,)}`` on ``spec``'s last axis when ``bias``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    p = nn.ParameterDict({"w": param(normal(gen, (in_dim, out_dim), scale,
                                             dtype), spec)})
    if bias:
        p["b"] = param(torch.zeros(out_dim, dtype=dtype, device=gen.device),
                       (spec[-1],))
    return p


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(dim: int, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({"g": param(torch.ones(dim, dtype=dtype,
                                                   device=device), (None,))})


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


def embed(w: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows ``tokens`` of the table ``w``, cast to ``dtype``.  Over
    DTensors the lookup is vocab-parallel: each rank reads the tokens in
    its slice of the vocab, zeros elsewhere, and the result is a partial
    sum over the vocab axes (one nonzero term per token, so the sum is
    exact) that the caller's ``shard`` all-reduces."""
    from .sharding import is_dtensor, local_call, local_offset, split_axes
    if not is_dtensor(w):
        return nn.functional.embedding(tokens, w).to(dtype)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    v_axes = split_axes(w.placements, mesh, 0)
    tok_pl = [pl if isinstance(pl, Shard) else Replicate()
              for pl in tokens.placements]
    w_pl = [Shard(0) if i in v_axes else Replicate()
            for i in range(mesh.ndim)]
    out_pl = [Partial() if i in v_axes else pl
              for i, pl in enumerate(tok_pl)]
    # the table's gradient is partial over the axes that split the batch
    w_grad = [Partial() if isinstance(tok_pl[i], Shard) else pl
              for i, pl in enumerate(w_pl)]
    lo = local_offset(mesh, w_pl, 0, w.shape[0])

    def body(tok, w_loc):
        if not v_axes:         # the whole table: the one-device lookup
            return nn.functional.embedding(tok, w_loc).to(dtype)
        rel = tok - lo
        mine = (rel >= 0) & (rel < w_loc.shape[0])
        rows = nn.functional.embedding(
            torch.clamp(rel, 0, max(w_loc.shape[0] - 1, 0)), w_loc)
        return torch.where(mine[..., None], rows.to(dtype),
                           torch.zeros((), dtype=dtype, device=rows.device))

    return local_call(body, mesh, (tokens, w), (tok_pl, w_pl),
                      (None, w_grad), (out_pl,),
                      out_shapes=((*tokens.shape, w.shape[1]),))


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype) -> nn.ParameterDict:
    """Embedding table with the vocab padded to a multiple of 128, its
    vocab dim on the model axis (vocab-parallel)."""
    return nn.ParameterDict({"w": param(normal(gen, (padded_vocab(vocab),
                                                      dim), 0.02, dtype),
                                        ("model", None))})
