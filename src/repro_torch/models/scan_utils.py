"""Chunked linear-recurrence scan and causal depthwise conv, shared by
Mamba and RG-LRU.

Port of ``repro/models/scan_utils.py``.  ``h_t = a_t * h_{t-1} + b_t``
runs as the reference's two-level scan: a Python loop over chunks that
carries the boundary state, and inside each chunk a log-depth doubling
scan with the reference's associative combine.  The reference's cost
mode (``unroll.py``, one whole-sequence scan for XLA's cost analysis)
has no counterpart: ``chunk=0`` is always 1024.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Shard

from .sharding import is_dtensor, local_call

__all__ = ["pick_chunk", "chunked_linear_scan", "causal_conv1d"]

DEFAULT_CHUNK = 1024


def pick_chunk(s: int, chunk: int = 0) -> int:
    """The reference's rule: 0 means 1024, then the largest divisor of
    ``s`` at or below it."""
    if chunk == 0:
        chunk = DEFAULT_CHUNK
    return next(c for c in range(min(chunk, s), 0, -1) if s % c == 0)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over axis 1 of the pairs (a, b) under the combine
    (a1, b1) then (a2, b2) -> (a1 * a2, a2 * b1 + b2): log2(n) rounds,
    each combining every element with the one ``d`` steps earlier."""
    n = a.shape[1]
    d = 1
    while d < n:
        a_prev, b_prev = a[:, :n - d], b[:, :n - d]
        a_cur, b_cur = a[:, d:], b[:, d:]
        a = torch.cat([a[:, :d], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :d], a_cur * b_prev + b_cur], dim=1)
        d *= 2
    return a, b


def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int = 0):
    """a, b (B, S, ...); h0 (B, ...), the state before the sequence.
    Returns (h_all (B, S, ...), h_last (B, ...)).  Over DTensors whose
    sequence dim is whole, each rank scans its own batch rows and
    channels."""
    if is_dtensor(a) and not any(isinstance(pl, Shard) and pl.dim == 1
                                 for pl in a.placements):
        pls = list(a.placements)
        h_pls = [Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim > 1
                 else pl for pl in pls]
        return local_call(
            lambda a_, b_, h_: chunked_linear_scan(a_, b_, h_, chunk),
            a.device_mesh, (a, b, h0), (pls, pls, h_pls), (None,) * 3,
            (pls, h_pls), out_shapes=(a.shape, h0.shape))
    s = a.shape[1]
    chunk = pick_chunk(s, chunk)
    h = h0
    outs = []
    for lo in range(0, s, chunk):
        acc_a, acc_b = _doubling_scan(a[:, lo:lo + chunk],
                                      b[:, lo:lo + chunk])
        h_chunk = acc_a * h[:, None] + acc_b
        outs.append(h_chunk)
        h = h_chunk[:, -1]
    return torch.cat(outs, dim=1), h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv.  x (B, S, C); w (W, C); ``state`` (B, W-1,
    C) holds the last W-1 inputs of the previous segment.  Returns (y (B,
    S, C), new_state (B, W-1, C)), in x's dtype."""
    bsz, s, c = x.shape
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((bsz, width - 1, c))
    xp = torch.cat([state.to(x.dtype), x], dim=1)       # (B, S+W-1, C)
    w = w.to(x.dtype)
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    y = y + bias.to(x.dtype)
    new_state = xp[:, s:] if width > 1 else x.new_zeros((bsz, 0, c))
    return y, new_state
