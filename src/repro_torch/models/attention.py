"""GQA attention: chunked online-softmax attention for prefill, cached
decode, sliding windows (``local`` layers), RoPE, qk-norm, QKV bias.

Port of ``repro/models/attention.py``, plain PyTorch as the reference
is plain JAX (no Pallas kernel stands behind it).  ``flash_attention``
keeps the reference's pair schedule -- the (q-chunk, kv-chunk) pairs
that can interact, from :func:`block_pairs` -- and its arithmetic: the
online softmax in float32, rows with no valid key kept at ``m = -inf``,
and ``acc / max(l, 1e-30)``.  ``scaled_dot_product_attention`` is not
used: parity needs the reference's masking and summation.  The
reference's switch picks the schedule: ``use_attn_impl("qloop")`` runs
one stream per q chunk over exactly its kv range (``_flash_qloop``),
each chunk's output finished before the next starts.  Both schedules
visit the same pairs in the same q-major order with the same
operations, so in the port (unlike the reference, where XLA fuses the
two apart) they give the same bits.

The decode cache is the reference's ring buffer (``k``, ``v``, ``pos``,
``ins``), but :func:`attn_apply_decode` writes the new token into it in
place and returns the same dict: a slice of its batch rows (a view) is
then a cache of its own, which the LM engine uses to run one slot.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from . import common as C
from .sharding import (is_dtensor, local_call, local_offset, reduce_from,
                       shard)

__all__ = ["use_attn_impl", "get_attn_impl", "block_pairs",
           "flash_attention", "decode_attention",
           "decode_attend",
           "attend", "attn_init", "attn_apply_train", "attn_apply_decode",
           "attn_cache_init", "attn_cache_specs", "attn_cache_from_prefill",
           "cache_from_prefill"]


ATTN_IMPLS = ("pairs", "qloop")
_ATTN_IMPL = "pairs"


def get_attn_impl() -> str:
    """The schedule :func:`flash_attention` runs: ``"pairs"`` (the
    default) or ``"qloop"``."""
    return _ATTN_IMPL


@contextlib.contextmanager
def use_attn_impl(name: str):
    """Run :func:`flash_attention` under schedule ``name`` inside the
    block (``"pairs"``: one loop over the interacting (q-chunk, kv-chunk)
    pairs; ``"qloop"``: a stream per q chunk); the previous schedule
    comes back on leaving it, also on an exception.  The switch is this
    process's: a process forked from a forkserver enters it itself."""
    global _ATTN_IMPL
    if name not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {name!r}: not one of {ATTN_IMPLS}")
    prev = _ATTN_IMPL
    _ATTN_IMPL = name
    try:
        yield
    finally:
        _ATTN_IMPL = prev


def block_pairs(n_q: int, n_k: int, q_chunk: int, k_chunk: int,
                causal: bool, window: Optional[int],
                kv_offset: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Static list of interacting (q_chunk_idx, kv_chunk_idx) pairs.
    ``kv_offset`` shifts q positions relative to kv positions (q token i
    sits at absolute position kv_offset + i), for chunked prefill."""
    qi_l, ki_l = [], []
    for i in range(n_q):
        q_lo = kv_offset + i * q_chunk
        q_hi = kv_offset + (i + 1) * q_chunk - 1
        for j in range(n_k):
            k_lo = j * k_chunk
            k_hi = (j + 1) * k_chunk - 1
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_hi < q_lo - window + 1:
                continue
            qi_l.append(i)
            ki_l.append(j)
    return (np.asarray(qi_l, np.int32), np.asarray(ki_l, np.int32))


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap else s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: int = 512, k_chunk: int = 512,
                    kv_offset: int = 0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, Hq, D), k / v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's
    dtype.  Chunk sizes shrink to the largest divisors of the sequence
    lengths, as in the reference."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    q_chunk = next(c for c in range(min(q_chunk, sq), 0, -1) if sq % c == 0)
    k_chunk = next(c for c in range(min(k_chunk, sk), 0, -1) if sk % c == 0)
    nq, nk = sq // q_chunk, sk // k_chunk
    scale = 1.0 / math.sqrt(d)

    qs = q.reshape(b, nq, q_chunk, hkv, g, d)
    ks = k.reshape(b, nk, k_chunk, hkv, d)
    vs = v.reshape(b, nk, k_chunk, hkv, d)
    # float32, or float64 for float64 inputs (gradcheck)
    f32, dev = torch.promote_types(q.dtype, torch.float32), q.device
    q_arange = torch.arange(q_chunk, device=dev)
    k_arange = torch.arange(k_chunk, device=dev)

    def init():
        return (torch.zeros((b, q_chunk, hkv, g, d), dtype=f32, device=dev),
                torch.full((b, q_chunk, hkv, g), -math.inf, dtype=f32,
                           device=dev),
                torch.zeros((b, q_chunk, hkv, g), dtype=f32, device=dev))

    def update(state, qi, ki):
        """One (q chunk, kv chunk) pair's online-softmax step on q chunk
        ``qi``'s running (acc, m, l); returns the new state (never
        written in place, so autograd keeps what the backward needs)."""
        acc, m_old, l_old = state
        s = torch.einsum("bqhgd,bkhd->bqhgk", qs[:, qi].to(f32),
                         ks[:, ki].to(f32)) * scale
        s = _softcap(s, logit_softcap)
        qpos = kv_offset + qi * q_chunk + q_arange
        kpos = ki * k_chunk + k_arange
        ok = torch.ones((q_chunk, k_chunk), dtype=torch.bool, device=dev)
        if causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            ok &= qpos[:, None] - kpos[None, :] < window
        bad = ~ok[None, :, None, None, :]
        s = s.masked_fill(bad, -math.inf)
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        # rows with no valid kv yet keep m = -inf; make exp well-defined
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None]).masked_fill(bad, 0.0)
        corr = torch.where(torch.isneginf(m_old), 0.0,
                           torch.exp(m_old - m_safe))
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p, vs[:, ki].to(f32))
        return (acc * corr[..., None] + pv, m_new,
                l_old * corr + p.sum(dim=-1))

    if _ATTN_IMPL == "qloop":
        out = _flash_qloop(init, update, nq, nk, q_chunk, k_chunk, causal,
                           window, kv_offset)
    else:
        # every q chunk's running state at once, updated pair by pair
        state = [init() for _ in range(nq)]
        for qi, ki in zip(*(a.tolist() for a in block_pairs(
                nq, nk, q_chunk, k_chunk, causal, window, kv_offset))):
            state[qi] = update(state[qi], qi, ki)
        acc, _, l = zip(*state)
        out = torch.stack(acc, 1) / torch.clamp(torch.stack(l, 1),
                                                min=1e-30)[..., None]
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _flash_qloop(init, update, nq: int, nk: int, q_chunk: int, k_chunk: int,
                 causal: bool, window: Optional[int],
                 kv_offset: int) -> torch.Tensor:
    """The reference's ``_flash_qloop`` schedule: q chunk by q chunk,
    each a stream over exactly its kv range ``ki_lo..ki_hi`` with a
    chunk-local state, its output finished before the next chunk starts.
    The range is :func:`block_pairs`' pairs of the chunk, so the pairs,
    their order and each one's operations are the pair loop's."""
    outs = []
    for qi in range(nq):
        q_lo = kv_offset + qi * q_chunk
        q_hi = q_lo + q_chunk - 1
        ki_lo, ki_hi = 0, nk - 1
        if causal:
            ki_hi = min(ki_hi, q_hi // k_chunk)
        if window is not None:
            ki_lo = max(ki_lo, (q_lo - window + 1) // k_chunk)
        state = init()
        for ki in range(ki_lo, ki_hi + 1):
            state = update(state, qi, ki)
        acc, _, l = state
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.stack(outs, 1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     pos: torch.Tensor, *, window: Optional[int] = None,
                     logit_softcap: float = 0.0,
                     head_dim: Optional[int] = None,
                     reduce_scores: Optional[Callable] = None,
                     reduce_seq: Optional[Callable] = None) -> torch.Tensor:
    """q (B, 1, Hq, D) against a cache (B, S_cache, Hkv, D) whose slots
    hold absolute positions ``kv_positions`` (B, S_cache), -1 = empty;
    ``pos`` (B,) is each row's current position.

    On a rank's part of a sharded cache (:func:`decode_attend`):
    ``head_dim`` is the full head dim (the scale's), ``reduce_scores``
    sums the partial scores of a split head dim, and ``reduce_seq(x,
    op)`` reduces (``"max"`` or ``"sum"``) the softmax's max, sum and
    weighted values over a split sequence."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(head_dim or d)
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    if reduce_scores is not None:
        s = reduce_scores(s)
    s = _softcap(s * scale, logit_softcap)
    ok = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window is not None:
        ok &= pos[:, None] - kv_positions < window
    s = s.masked_fill(~ok[:, None, None, :], -math.inf)
    if reduce_seq is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    else:
        e = torch.exp(s - reduce_seq(s.amax(dim=-1, keepdim=True), "max"))
        out = reduce_seq(torch.einsum("bhgk,bkhd->bhgd", e,
                                      v_cache.float()), "sum") \
            / reduce_seq(e.sum(-1, keepdim=True), "sum")
    return out.reshape(b, 1, hq, d).to(q.dtype)


def decode_attend(q, k_cache, v_cache, kv_positions, pos, *,
                  window: Optional[int] = None,
                  logit_softcap: float = 0.0) -> torch.Tensor:
    """:func:`decode_attention`; over DTensors it runs on each rank's
    part of the cache, as the cache's placements lay it out: batch rows
    and kv heads locally, a split head dim with the scores all-reduced
    over its axis, a split sequence (context parallelism) with the
    softmax's max, sum and weighted values all-reduced over its axes."""
    if not is_dtensor(k_cache):
        return decode_attention(q, k_cache, v_cache, kv_positions, pos,
                                window=window, logit_softcap=logit_softcap)
    from torch.distributed.tensor import Replicate, Shard
    mesh = k_cache.device_mesh
    names = mesh.mesh_dim_names
    hq, hkv = q.shape[2], k_cache.shape[2]
    kv_pl, q_pl, row_pl, kp_pl = [], [], [], []
    hd_axes, seq_axes = [], []
    for i, pl in enumerate(k_cache.placements):
        dim, n = (pl.dim if isinstance(pl, Shard) else None), mesh.size(i)
        if dim == 0:
            kv_pl.append(Shard(0)); q_pl.append(Shard(0))
            row_pl.append(Shard(0)); kp_pl.append(Shard(0))
            continue
        if dim == 2 and hq % n == 0 and hkv % n == 0:
            kv_pl.append(Shard(2)); q_pl.append(Shard(2))
        elif dim == 3:
            kv_pl.append(Shard(3)); q_pl.append(Shard(3))
            hd_axes.append(names[i])
        elif dim == 1:
            kv_pl.append(Shard(1)); q_pl.append(Replicate())
            seq_axes.append(names[i])
        else:
            kv_pl.append(Replicate()); q_pl.append(Replicate())
        row_pl.append(Replicate())
        kp_pl.append(Shard(1) if dim == 1 else Replicate())

    def over(axes):
        def reduce(x, op="sum"):
            for a in axes:
                x = reduce_from(x, mesh, a, op)
            return x
        return reduce if axes else None

    body = functools.partial(decode_attention, window=window,
                             logit_softcap=logit_softcap,
                             head_dim=q.shape[3],
                             reduce_scores=over(hd_axes),
                             reduce_seq=over(seq_axes))
    return local_call(body, mesh, (q, k_cache, v_cache, kv_positions, pos),
                      (q_pl, kv_pl, kv_pl, kp_pl, row_pl), (None,) * 5,
                      (q_pl,), out_shapes=(q.shape,))


# --------------------------------------------------------------------------
# Attention block (params + apply)
# --------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg, dtype) -> nn.ModuleDict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    col, row = (None, "model"), ("model", None)
    p = nn.ModuleDict({
        "wq": C.dense_init(gen, d, hq * hd, dtype, bias=cfg.qkv_bias,
                           spec=col),
        "wk": C.dense_init(gen, d, hkv * hd, dtype, bias=cfg.qkv_bias,
                           spec=col),
        "wv": C.dense_init(gen, d, hkv * hd, dtype, bias=cfg.qkv_bias,
                           spec=col),
        "wo": C.dense_init(gen, hq * hd, d, dtype, spec=row),
    })
    if cfg.qk_norm:
        p["qn"] = C.rmsnorm_init(hd, dtype, gen.device)
        p["kn"] = C.rmsnorm_init(hd, dtype, gen.device)
    return p


def _split_heads(xp: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(B, S, heads * hd) -> (B, S, heads, hd).  A packed dim split over
    a mesh axis that does not divide ``heads`` is gathered over that
    axis first (GSPMD reshards there too)."""
    if is_dtensor(xp):
        from torch.distributed.tensor import Replicate, Shard
        mesh = xp.device_mesh
        pls = [Replicate() if isinstance(pl, Shard) and pl.dim == 2
               and heads % mesh.size(i) != 0 else pl
               for i, pl in enumerate(xp.placements)]
        if pls != list(xp.placements):
            xp = xp.redistribute(mesh, pls)
    return xp.reshape(*xp.shape[:2], heads, hd)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd).  A head dim split over a mesh
    axis (a sharded cache's layout) moves to the heads where they divide
    the axis, else is gathered, so the packed dim is split in whole
    heads."""
    if is_dtensor(o):
        from torch.distributed.tensor import Replicate, Shard
        mesh = o.device_mesh
        pls = [(Shard(2) if o.shape[2] % mesh.size(i) == 0 else Replicate())
               if isinstance(pl, Shard) and pl.dim == 3 else pl
               for i, pl in enumerate(o.placements)]
        if pls != list(o.placements):
            o = o.redistribute(mesh, pls)
    return o.reshape(*o.shape[:2], -1)


def _project_qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    b, sq, _ = x.shape
    hd = cfg.resolved_head_dim
    # the constraints go on the PACKED (h * hd) projections, as in the
    # reference: the packed dims divide the model axis where head counts
    # need not
    qp = shard(C.dense_apply(p["wq"], x), "batch", None, "model")
    kp = shard(C.dense_apply(p["wk"], x), "batch", None, "model")
    vp = shard(C.dense_apply(p["wv"], x), "batch", None, "model")
    q = _split_heads(qp, cfg.n_heads, hd)
    k = _split_heads(kp, cfg.n_kv_heads, hd)
    v = _split_heads(vp, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = C.rmsnorm(p["qn"], q, cfg.norm_eps)
        k = C.rmsnorm(p["kn"], k, cfg.norm_eps)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply_train(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                     is_local: bool, causal: bool = True, q_chunk: int = 512,
                     k_chunk: int = 512):
    """Full-sequence attention (prefill).  Returns (out, (k, v))."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    window = cfg.window if is_local else None
    out = attend(q, k, v, causal=causal, window=window, q_chunk=q_chunk,
                 k_chunk=k_chunk, logit_softcap=cfg.logit_softcap)
    b, sq = x.shape[:2]
    y = C.dense_apply(p["wo"], out.reshape(b, sq, -1))
    return shard(y, "batch", None, None), (k, v)


def _rank_local_placements(q, k):
    """Placements under which attention over q (B, S, Hq, D) and k / v
    (B, Sk, Hkv, D) is rank-local: a mesh dim that shards the batch of
    q keeps it; one that shards q's and k's heads keeps them where both
    head counts divide it (so head h and its kv head h // g share a
    rank); every other mesh dim is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    out = []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        if isinstance(pq, Shard) and pq.dim == 0 and q.shape[0] % n == 0:
            out.append(Shard(0))
        elif (isinstance(pq, Shard) and pq.dim == 2 and isinstance(pk, Shard)
              and pk.dim == 2 and q.shape[2] % n == 0
              and k.shape[2] % n == 0):
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return out


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **kw) -> torch.Tensor:
    """:func:`flash_attention`; over DTensors it runs on each rank's
    shard of the batch and of the heads (``_rank_local_placements``), q,
    k and v redistributed to that layout first, and the output keeps
    it."""
    if not is_dtensor(q):
        return flash_attention(q, k, v, **kw)
    pls = _rank_local_placements(q, k)
    return local_call(lambda a, b_, c: flash_attention(a, b_, c, **kw),
                      q.device_mesh, (q, k, v), (pls, pls, pls),
                      (None, None, None), (pls,), out_shapes=(q.shape,))


def attn_apply_decode(p, cfg, x: torch.Tensor, cache: dict,
                      pos: torch.Tensor, *, is_local: bool):
    """Single-token decode step.  Writes the token's k / v / position
    into ``cache`` (dict of k, v, pos, ins) at each row's ring slot, in
    place, and returns (out, cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None])
    size = cache["k"].shape[1]
    slot = (cache["ins"] % size).long()          # (B,) ring insertion point
    if is_dtensor(cache["k"]):
        _write_sharded(cache, slot, k_new, v_new, pos)
    else:
        bi = torch.arange(b, device=x.device)
        cache["k"][bi, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][bi, slot] = v_new[:, 0].to(cache["v"].dtype)
        cache["pos"][bi, slot] = pos.to(cache["pos"].dtype)
    cache["ins"] += 1
    window = cfg.window if is_local else None
    out = decode_attend(q, cache["k"], cache["v"], cache["pos"], pos,
                        window=window, logit_softcap=cfg.logit_softcap)
    return C.dense_apply(p["wo"], merge_heads(out)), cache


def _write_slot(c: torch.Tensor, slot: torch.Tensor, new: torch.Tensor,
                lo: int) -> None:
    """Write each row's ``new`` (B, ...) into ``c`` (B, S, ...), a rank's
    part of a cache whose sequence starts at global slot ``lo``, at slot
    ``slot - lo``; a row whose slot lies on another rank writes back the
    value it reads."""
    if c.shape[1] == 0:
        return
    j = slot - lo
    mine = (j >= 0) & (j < c.shape[1])
    j = j.clamp(0, c.shape[1] - 1)
    bi = torch.arange(c.shape[0], device=c.device)
    mine = mine.reshape(-1, *[1] * (new.dim() - 1))
    c[bi, j] = torch.where(mine, new.to(c.dtype), c[bi, j])


def _write_sharded(cache: dict, slot: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, pos: torch.Tensor) -> None:
    """The decode write into a sharded cache (batch, kvseq, heads or head
    dim split): each rank writes its own rows' slot, where it holds it,
    with an index write on its local part."""
    from torch.distributed.tensor import Replicate, Shard
    size = cache["k"].shape[1]
    for key, new in (("k", k_new), ("v", v_new), ("pos", pos)):
        c = cache[key]
        mesh, pl = c.device_mesh, list(c.placements)
        rows = [p_ if isinstance(p_, Shard) and p_.dim == 0 else Replicate()
                for p_ in pl]
        # the new token on the cache's layout, its one slot whole
        new_pl = [Replicate() if isinstance(p_, Shard) and p_.dim == 1
                  else p_ for p_ in pl]
        lo = local_offset(mesh, pl, 1, size)
        local_call(lambda c_, s_, n_: _write_slot(
            c_, s_, n_.reshape(c_.shape[0], *c_.shape[2:]), lo), mesh,
            (c, slot, new), (pl, rows, new_pl), (None,) * 3, (None,))


def attn_cache_init(cfg, batch: int, max_len: int, *, is_local: bool,
                    dtype=torch.bfloat16, device=None) -> dict:
    """KV cache: a ring of ``window`` slots for local layers, ``max_len``
    for global ones."""
    size = min(cfg.window, max_len) if is_local else max_len
    hd = cfg.resolved_head_dim
    shape = (batch, size, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32,
                          device=device),
        "ins": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def attn_cache_specs(cfg, is_local: bool, model_axis: int = 16) -> dict:
    """The reference's KV-cache specs: the kv-head dim on the model axis
    when it divides ``model_axis`` (16, the production axis), else the
    head dim; the sequence dim on the logical ``kvseq`` axis."""
    if cfg.n_kv_heads % model_axis == 0:
        kv = ("batch", "kvseq", "model", None)
    else:
        kv = ("batch", "kvseq", None, "model")
    return {"k": kv, "v": kv, "pos": ("batch", "kvseq"), "ins": ("batch",)}


def attn_cache_from_prefill(cfg, k: torch.Tensor, v: torch.Tensor, *,
                            is_local: bool, max_len: int) -> dict:
    """A decode cache from prefill K/V of shape (B, S, Hkv, D)."""
    b, s_in = k.shape[:2]
    dev = k.device
    size = min(cfg.window, max_len) if is_local else max_len
    pos_keep = torch.arange(s_in, dtype=torch.int32, device=dev)
    if is_local and s_in > size:
        k, v, pos_keep = k[:, -size:], v[:, -size:], pos_keep[-size:]
    kept = k.shape[1]
    c = {"k": k.new_zeros((b, size, *k.shape[2:])),
         "v": v.new_zeros((b, size, *v.shape[2:])),
         "pos": torch.full((b, size), -1, dtype=torch.int32, device=dev),
         "ins": torch.zeros(b, dtype=torch.int32, device=dev)}
    # ring layout: token at absolute position p lives in slot p % size
    slots = (pos_keep % size).long() if is_local else torch.arange(
        kept, device=dev)
    c["k"][:, slots] = k
    c["v"][:, slots] = v
    c["pos"][:, slots] = pos_keep.expand(b, kept)
    c["ins"].fill_(s_in)
    return c


def cache_from_prefill(cfg, k: torch.Tensor, v: torch.Tensor, *,
                       is_local: bool, max_len: int) -> dict:
    """:func:`attn_cache_from_prefill`; over DTensors each rank builds
    its own batch rows' and heads' part of the cache."""
    if not is_dtensor(k):
        return attn_cache_from_prefill(cfg, k, v, is_local=is_local,
                                       max_len=max_len)
    from torch.distributed.tensor import Replicate, Shard
    mesh, kv_pl = k.device_mesh, list(k.placements)
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in kv_pl]
    b = k.shape[0]
    size = min(cfg.window, max_len) if is_local else max_len
    c = local_call(
        lambda k_, v_: tuple(attn_cache_from_prefill(
            cfg, k_, v_, is_local=is_local, max_len=max_len).values()),
        mesh, (k, v), (kv_pl, kv_pl), (None, None),
        (kv_pl, kv_pl, rows, rows),
        out_shapes=((b, size, *k.shape[2:]), (b, size, *k.shape[2:]),
                    (b, size), (b,)))
    return dict(zip(("k", "v", "pos", "ins"), c))