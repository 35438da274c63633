"""``flash_attention``'s backward, and its forward against the previous
algorithm.

The pair loop keeps each q chunk's running max, sum and accumulator as
tensors it replaces, never writes in place, so autograd can take its
gradient: ``gradcheck`` in float64 (causal, window, softcap,
``kv_offset``, GQA), and the gradient against a float64 naive softmax
attention's within GRAD_TOL.  Its forward is bit for bit the in-place
algorithm it replaced (kept below as ``_flash_in_place``) on fixed
float32 and bfloat16 inputs, so every serving path keeps its numbers.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.models import attention as TA

from test_torch_models import FLASH_CASES

GRAD_TOL = 1e-10      # float64 gradients vs the naive attention's, absolute

# (sq, sk, hq, hkv, causal, window, softcap, q_chunk, k_chunk, kv_offset)
GRAD_CASES = [
    (6, 6, 2, 2, True, None, 0.0, 2, 3, 0),       # causal, MHA
    (6, 6, 4, 2, True, 3, 0.0, 3, 2, 0),          # sliding window, GQA
    (6, 6, 4, 1, False, None, 2.5, 2, 2, 0),      # softcap, bidirectional
    (4, 8, 4, 2, True, 5, 3.0, 2, 4, 4),          # kv_offset: a later chunk
]


def _naive(q, k, v, *, causal, window, softcap, kv_offset):
    """Softmax attention, every score at once, in q's dtype."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(hq // hkv, dim=2)
    vv = v.repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(d)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = kv_offset + torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= qpos - kpos < window
    s = s.masked_fill(~ok, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)


def _inputs(case, dtype, seed=0):
    sq, sk, hq, hkv = case[:4]
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
            for shape in ((2, sq, hq, 4), (2, sk, hkv, 4), (2, sk, hkv, 4))]


def _kw(case):
    _, _, _, _, causal, window, cap, qc, kc, off = case
    return dict(causal=causal, window=window, logit_softcap=cap,
                q_chunk=qc, k_chunk=kc, kv_offset=off)


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_flash_attention_gradcheck(case):
    q, k, v = (t.requires_grad_(True) for t in _inputs(case, torch.float64))
    assert torch.autograd.gradcheck(
        lambda a, b, c: TA.flash_attention(a, b, c, **_kw(case)), (q, k, v))


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_flash_attention_grad_matches_naive(case):
    q, k, v = (t.requires_grad_(True) for t in _inputs(case, torch.float64))
    kw = _kw(case)
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    got = torch.autograd.grad((TA.flash_attention(q, k, v, **kw) * cot).sum(),
                              (q, k, v))
    want = torch.autograd.grad(
        (_naive(q, k, v, causal=kw["causal"], window=kw["window"],
                softcap=kw["logit_softcap"], kv_offset=kw["kv_offset"])
         * cot).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= GRAD_TOL


def _flash_in_place(q, k, v, *, causal=True, window=None, q_chunk=512,
                    k_chunk=512, kv_offset=0, logit_softcap=0.0):
    """The forward as it was before the backward was needed: the running
    state written in place, slice by slice."""
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
    pairs_q, pairs_k = TA.block_pairs(nq, nk, q_chunk, k_chunk, causal,
                                      window, kv_offset)
    f32, dev = torch.float32, q.device
    acc = torch.zeros((b, nq, q_chunk, hkv, g, d), dtype=f32, device=dev)
    m = torch.full((b, nq, q_chunk, hkv, g), -math.inf, dtype=f32,
                   device=dev)
    l = torch.zeros((b, nq, q_chunk, hkv, g), dtype=f32, device=dev)
    q_arange = torch.arange(q_chunk, device=dev)
    k_arange = torch.arange(k_chunk, device=dev)
    for qi, ki in zip(pairs_q.tolist(), pairs_k.tolist()):
        s = torch.einsum("bqhgd,bkhd->bqhgk", qs[:, qi].float(),
                         ks[:, ki].float()) * scale
        s = TA._softcap(s, logit_softcap)
        qpos = kv_offset + qi * q_chunk + q_arange
        kpos = ki * k_chunk + k_arange
        ok = torch.ones((q_chunk, k_chunk), dtype=torch.bool, device=dev)
        if causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            ok &= qpos[:, None] - kpos[None, :] < window
        bad = ~ok[None, :, None, None, :]
        s = s.masked_fill(bad, -math.inf)
        m_old, l_old = m[:, qi], l[:, qi]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None]).masked_fill(bad, 0.0)
        corr = torch.where(torch.isneginf(m_old), 0.0,
                           torch.exp(m_old - m_safe))
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p, vs[:, ki].float())
        acc[:, qi] = acc[:, qi] * corr[..., None] + pv
        l[:, qi] = l_old * corr + p.sum(dim=-1)
        m[:, qi] = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, hq, d).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_forward_is_bit_for_bit_the_previous(case, dtype):
    sq, sk, hq, hkv = case[:4]
    rng = np.random.default_rng(sq * 100 + sk + hq)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)
        for shape in ((2, sq, hq, 8), (2, sk, hkv, 8), (2, sk, hkv, 8)))
    kw = _kw(case)
    got = TA.flash_attention(q, k, v, **kw)
    assert got.dtype == dtype
    assert torch.equal(got, _flash_in_place(q, k, v, **kw))
