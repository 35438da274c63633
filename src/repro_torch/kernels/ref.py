"""Plain PyTorch versions of the spMVM kernels (the ``ref.py`` layer).

Each function is the specification of the matching hand-written kernel,
written with vectorised torch ops: a gather of ``x`` at the stored
column indices and an ``index_add_`` standing in for the reference's
``segment_sum``.  The wrappers take them only for tensors on the CPU;
on the card they serve as the yardstick the kernels are held against.

All operate on the device layout of ``ops.to_device_*``: zero values and
column ``PAD_COL`` in padded slots make masking unnecessary (a padded
lane gathers ``x[0]`` and multiplies it by 0, exactly as the reference
does -- so a NaN in ``x[0]`` poisons rows with padding in both).  The
one exception is ELLPACK-R, whose plain version masks by ``rowlen`` as
the reference's does (paper Listing 1), so its padding never reads x.
The ELLPACK-R and CMRS versions also take a block of right-hand sides,
``x`` of shape ``(n, k)``, as the reference's do.

The transposes (``*_rmatvec_ref``, z = A^T y) have no Pallas kernel in
the reference (they are ``segment_sum`` scatters there); on the CPU they
are the product, and on the card they are the yardstick of K7
(``transpose_spmv.py``), which adds each column's slots in the same
ascending slot order without atomics.

The fused Krylov loop's scalar step and vector updates
(``krylov_step_ref`` / ``krylov_update_ref``) have no Pallas kernel
behind them -- XLA fused that work into the reference's device loop --
and are written as float32 0-d tensor ops in the order the CUDA
kernels (``csrc/krylov_step.cu``) follow, one rounding per operation,
so the two give the same bits.

Every call adds one to the function's ``calls`` attribute, so a run can
show that its main path never went through a plain version.
"""
from __future__ import annotations

import torch

from ._backend import acc_dtype

__all__ = ["pjds_matvec_ref", "pjds_matmat_ref", "sell_matvec_ref",
           "fused_matvec_dots_ref", "csr_matvec_ref", "ell_matvec_ref",
           "cmrs_matvec_ref", "csr_rmatvec_ref", "ell_rmatvec_ref",
           "blocked_rmatvec_ref", "cmrs_rmatvec_ref", "krylov_step_ref",
           "krylov_update_ref",
           "partial_reduce_epilogue", "reset_calls"]

# Slots of the fused loop's scalar state: ``fs`` (float32) and ``is_``
# (int32); csrc/krylov_step.cu numbers them the same way.
(FS_TOL, FS_B2, FS_RS, FS_BEST, FS_ALPHA, FS_BETA, FS_OMEGA, FS_RHO,
 FS_RHAT_V) = range(9)
IS_K, IS_MAXITER, IS_FLAG, IS_SINCE, IS_DONE, IS_SKIP = range(6)
FS_SIZE, IS_SIZE = 16, 8
STEP_INIT, STEP_CG, STEP_BICG1, STEP_BICG2 = range(4)
UPDATE_CG, UPDATE_BICG_P, UPDATE_BICG_S, UPDATE_BICG_XR = range(4)


def _block_sums(val, col_idx, row_block, x, n_blocks):
    """Sorted-basis y: per row lane, the sum of val * x[col] over its
    block's jagged diagonals, accumulated in f32 or wider."""
    b_r = val.shape[1]
    dt = acc_dtype(val.dtype, x.dtype)
    # int16 storage keeps bytes/nnz; the gather widens it to int32
    contrib = x[col_idx.int()].to(dt) * val.to(dt)       # (total_jds, b_r)
    y_blk = torch.zeros((n_blocks, b_r), dtype=dt, device=val.device)
    y_blk.index_add_(0, row_block, contrib)
    return y_blk.reshape(n_blocks * b_r)


def pjds_matvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                    row_block: torch.Tensor, x: torch.Tensor,
                    n_blocks: int) -> torch.Tensor:
    """pJDS y = A x in the permuted basis (paper Listing 2).

    val/col_idx: (total_jds, b_r); row_block: (total_jds,) int32 block
    id of each jagged diagonal; x: (>= n_cols,).  Returns
    (n_blocks * b_r,) in the accumulator dtype."""
    pjds_matvec_ref.calls += 1
    return _block_sums(val, col_idx, row_block, x, n_blocks)


def pjds_matmat_ref(val: torch.Tensor, col_idx: torch.Tensor,
                    row_block: torch.Tensor, x: torch.Tensor,
                    n_blocks: int) -> torch.Tensor:
    """pJDS Y = A X, multi-RHS, in the permuted basis.
    x: (>= n_cols, k) -> (n_blocks * b_r, k) in the accumulator dtype."""
    pjds_matmat_ref.calls += 1
    b_r = val.shape[1]
    k = x.shape[1]
    dt = acc_dtype(val.dtype, x.dtype)
    contrib = x[col_idx.int()].to(dt) * val.to(dt)[..., None]
    y_blk = torch.zeros((n_blocks, b_r, k), dtype=dt, device=val.device)
    y_blk.index_add_(0, row_block, contrib)
    return y_blk.reshape(n_blocks * b_r, k)


def sell_matvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                    row_block: torch.Tensor, inv_perm: torch.Tensor,
                    x: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """SELL-C-sigma y = A x back in the ORIGINAL row order: the storage
    layout matvec is pJDS's, then ``y[i] = y_sorted[inv_perm[i]]``."""
    sell_matvec_ref.calls += 1
    return _block_sums(val, col_idx, row_block, x, n_blocks)[inv_perm]


def fused_matvec_dots_ref(val, col_idx, row_block, inv_perm, x, w1, w2,
                          n_blocks: int, *, y=None, dots=None, done=None):
    """The fused iteration's function: the SELL ``y = A x`` and the
    (5,) tensor ``[<y,w1>, <y,w2>, <y,y>, <w2,w2>, <w1,w2>]`` over every
    row.  With ``y`` / ``dots`` given they are written in place and
    returned; with ``done`` (a one-element int32 tensor) set nothing is
    computed or written."""
    fused_matvec_dots_ref.calls += 1
    if done is not None and int(done):
        return y, dots
    y_new = _block_sums(val, col_idx, row_block, x, n_blocks)[inv_perm]
    w1c, w2c = w1.to(y_new.dtype), w2.to(y_new.dtype)
    d_new = torch.stack([torch.dot(y_new, w1c), torch.dot(y_new, w2c),
                         torch.dot(y_new, y_new), torch.dot(w2c, w2c),
                         torch.dot(w1c, w2c)])
    if y is None:
        return y_new, d_new
    y.copy_(y_new)
    dots.copy_(d_new)
    return y, dots


def csr_matvec_ref(data: torch.Tensor, indices: torch.Tensor,
                   row_ids: torch.Tensor, x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """CSR y = A x as a flat gather + index_add_ over the nnz stream.
    The reference has no kernel for CSR either: this is its
    implementation on every device.  ``x`` may carry a trailing block
    axis: (n,) or (n, k)."""
    csr_matvec_ref.calls += 1
    dt = acc_dtype(data.dtype, x.dtype)
    xg = x[indices].to(dt)                       # (nnz,) or (nnz, k)
    d = data.to(dt)
    contrib = xg * (d[:, None] if xg.dim() == 2 else d)
    y = torch.zeros((n_rows, *xg.shape[1:]), dtype=dt, device=data.device)
    return y.index_add_(0, row_ids, contrib)


def ell_matvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                   rowlen: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ELLPACK-R y = A x (paper Listing 1), jagged-diagonal-major layout,
    rows in ORIGINAL order.

    val/col_idx: (max_nzr, n_pad); rowlen: (n_pad,); x: (>= n_cols,) or
    (>= n_cols, k).  Returns (n_pad,) or (n_pad, k).  Slots at or past a
    row's ``rowlen`` are masked out, so a non-finite x never reaches a
    row through its padding."""
    ell_matvec_ref.calls += 1
    dt = acc_dtype(val.dtype, x.dtype)
    j = torch.arange(val.shape[0], device=val.device)[:, None]
    mask = j < rowlen[None, :]
    xg = x[col_idx.int()].to(dt)                 # (max_nzr, n_pad[, k])
    v = val.to(dt)
    if xg.dim() == 3:
        v, mask = v[..., None], mask[..., None]
    return (xg * v).masked_fill(~mask, 0).sum(dim=0)


def cmrs_matvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                    row_in_strip: torch.Tensor, strip_map: torch.Tensor,
                    x: torch.Tensor, n_strips: int) -> torch.Tensor:
    """CMRS y = A x in the ORIGINAL row order (no permutation).

    val/col_idx/row_in_strip: (total_su, b_r); strip_map: (total_su,)
    int32 strip of each tile row.  Each slot adds into global row
    ``strip_map * b_r + row_in_strip``; padding slots carry val == 0 and
    route ``0 * x[0]`` into row 0 of their strip.  x: (>= n_cols,) or
    (>= n_cols, k); returns (n_strips * b_r[, k])."""
    cmrs_matvec_ref.calls += 1
    b_r = val.shape[1]
    dt = acc_dtype(val.dtype, x.dtype)
    rows = (strip_map[:, None].long() * b_r
            + row_in_strip.long()).reshape(-1)
    xg = x[col_idx.int()].to(dt)                 # (total_su, b_r[, k])
    v = val.to(dt)
    contrib = xg * (v[..., None] if xg.dim() == 3 else v)
    flat = contrib.reshape(rows.numel(), *contrib.shape[2:])
    y = torch.zeros((n_strips * b_r, *contrib.shape[2:]), dtype=dt,
                    device=val.device)
    return y.index_add_(0, rows, flat)


def _scatter_cols(flat: torch.Tensor, cols: torch.Tensor,
                  n_cols: int) -> torch.Tensor:
    """``out[c] = sum of flat[s] where cols[s] == c``, added in slot
    order (``index_add_`` on the CPU is a serial loop in that order, as
    XLA's CPU ``segment_sum`` is)."""
    out = torch.zeros((n_cols, *flat.shape[1:]), dtype=flat.dtype,
                      device=flat.device)
    return out.index_add_(0, cols.reshape(-1).long(), flat)


def csr_rmatvec_ref(data: torch.Tensor, indices: torch.Tensor,
                    row_ids: torch.Tensor, y: torch.Tensor,
                    n_cols: int) -> torch.Tensor:
    """CSR z = A^T y by the swapped gather: read y along rows, add into
    columns.  The reference has no kernel for CSR either: this is its
    implementation on every device.  ``y``: (n_rows,) or (n_rows, k)."""
    csr_rmatvec_ref.calls += 1
    dt = acc_dtype(data.dtype, y.dtype)
    yg = y[row_ids].to(dt)                       # (nnz,) or (nnz, k)
    d = data.to(dt)
    contrib = yg * (d[:, None] if yg.dim() == 2 else d)
    return _scatter_cols(contrib, indices, n_cols)


def ell_rmatvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                    rowlen: torch.Tensor, y: torch.Tensor,
                    n_cols: int) -> torch.Tensor:
    """ELLPACK-R z = A^T y: every slot below its row's ``rowlen`` adds
    ``val * y[row]`` into its column.  ``y``: (n_pad,) or (n_pad, k) in
    the ORIGINAL row order, padded rows zero; returns (n_cols[, k])."""
    ell_rmatvec_ref.calls += 1
    dt = acc_dtype(val.dtype, y.dtype)
    j = torch.arange(val.shape[0], device=val.device)[:, None]
    v = val.to(dt).masked_fill(~(j < rowlen[None, :]), 0)
    yd = y.to(dt)
    contrib = v[..., None] * yd[None] if y.dim() == 2 else v * yd[None, :]
    return _scatter_cols(contrib.reshape(-1, *contrib.shape[2:]), col_idx,
                         n_cols)


def blocked_rmatvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                        row_block: torch.Tensor, y: torch.Tensor,
                        n_cols: int) -> torch.Tensor:
    """pJDS / SELL z = A^T y: each slot reads y at its stored row
    (``row_block * b_r + lane``) and adds into its column.  ``y``:
    (n_rows_pad,) or (n_rows_pad, k) in the STORAGE (sorted) basis;
    returns (n_cols[, k])."""
    blocked_rmatvec_ref.calls += 1
    b_r = val.shape[1]
    dt = acc_dtype(val.dtype, y.dtype)
    rows = (row_block.long()[:, None] * b_r
            + torch.arange(b_r, device=val.device)[None, :])
    yg = y[rows].to(dt)                          # (total_jds, b_r[, k])
    v = val.to(dt)
    contrib = yg * (v[..., None] if yg.dim() == 3 else v)
    return _scatter_cols(contrib.reshape(-1, *contrib.shape[2:]), col_idx,
                         n_cols)


def cmrs_rmatvec_ref(val: torch.Tensor, col_idx: torch.Tensor,
                     row_in_strip: torch.Tensor, strip_map: torch.Tensor,
                     y: torch.Tensor, n_cols: int) -> torch.Tensor:
    """CMRS z = A^T y: each slot reads y at its global row
    (``strip_map * b_r + row_in_strip``) and adds into its column.
    ``y``: (n_strips * b_r,) or (n_strips * b_r, k) in the ORIGINAL row
    order; returns (n_cols[, k])."""
    cmrs_rmatvec_ref.calls += 1
    b_r = val.shape[1]
    dt = acc_dtype(val.dtype, y.dtype)
    rows = strip_map[:, None].long() * b_r + row_in_strip.long()
    yg = y[rows].to(dt)                          # (total_su, b_r[, k])
    v = val.to(dt)
    contrib = yg * (v[..., None] if yg.dim() == 3 else v)
    return _scatter_cols(contrib.reshape(-1, *contrib.shape[2:]), col_idx,
                         n_cols)


# ---- the fused Krylov loop: scalar step and vector updates -------------
# Status codes of core/solvers.py that the failure latch sets.
_BREAKDOWN, _DIVERGED, _NON_FINITE = 2, 3, 4
_STAG_WINDOW = 500


def _f32(v: float) -> torch.Tensor:
    """float32 of a float64 literal, rounded as numpy's float32() is."""
    return torch.tensor(v, dtype=torch.float32)


_TINY = _f32(1e-30)
_DIVERGE_REL2 = _f32(1e12)
_KEEP = _f32(1.0 - 0.01)
_TINY_NORMAL = _f32(torch.finfo(torch.float32).tiny)


def _flush(t: torch.Tensor) -> torch.Tensor:
    """float32 subnormals to 0, as the host reads of the loops do."""
    return torch.where(t.abs() < _TINY_NORMAL, torch.zeros_like(t), t)


def _maxnan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """numpy's maximum: NaN propagates, and a tie returns ``b``."""
    return torch.where(torch.isnan(a) | (a > b), a, b)


def _nz(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0, _TINY, d)


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() > _TINY, d, _TINY)


def _not_done(rel2: torch.Tensor, tol: torch.Tensor) -> bool:
    return bool(tol <= 0) or bool(torch.isfinite(rel2)
                                  & (rel2 > tol * tol))


def _health(fs, is_, rel2, breakdown: bool, check: bool) -> None:
    """One step of the failure latch (``core.solvers._health``) on the
    state: ``flag`` keeps the first failure; stagnation is judged at
    checkpoints every 500 iterations."""
    finite = bool(torch.isfinite(rel2))
    since = int(is_[IS_SINCE]) + 1
    at_ckpt = since % _STAG_WINDOW == 0
    progressed = finite and bool(rel2 <= fs[FS_BEST] * _KEEP)
    stalled = at_ckpt and not progressed and since >= 2 * _STAG_WINDOW
    if not finite:
        new = _NON_FINITE
    elif breakdown:
        new = _BREAKDOWN
    elif bool(rel2 > _DIVERGE_REL2):
        new = _DIVERGED
    elif stalled:
        new = _BREAKDOWN
    else:
        new = 0
    if not check:
        new = 0
    if at_ckpt:
        fs[FS_BEST] = rel2
    is_[IS_SINCE] = 0 if (at_ckpt and progressed) else since
    if int(is_[IS_FLAG]) == 0:
        is_[IS_FLAG] = new


def _advance(fs, is_) -> None:
    """After an iteration: ``k + 1``, and ``done`` unless the loop goes
    on (no failure, the exit test not met, ``k < maxiter``)."""
    k = int(is_[IS_K]) + 1
    is_[IS_K] = k
    rel2 = fs[FS_RS] / fs[FS_B2]
    go = (int(is_[IS_FLAG]) == 0 and _not_done(rel2, fs[FS_TOL])
          and k < int(is_[IS_MAXITER]))
    is_[IS_DONE] = int(not go)


def krylov_step_ref(kind: int, fs: torch.Tensor, is_: torch.Tensor,
                    dots: torch.Tensor, *, tol: float = 0.0,
                    maxiter: int = 0) -> None:
    """One scalar step of the fused loop, in place on ``fs`` / ``is_``.

    * ``STEP_INIT``: ``dots`` = [<r,r>, <b,b>] of a (re)start: sets tol,
      maxiter, b2 = max(<b,b>, 1e-30), the look-ahead residual, the
      failure latch (a non-finite start is flagged), k = 0, BiCGStab's
      rho = <r,r>, alpha = omega = 1 and its first beta, and ``done``.
    * ``STEP_CG``: K3's [<Ap,p>, <Ap,r>, <Ap,Ap>, <r,r>, .] ->
      alpha = <r,r>/<Ap,p> (0 on breakdown, p.Ap <= 0), the look-ahead
      max(<r,r> - 2 alpha <Ap,r> + alpha^2 <Ap,Ap>, 0), the latch,
      beta = rs / max(<r,r>, 1e-30), k + 1, ``done``.
    * ``STEP_BICG1``: pass one's [<v,rhat>, ...] -> alpha = rho /
      safe(<rhat,v>).
    * ``STEP_BICG2``: pass two's [<t,rhat>, <t,s>, <t,t>, <s,s>,
      <rhat,s>] -> omega, the look-ahead residual, rho' = <rhat,s> -
      omega <t,rhat> (the measured <rhat,s>), the latch (breakdown when
      rho, <rhat,v> or <t,t> vanish), the next beta, k + 1, ``done``.

    Every dot is flushed (subnormals to 0) first.  A step other than
    init does nothing once ``done`` is set; CG's and BiCGStab's second
    step copy ``done`` as they found it to ``skip``, which the update
    after them reads."""
    krylov_step_ref.calls += 1
    d = _flush(dots.float().clone())
    if kind == STEP_INIT:
        fs[FS_TOL] = _f32(tol)
        is_[IS_MAXITER] = maxiter
        rs, b2 = d[0], _maxnan(d[1], _TINY)
        rel2 = rs / b2
        finite = bool(torch.isfinite(rel2))
        is_[IS_FLAG] = _NON_FINITE if (bool(fs[FS_TOL] > 0)
                                       and not finite) else 0
        fs[FS_BEST] = rel2 if finite else _f32(float("inf"))
        is_[IS_SINCE] = 0
        is_[IS_K] = 0
        fs[FS_RS], fs[FS_B2], fs[FS_RHO] = rs, b2, rs
        one = _f32(1.0)
        fs[FS_ALPHA], fs[FS_OMEGA] = one, one
        fs[FS_BETA] = (rs / _safe(rs)) * (one / _safe(one))
        go = (int(is_[IS_FLAG]) == 0 and _not_done(rel2, fs[FS_TOL])
              and 0 < maxiter)
        is_[IS_DONE] = int(not go)
        is_[IS_SKIP] = is_[IS_DONE]
        return
    if kind == STEP_BICG1:
        if int(is_[IS_DONE]):
            return
        fs[FS_RHAT_V] = d[0]
        fs[FS_ALPHA] = fs[FS_RHO] / _safe(d[0])
        return
    is_[IS_SKIP] = is_[IS_DONE]
    if int(is_[IS_DONE]):
        return
    check = bool(fs[FS_TOL] > 0)
    b2 = fs[FS_B2].clone()
    if kind == STEP_CG:
        pap, r_ap, apap, rr = d[0], d[1], d[2], d[3]
        bad = check and (bool(pap <= 0) or not bool(torch.isfinite(pap)))
        alpha = torch.zeros_like(pap) if bad else rr / _nz(pap)
        rs = _maxnan(rr - 2 * alpha * r_ap + alpha * alpha * apap,
                     torch.zeros_like(rr))
        _health(fs, is_, rs / b2, bad, check)
        fs[FS_ALPHA] = alpha
        fs[FS_BETA] = rs / _maxnan(rr, _TINY)
        fs[FS_RS] = rs
        _advance(fs, is_)
        return
    if kind == STEP_BICG2:
        t_rhat, t_s, tt, ss, rhat_s = d[0], d[1], d[2], d[3], d[4]
        omega = t_s / _safe(tt)
        rs = _maxnan(ss - 2 * omega * t_s + omega * omega * tt,
                     torch.zeros_like(ss))
        rho = fs[FS_RHO].clone()
        rho_next = rhat_s - omega * t_rhat
        bad = (bool(rho.abs() <= _TINY) or bool(fs[FS_RHAT_V].abs() <= _TINY)
               or bool(tt.abs() <= _TINY))
        _health(fs, is_, rs / b2, bad, check)
        fs[FS_BETA] = (rho_next / _safe(rho)) * (fs[FS_ALPHA] / _safe(omega))
        fs[FS_OMEGA] = omega
        fs[FS_RHO] = rho_next
        fs[FS_RS] = rs
        _advance(fs, is_)
        return
    raise ValueError(f"unknown step kind {kind}")


def krylov_update_ref(kind: int, flag: torch.Tensor, fs: torch.Tensor,
                      us, vs) -> None:
    """The vector update ``kind`` of one fused iteration, in place on
    the vectors ``us`` (nothing when ``flag`` is set), each product and
    sum rounded on its own:

    * ``UPDATE_CG``: us = (x, r, p), vs = (Ap,): x += alpha p;
      r -= alpha Ap; p = r + beta p;
    * ``UPDATE_BICG_P``: us = (p,), vs = (r, v): p = r + beta (p - omega v);
    * ``UPDATE_BICG_S``: us = (s,), vs = (r, v): s = r - alpha v;
    * ``UPDATE_BICG_XR``: us = (x, r), vs = (p, s, t):
      x = (x + alpha p) + omega s; r = s - omega t."""
    krylov_update_ref.calls += 1
    if int(flag):
        return
    alpha, beta = fs[FS_ALPHA].clone(), fs[FS_BETA].clone()
    omega = fs[FS_OMEGA].clone()
    if kind == UPDATE_CG:
        (x, r, p), (ap,) = us, vs
        x.copy_(x + alpha * p)
        r.copy_(r - alpha * ap)
        p.copy_(r + beta * p)
    elif kind == UPDATE_BICG_P:
        (p,), (r, v) = us, vs
        p.copy_(r + beta * (p - omega * v))
    elif kind == UPDATE_BICG_S:
        (s,), (r, v) = us, vs
        s.copy_(r - alpha * v)
    elif kind == UPDATE_BICG_XR:
        (x, r), (p, s, t) = us, vs
        x.copy_((x + alpha * p) + omega * s)
        r.copy_(s - omega * t)
    else:
        raise ValueError(f"unknown update kind {kind}")


def partial_reduce_epilogue(y_sorted: torch.Tensor, own_pos: torch.Tensor,
                            send_pos) -> tuple:
    """Local half of the distributed layer's 2-D partial-sum reduction
    (the reference's ``partial_reduce_epilogue_ref``).

    A rank of a 2-D grid holds PARTIAL sums for its whole row block in
    its sorted row basis.  This gathers its own y slice (``own_pos``,
    the sorted positions of its segment) and, per grid-row distance, the
    partial rows it ships (``send_pos[kk]``, 1-D sorted positions, the
    exact set; ``None`` in the result where it is empty).  The messages
    and the scatter-add live in ``core.dist_spmv``.  No kernel stands
    behind it -- the reference computes it outside Pallas too -- so it
    is the implementation on every device and counts no calls."""
    y_own = y_sorted.index_select(0, own_pos)
    bufs = [y_sorted.index_select(0, pos) if pos.numel() else None
            for pos in send_pos]
    return y_own, bufs


_COUNTED = (pjds_matvec_ref, pjds_matmat_ref, sell_matvec_ref,
            fused_matvec_dots_ref, csr_matvec_ref, ell_matvec_ref,
            cmrs_matvec_ref, krylov_step_ref, krylov_update_ref,
            csr_rmatvec_ref, ell_rmatvec_ref, blocked_rmatvec_ref,
            cmrs_rmatvec_ref)


def reset_calls() -> None:
    """Set every plain-version call count to 0."""
    for fn in _COUNTED:
        fn.calls = 0


reset_calls()
