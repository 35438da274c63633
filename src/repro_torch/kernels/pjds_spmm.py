"""K5: pJDS sparse matrix times a block of right-hand sides, hand-written
for Hopper.

Replaces ``repro/kernels/pjds_spmm.py::pjds_matmat_kernel_call`` (the
Pallas TPU kernel behind block CG, the distributed matmat, the sparse
FFN and the serving block solves).  The CUDA source is
``csrc/pjds_spmm.cu``: K1's layout -- one CTA per row block, one thread
per row lane -- with a register tile of up to 8 accumulator columns per
thread; each gathered row of the row-major ``X`` is a contiguous run of
floats, read with 16-byte loads when ``k`` is a multiple of 4 and ``X``
is 16-byte aligned; each row of ``Y`` is stored the same way.  Wider
blocks run one column tile of 8 per grid row.  ``k == 0`` returns zeros
without a launch, as the reference does.  SELL reaches it through its
pJDS layout (``ops.SparseDevice.matmat``), which also hands it a row
map (``out_row``) so that each row is stored at its original position:
the unpermute is folded into the store instead of a separate pass.

What bounds it on an H100: bytes.  Blocks are padded to their longest
row and to ``diag_align`` (2.70 x nnz slots on the 3.4 M-row sAMG's SELL
layout), so each warp walks only its first ``warp_len`` diagonals (the
lengths K1 and K2 walk, ``ops.sell_warp_len``: 1.05 x nnz there),
several diagonals per step with their loads and X-row gathers in flight,
and adds the skipped padding's ``0 * X[0, c]`` once per column -- Y keeps
the bits of the full walk, and a NaN or Inf in ``X[0, c]`` poisons
column c of the same rows.  The bytes it must move are then the walked
slots x (value + index width) per column tile, ``X`` read and ``Y``
written once -- until k reaches the hundreds, where the 2 k flops per
slot take over.

That is the lane walk: one thread a row lane.  It starves the card on
an FFN weight -- qwen2.5-14b's w1ᵀ has 13,824 rows of 519 stored
diagonals, 432 warps on a card that holds 8,448 -- so K5 has a second
walk, the split walk: the 32 row lanes of one ``warp_len`` entry get a
CTA of S warps, warp s walks slice s of their ``[0, warp_len)``
diagonals (a contiguous run of ceil(warp_len / S)), and the S partials
of each (row, column) are added in slice order in shared memory, then
the skipped padding's ``0 * X[0, c]`` once: deterministic, no atomics,
the same poisoning.  Its column tiles reach 16 columns, 4 a lane, with 2 or 4
lanes sharing a row (:func:`column_tile`), so a warp-wide gather reads
runs of 32 or 64 bytes of X's rows, not 16.  :func:`split_plan` picks
the walk and S from the operand's shape and the card's SM count;
:class:`K5Plan` carries the choice, and
``pjds_matmat_kernel_call(..., plan=)`` takes either walk on any
operand.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _build
from ._backend import check_blocked, kind_codes, stream_of

__all__ = ["K5Plan", "LANE", "column_tile", "pjds_matmat_kernel_call",
           "plan_for", "split_plan"]


# The split walk's limits (csrc/pjds_spmm.cu: kMaxSlices) and the plan's
# thresholds; the measurements behind them are in split_plan's docstring.
MAX_SLICES = 16
MIN_SLICE = 16
THREADS_PER_SM = 2048     # resident threads an SM holds (sm_90)


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """How K5 walks an operand: ``walk`` "lane" (one thread a row lane)
    or "split", with ``slices`` warps per 32 row lanes (S)."""
    walk: str = "lane"
    slices: int = 1


LANE = K5Plan()


def column_tile(k: int) -> tuple:
    """``(kt, lanes_per_row)`` of the split walk's column tile for ``k``
    right-hand sides: one lane a row up to 4 columns (kt 1, 2, 4), then
    4 columns a lane and 2 or 4 lanes a row -- tiles of up to 16
    columns, 64 contiguous bytes of each gathered row of X.  On
    qwen2.5-14b's w1 and w2 (``kernel_ab.py --k5-ffn``) tiles of 32 (8
    lanes a row) were 1.14-1.17 x slower at T = 32 and 128, and tiles of
    4 or 8 where this picks wider ones 1.3-3.3 x slower."""
    if k <= 2:
        return max(k, 1), 1
    lanes = 1
    while lanes < 4 and 4 * lanes < k:
        lanes *= 2
    return 4, lanes


@functools.lru_cache(maxsize=None)
def split_plan(n_blocks: int, b_r: int, n_diags: int, sms: int) -> K5Plan:
    """K5's walk for an operand of ``n_blocks`` row blocks of ``b_r``
    lanes and ``n_diags`` stored diagonals in all (``val.shape``), at any
    number of right-hand sides, on a card of ``sms`` SMs
    (``torch.cuda.get_device_properties(dev).multi_processor_count``).
    Shape only: no read of the device, no timing.

    S is the largest power of two at most min(MAX_SLICES, R // (2 W),
    L // MIN_SLICE), with W the operand's warps (``n_blocks * b_r /
    32``), R the warps the card holds at once (``sms * THREADS_PER_SM /
    32``: 8,448 on a 132-SM H100) and L the mean stored diagonals a
    block; S < 2 keeps the lane walk.  The split walk thus takes
    operands whose CTAs fill at most half the card and whose every slice
    walks at least MIN_SLICE diagonals: qwen2.5-14b's w1ᵀ (W = 432, L =
    516: S = 8) and w2ᵀ (W = 160, L = 1,390: S = 16), never sAMG (W =
    106 k), Poisson 512² (W = 8,192, L = 8) or the short rows of block
    CG, the distributed layer's partitions and the examples (L < 32).

    The measurements behind the rule (``kernel_ab.py --k5-ffn``, H100
    80GB HBM3 at 700 W, CUDA-graph device time, f32, T = 4, ms): w1ᵀ
    took 0.1150 on the lane walk and 0.0979 / 0.0522 / 0.0319 / 0.0219
    / 0.0289 at S = 1 / 2 / 4 / 8 / 16, w2ᵀ 0.2989 and 0.2804 / 0.1405
    / 0.0727 / 0.0415 / 0.0308: the best S fills about half the card.
    The warps term: at L = 55 (1,024 inputs at density 0.05) the best
    split walk beat the lane walk 2.2 x at 432 warps (0.0064 against
    0.0141), 1.6 x at 1,024 (0.0073 / 0.0115), 1.3 x at 2,048 (0.0119 /
    0.0157) and lost at 4,096 (0.0221 / 0.0216), as on Poisson 512²
    (8,192 warps: lane 0.0100, split 0.0116-0.0650); the rule splits up
    to R / 4 = 2,112 warps, inside that crossover.  MIN_SLICE is not a
    crossover but a policy: at 432 warps the split walk won down to the
    shortest blocks measured (w1 at density 0.002, L = 14: lane 0.0067,
    S = 4 0.0048; L = 29: 0.0092 against 0.0063), so it costs such
    operands up to 1.5 x; it keeps the operands of few, short rows --
    block CG's and the card tests' small matrices, the examples -- on
    the lane walk and its bits."""
    warps = n_blocks * b_r // 32
    if warps <= 0:
        return LANE
    resident = sms * THREADS_PER_SM // 32
    most = min(MAX_SLICES, resident // (2 * warps),
               n_diags // n_blocks // MIN_SLICE)
    if most < 2:
        return LANE
    slices = 1 << (most.bit_length() - 1)     # a power of two
    return K5Plan("split", slices=slices)


def _fn(split: bool = False):
    lib = _build.load("pjds_spmm")
    fn = lib.pjds_spmm_split if split else lib.pjds_spmm
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, i, p, i, p, p, p, p, p, i, i, i, i]
                       + [i] * 3 * split + [p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(val: torch.Tensor, n_blocks: int) -> K5Plan:
    """:func:`split_plan` for a stored value array ``val`` on its card."""
    return split_plan(n_blocks, val.shape[1], val.shape[0],
                      _sms(val.device.index))


def pjds_matmat_kernel_call(val: torch.Tensor, col_idx: torch.Tensor,
                            block_start: torch.Tensor, warp_len: torch.Tensor,
                            x: torch.Tensor, *, n_blocks: int, max_col: int,
                            out_row: Optional[torch.Tensor] = None,
                            n_out: int = 0,
                            plan: Optional[K5Plan] = None) -> torch.Tensor:
    """Y = A_pjds @ X through K5.

    Operands as for K1 (``warp_len``: (n_blocks * b_r / 32,) int32, the
    diagonals each warp walks, ``ops.sell_warp_len``;
    ``ops.stored_warp_len`` walks them all); x: (> max_col, k) f32|bf16
    on the same card (a strided X is copied to row-major first).
    Returns Y float32: in the permuted basis, (n_blocks * b_r, k), or
    with a row map ``out_row`` (n_blocks * b_r,) int32 -- a bijection
    from the stored rows onto ``range(n_out)``, -1 for padding rows --
    as (n_out, k) with stored row p at row ``out_row[p]``.  ``plan``:
    the walk (:class:`K5Plan`); :func:`plan_for` by default."""
    b_r = val.shape[1]
    vectors = [("warp_len", warp_len, n_blocks * b_r // 32)]
    if out_row is not None:
        vectors.append(("out_row", out_row, n_blocks * b_r))
    x = check_blocked(val, col_idx, block_start, x, n_blocks, max_col,
                      vectors=vectors, x_dim=2)
    if warp_len.dtype != torch.int32:
        raise TypeError("warp_len must be int32")
    if out_row is not None and out_row.dtype != torch.int32:
        raise ValueError("out_row must be int32")
    k = x.shape[1]
    y = torch.empty((n_blocks * b_r if out_row is None else n_out, k),
                    dtype=torch.float32, device=x.device)
    if k == 0:
        return y
    # y is freshly allocated, so 16-byte aligned: x decides float4 use
    vec4 = int(k % 4 == 0 and x.data_ptr() % 16 == 0)
    if plan is None:
        plan = plan_for(val, n_blocks)
    split = plan.walk == "split"
    if not split and plan.walk != "lane":
        raise ValueError(f"unknown K5 walk {plan.walk!r}")
    tail = [*column_tile(k), plan.slices] if split else []
    vk, ik = kind_codes(val, col_idx)
    rc = _fn(split)(val.data_ptr(), vk, col_idx.data_ptr(), ik,
                    block_start.data_ptr(), warp_len.data_ptr(),
                    x.data_ptr(),
                    None if out_row is None else out_row.data_ptr(),
                    y.data_ptr(), n_blocks, b_r, k, vec4, *tail,
                    stream_of(x))
    _build.check("pjds_spmm", rc, f"pjds_spmm launch ({plan.walk} walk)")
    _build.count_launch(pjds_matmat_kernel_call)
    if split:
        _build.count_launch(pjds_matmat_kernel_call, "split_launches")
    return y


pjds_matmat_kernel_call.launches = 0
# the launches that took the split walk (a part of ``launches``)
pjds_matmat_kernel_call.split_launches = 0
