"""K5's split walk on the CPU: the plan that picks it, the slices it cuts
and a numpy model of its summation order.

The split walk gives the 32 row lanes of one ``warp_len`` entry a CTA of
S warps, each walking one slice of their diagonals, and adds the S
partials in slice order (``kernels/csrc/pjds_spmm.cu``).  The kernel
runs only on the card (``tests/test_torch_kernels.py`` holds it to the
plain version there); here the plan (``pjds_spmm.split_plan``) is held
to the shapes it must send each way, the kernel's slices (modelled
here by ``_slice_diagonals``) to an exact partition of each warp's
walk, and a numpy model of the kernel's order of additions to the plain
version ``ref.pjds_matmat_ref`` within 1e-5 * max|y|: both read the same
stored values and accumulate in f32, only the order differs (the card
also fuses each multiply-add, which the model does not).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import formats as TF
from repro_torch.core import matrices as TM
from repro_torch.kernels import ops as TO
from repro_torch.kernels import pjds_spmm as K5
from repro_torch.kernels import ref as TR
from repro_torch.sparse.sparse_ffn import SparseLinear

H100_SMS = 132


def _synthetic(n_rows, b_r, diags_of_block):
    """(block_start, warp_len) of ``n_rows`` rows in blocks of ``b_r``
    whose block b stores ``diags_of_block(b)`` diagonals, each warp
    walking all of them: the arrays of a conversion, without one."""
    n_blocks = -(-n_rows // b_r)
    lens = np.array([diags_of_block(b) for b in range(n_blocks)], np.int64)
    block_start = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    warp_len = np.repeat(lens, b_r // 32).astype(np.int32)
    return block_start, warp_len


# (name, rows, b_r, stored diagonals of a block, walk): qwen2.5-14b's
# FFN at density 0.1 (w1ᵀ 13,824 rows of 519 stored slots, w2ᵀ 5,120 of
# 1,398; w2 also in row blocks of 32), w1 at density 0.5; the 3.4 M-row
# sAMG's pJDS layout (~18 diagonals a block), Poisson 512² and 128² (5
# a row, stored to 8), and a block-CG sized sAMG
_SHAPES = [
    ("qwen-w1", 13_824, 128, lambda b: 519, "split"),
    ("qwen-w2", 5_120, 128, lambda b: 1_398, "split"),
    ("qwen-w2-b32", 5_120, 32, lambda b: 1_398, "split"),
    ("qwen-w1-d0.5", 13_824, 128, lambda b: 2_568, "split"),
    ("samg-3.4M", 3_405_035, 128, lambda b: 16 + b % 5, "lane"),
    ("poisson-512", 512 * 512, 128, lambda b: 8, "lane"),
    ("poisson-128", 128 * 128, 128, lambda b: 8, "lane"),
    ("samg-10k", 10_215, 128, lambda b: 16 + 8 * (b % 3), "lane"),
]


@pytest.mark.parametrize("k", [1, 4, 8, 128])
@pytest.mark.parametrize("name,n_rows,b_r,diags,walk", _SHAPES,
                         ids=[s[0] for s in _SHAPES])
def test_split_plan_sends_ffn_weights_to_the_split_walk(name, n_rows, b_r,
                                                        diags, walk, k):
    block_start, warp_len = _synthetic(n_rows, b_r, diags)
    n_blocks = block_start.size - 1
    plan = K5.split_plan(n_blocks, b_r, int(block_start[-1]), H100_SMS)
    assert plan.walk == walk
    # the column tile: every column up to 16, 1, 2 or 4 lanes a row
    kt, lanes = K5.column_tile(k)
    assert min(k, 16) <= kt * lanes <= max(k, 4) and lanes in (1, 2, 4)
    if walk == "lane":
        assert plan == K5.LANE
        return
    warps = warp_len.size
    assert 2 <= plan.slices <= K5.MAX_SLICES
    # the split CTAs fill at most half the card, and every slice walks
    # enough diagonals
    assert 2 * warps * plan.slices <= H100_SMS * K5.THREADS_PER_SM // 32
    assert int(block_start[-1]) // n_blocks // plan.slices >= K5.MIN_SLICE


@pytest.mark.parametrize("name", ["samg", "poisson"])
def test_split_plan_keeps_the_test_operands_on_the_lane_walk(name):
    # the operands of the card tests, block CG and the examples: short
    # walks, so the lane walk and its bits are unchanged for them
    m = {"samg": lambda: TM.samg(scale=3e-3),
         "poisson": lambda: TM.poisson_2d(128, 128)}[name]()
    for fmt in ("pjds", "sell"):
        d = TO.as_device(m, fmt, device="cpu").dev
        assert K5.split_plan(d.n_blocks, d.b_r, d.val.shape[0],
                             H100_SMS) == K5.LANE


def test_split_plan_follows_the_sm_count():
    # the same weight on a card of half the SMs gets fewer slices; on a
    # eighth of them its rows alone fill half the card: the lane walk
    bs, wl = _synthetic(13_824, 128, lambda b: 519)
    plans = [K5.split_plan(bs.size - 1, 128, int(bs[-1]), H100_SMS // d)
             for d in (1, 2, 8)]
    assert [p.walk for p in plans] == ["split", "split", "lane"]
    assert plans[1].slices < plans[0].slices


def _walked(block_start, warp_len, b_r):
    """The diagonals each warp walks, as every K5 walk clamps them:
    ``min(max(warp_len[g], 0), its block's stored diagonals)``."""
    stored = np.repeat(np.diff(np.asarray(block_start, np.int64)), b_r // 32)
    return np.minimum(np.maximum(np.asarray(warp_len, np.int64), 0), stored)


def _slice_diagonals(n, slices):
    """The split walk's slices of a warp that walks ``n`` diagonals, as
    ``spmm_split_kernel`` cuts them: slice s is the run ``[s c, s c +
    c)`` clamped to n, c = ceil(n / S), summed in that order."""
    c = -(-n // slices)
    return [range(min(n, s * c), min(n, s * c + c)) for s in range(slices)]


def _edge_warps(b_r):
    """block_start / warp_len with warps of length 0, shorter than any
    S, clamped by their block's stored length (warp_len past it) and
    negative, beside ordinary ones."""
    w = b_r // 32
    stored = [0, 3, 17, 64, 519, 40, 10]
    block_start = np.concatenate([[0], np.cumsum(stored)]).astype(np.int32)
    per_block = {0: [0], 1: [2, 3], 2: [17, 0], 3: [64, 63],
                 4: [519, 400], 5: [-2, 40], 6: [12]}   # 12 > 10: clamped
    warp_len = np.array([per_block[b][i % len(per_block[b])]
                         for b in range(len(stored)) for i in range(w)],
                        np.int32)
    return block_start, warp_len


@pytest.mark.parametrize("slices", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("b_r", [32, 128])
def test_slices_partition_each_warps_walk_in_order(b_r, slices):
    block_start, warp_len = _edge_warps(b_r)
    n = _walked(block_start, warp_len, b_r)
    stored = np.repeat(np.diff(block_start), b_r // 32)
    assert (n == stored).any() and (warp_len > stored).any()
    assert (n == 0).any() and (warp_len < 0).any()
    if slices >= 3:
        assert ((0 < n) & (n < slices)).any()
    for n_g in n:
        sl = _slice_diagonals(int(n_g), slices)
        assert len(sl) == slices
        # each slice walks its diagonals in increasing order ...
        assert all(list(d) == sorted(d) for d in sl)
        # ... together they cover [0, n) once each ...
        assert sorted(j for d in sl for j in d) == list(range(n_g))
        # ... the non-empty slices come first, each a run of at most
        # ceil(n / S) diagonals
        sizes = [len(d) for d in sl]
        assert sizes == sorted(sizes, reverse=True)
        assert max(sizes) == -(-n_g // slices)
        assert all(d.step == 1 for d in sl)


def _np_split_walk(val, col_idx, block_start, warp_len, b_r, X, slices):
    """Y = A X over stored arrays (numpy, permuted basis) in float32, in
    the split walk's order: warp g's lanes each sum their slices'
    diagonals in order, the slices' partials are added s = 0 .. S-1 from
    slice 0's, and a warp that stops short of its block's stored length
    adds 0 * X[0, :] once."""
    w = b_r // 32
    n_blocks = block_start.size - 1
    Y = np.zeros((n_blocks * b_r, X.shape[1]), np.float32)
    n = _walked(block_start, warp_len, b_r)
    for g in range(warp_len.size):
        b, r0 = divmod(g, w)
        lanes = slice(r0 * 32, r0 * 32 + 32)
        j_b = block_start[b]
        parts = []
        for diags in _slice_diagonals(int(n[g]), slices):
            acc = np.zeros((32, X.shape[1]), np.float32)
            for j in diags:
                acc = acc + val[j_b + j, lanes][:, None] * X[
                    col_idx[j_b + j, lanes]]
            parts.append(acc)
        y = parts[0]
        for p in parts[1:]:
            y = y + p
        if n[g] < block_start[b + 1] - j_b:
            y = y + np.float32(0) * X[0][None, :]
        Y[b * b_r + r0 * 32: b * b_r + r0 * 32 + 32] = y
    return Y


def _narrow_ffn(b_r):
    """A narrow pruned FFN weight (1024 inputs, 256 outputs, density
    0.1, Gaussian from seed 29) stored as K5 takes it."""
    w = np.random.default_rng(29).standard_normal((1024, 256)).astype(
        np.float32)
    return SparseLinear.from_dense(w, 0.1, b_r=b_r, device="cpu").a


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("slices", [2, 3, 16])
@pytest.mark.parametrize("b_r", [32, 128])
def test_split_walk_model_matches_the_plain_version(b_r, slices, k):
    d = _narrow_ffn(b_r)
    val = d.val.float().numpy()
    X = np.random.default_rng(k).standard_normal(
        (d.max_col + 1, k)).astype(np.float32)
    y = _np_split_walk(val, d.col_idx.numpy().astype(np.int64),
                       d.block_start.numpy(), d.warp_len.numpy(), b_r, X,
                       slices)
    want = TR.pjds_matmat_ref(d.val, d.col_idx, d.row_block,
                              torch.from_numpy(X), d.n_blocks).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(y - want).max() <= 1e-5 * scale
    # the operand exercises what the model must get right: every walk
    # cut into S slices, padding skipped at the end of some warps
    n = _walked(d.block_start.numpy(), d.warp_len.numpy(), b_r)
    assert (n >= slices).all()
    stored = np.repeat(np.diff(d.block_start.numpy()), b_r // 32)
    assert (n < stored).any()


@pytest.mark.parametrize("poison", [float("nan"), float("inf"),
                                    float("-inf")])
@pytest.mark.parametrize("b_r", [32, 128])
def test_split_walk_model_poisons_like_the_plain_version(b_r, poison):
    # a NaN or Inf in X[0, c] poisons column c of the same rows as the
    # plain version -- the rows whose walk reads column 0 or skips
    # padding -- and no other column
    d = _narrow_ffn(b_r)
    k, c = 4, 2
    X = np.random.default_rng(7).standard_normal(
        (d.max_col + 1, k)).astype(np.float32)
    X[0, c] = poison
    with np.errstate(invalid="ignore", over="ignore"):
        y = _np_split_walk(d.val.float().numpy(),
                           d.col_idx.numpy().astype(np.int64),
                           d.block_start.numpy(), d.warp_len.numpy(), b_r,
                           X, 3)
    want = TR.pjds_matmat_ref(d.val, d.col_idx, d.row_block,
                              torch.from_numpy(X), d.n_blocks).numpy()
    np.testing.assert_array_equal(np.isnan(y), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(y), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(y), np.isneginf(want))
    bad = ~np.isfinite(y)
    assert bad[:, c].any() and not np.delete(bad, c, axis=1).any()


def test_plan_for_is_shape_only_and_kept():
    # the plan is built from the stored shapes and kept per shape
    d = _narrow_ffn(32)
    a = K5.split_plan(d.n_blocks, d.b_r, d.val.shape[0], H100_SMS)
    b = K5.split_plan(d.n_blocks, d.b_r, d.val.shape[0], H100_SMS)
    assert a is b
    p = TF.csr_to_pjds(TF.csr_from_dense(np.eye(64, dtype=np.float32)),
                       b_r=32)
    assert K5.split_plan(p.n_blocks, 32, p.val.shape[0],
                         H100_SMS) == K5.LANE
