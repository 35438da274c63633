#!/usr/bin/env python3
"""Time K3 (fused spMV + dots) and K5 (multi-RHS pJDS) against other
builds of them, in one process on one CUDA card, at the 3.4 M-row sAMG
size (K3 and K2 also on the 512 x 512 Poisson operator).

    mkdir -p experiments/parent
    git archive a8e8064 | tar -x -C experiments/parent
    python3 kernel_ab.py experiments/parent

Each build first has to give this tree's y bit for bit (``torch.equal``;
K3's five dots within ``DOT_TOL`` relative, since another CTA shape sums
them in another order) on the same operands; it is then timed in turns
with this tree's kernel (build, this tree, this tree, build; CUDA
events, median and quartiles of 30 samples of 10 back-to-back launches
each, so the host's launch overhead stays hidden; on Poisson, where one
launch's host overhead outlasts the kernel, the 10 launches are one CUDA
graph).  K5 runs on the SELL layout with the operator's row map, at
k = 8 (``op @ X``) and k = 4 (block CG).  The builds:

* ``parent``: ``<parent>/src/repro_torch/kernels/csrc/{fused_iter,
  pjds_spmm,pjds_spmv,sell_spmv}.cu`` as the earlier tree had them,
  bound through the C interface they had there (commit a8e8064: K3 and
  K5 without ``warp_len``, walking every stored diagonal, K3 in a
  window CTA of one thread per row, 1024; K1 and K2 as now, their
  common header before K2's window walk moved into it);
* design alternatives, each this tree's source with a line replaced:
  K3 with a 1024-thread window CTA instead of 128, and with 128 threads
  even where that leaves the card idle (the tree gives a window more
  threads when too few windows would fill the card: Poisson 512^2);
  K5 with 1, 2 or 4 diagonals per step at k = 4 and at k = 8 (the
  tree's own choice is left out), held to at most 40 or 32 registers
  per thread (``__launch_bounds__`` for 128-thread CTAs, 12 or 16 of
  them per SM), with its X gathers through L2 only (``__ldcg``) instead
  of the read-only path (``__ldg``), and with its value and index
  streams through ``__ldg`` instead of ``__ldcs``;
* full walks: this tree's K3 and K5 given every stored length
  (``ops.stored_warp_len``) instead of the derived ones.

With ``--k7`` it times K7 (the transpose product z = A^T y) instead,
on sAMG's pJDS, SELL, ELLPACK-R and CMRS operands at k = 1 and k = 4
(parent: ``git archive 4a3f22c``, the first K7, one thread per column),
then on a matrix of power-law column lengths (1 M rows, 250 k columns,
13.6 M non-zeros, columns of up to 200 k) with the parent, the other
mode, long columns walked and a 1 KB buffer (5 single launches a
sample: the longest column paces a call).  Each build is held to this
tree's z bit for bit (``torch.equal``), then timed in turns as above.
The builds:

* ``parent:transpose_spmv``: the earlier source and C interface, on y
  padded (ELLPACK-R, CMRS) or scattered to the sorted rows (pJDS, SELL),
  as that tree's operator passed it; ``parent:op_T`` adds that copy of
  y, so it is the earlier ``op.T @ y`` (this tree's side: ``op.T @ y``);
* ``k7_other_mode``: the mode ``transpose_spmv.staged`` does not pick
  -- every tile walked at k = 1, every tile staged at k = 4;
* ``k7_rows_the_other_way`` (ELLPACK-R): y's row of each slot read
  from an index (``slot_rows``, 4 bytes per non-zero), as pJDS, SELL
  and CMRS read it, where the tree computes it from the slot's
  position;
* ``k7_unroll_{4,16}``: the slots a thread loads at once (``kUnroll``,
  8 in the tree); ``k7_no_register_cap`` and
  ``k7_at_most_{64,32}_registers`` (4 or 8 CTAs of 256 threads per SM;
  the tree asks for 6, at most 40 registers); ``k7_cta_128``: CTAs (and
  walked tiles) of 128 columns;
* ``k7_buffer_{1,8,32}kb``: a staging buffer (``TILE_BYTES``) of 1,
  8 or 32 KB (16 KB in the tree: 4096 slots at k = 1, 1024 at k = 4),
  for staged tiles and long columns alike;
* ``k7_long_16``: a walked plan's columns over 16 slots staged by a CTA
  of their own (``LONG_SLOTS``, 128 in the tree); ``k7_long_walked``
  (long-column matrix): none, every column walked by its thread;
  ``k7_walk_reserves_buffer`` (k = 4 on sAMG): a launch that only walks
  reserves the 16 KB buffer all the same (the tree reserves none);
* ``k7_index_pairs`` (k = 1; pJDS, SELL, CMRS): each slot and its row
  as one int2 of an interleaved index, one load for both.

cuSPARSE on a CSR of A^T (``torch.mv``) is timed beside them.

With ``--k5-ffn`` it times K5's two walks on the sparse FFN's weights
instead (no parent tree): qwen2.5-14b's w1 (5,120 x 13,824) and w2
(13,824 x 5,120), Gaussian from seed 0 and magnitude-pruned to density
0.1 (``SparseLinear.from_dense``), f32 and bf16 values, T = 4, 8, 32
and 128 (X (n_in, T) from seed 1), each as the operator launches it
(row map); then, at T = 4, w1 at densities 0.002, 0.003, 0.005 and 0.01
(blocks of ~14-55 stored diagonals; 0.005 also in row blocks of 32),
Gaussian weights of 1,024 inputs and 13,824-131,072 outputs at density
0.05 (432-4,096 warps of ~52 diagonals) and Poisson 512^2 (8,192 warps
of ~5 diagonals), where the plan's thresholds sit.  Through the wrapper (``pjds_spmm.K5Plan``): the lane
walk, ``split_plan``'s own plan and the split walk at S = 1, 2, 4, 8
and 16, whatever the plan says.  At the plan's S (4 where it keeps the
lane walk), through the tree's library: column tiles of 4 (one lane a
row) and 8 (two) where ``column_tile`` picks wider ones.  At the same S,
builds of this tree's source with lines replaced: a slice's diagonals
a step (``kSplitStep`` 2 or 8, the tree 4); the value and index streams
through ``__ldg`` instead of ``__ldcs``; tiles of 32 columns (8 lanes a
row, 128-byte runs of X) past 16 columns; the column tiles walked in
turn inside one CTA instead of side by side on the grid; X's rows
staged in shared memory by each CTA before its walk (a build for w1's
5,120 rows and one for w2's 13,824, where the tile fits in 227 KB).
Every plan and build is held to the plain version within ``Y_TOL``
(1e-5 max|y|) and to its own bits on a second call, then all are timed
in turns (forward, backward, forward, backward; the median of the four
medians), each sample a CUDA graph of 10 calls (device time: the
wrapper's host work outlasts a call), the plan's own also as a burst
of 10 host calls (``plan_burst_ms``), beside cuBLAS's bf16 ``x @
w_pruned`` and cuSPARSE (``torch.sparse.mm`` of the pruned Wᵀ as an
f32 CSR by X), each a burst.

Sources and libraries go to ``build/kernel_ab/``.  Prints one JSON line
per build and operand (with ``ptxas``'s registers and spills per
kernel), then ``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

DOT_TOL = 1e-4
K3_WINDOW = "constexpr int kWindowThreads = 128;"
K3_FILL = "if (fill > per) per = (int)fill;"
K5_STEP = {4: "constexpr int kStepK4 = {};",
           8: "constexpr int kStepK8 = {};"}
K5_KERNEL = "__global__ void spmm_kernel("
K5_X_LOADS = ("__ldg((const float4*)xr + q)", "__ldg(xr + q)")
K5_STREAMS = ("__ldcs(vp + u * st)", "__ldcs(cp + u * st)")


def _variants(parent_csrc: pathlib.Path) -> dict:
    """label -> (kernel, source directory, {old text: new text}, full
    walk?)."""
    out = {f"parent:{k}": (k, parent_csrc, {}, False)
           for k in ("fused_iter", "pjds_spmm", "pjds_spmv", "sell_spmv")}
    out["k3_window_1024"] = ("fused_iter", CSRC, {
        K3_WINDOW: K3_WINDOW.replace("128", "1024")}, False)
    out["k3_window_128_fixed"] = ("fused_iter", CSRC, {K3_FILL: ""}, False)
    src = (CSRC / "pjds_spmm.cu").read_text()
    for kt, line in K5_STEP.items():
        now = line.format(re.search(line.format(r"(\d+)"), src).group(1))
        for u in (1, 2, 4):
            if line.format(u) != now:
                out[f"k5_k{kt}_step_{u}"] = ("pjds_spmm", CSRC,
                                             {now: line.format(u)}, False)
    for regs, ctas in ((40, 12), (32, 16)):       # b_r 128: 128 threads
        out[f"k5_at_most_{regs}_registers"] = ("pjds_spmm", CSRC, {
            K5_KERNEL: K5_KERNEL.replace(
                "void ", f"void __launch_bounds__(128, {ctas}) ")}, False)
    out["k5_x_through_l2_only"] = ("pjds_spmm", CSRC, {
        s: s.replace("__ldg", "__ldcg") for s in K5_X_LOADS}, False)
    out["k5_streams_ldg"] = ("pjds_spmm", CSRC, {
        s: s.replace("__ldcs", "__ldg") for s in K5_STREAMS}, False)
    out["k3_full_walk"] = ("fused_iter", CSRC, {}, True)
    out["k5_full_walk"] = ("pjds_spmm", CSRC, {}, True)
    return out


# pointer arguments between (val, kind, col, kind) and the int tail, for
# this tree (False) and the parent (True)
_N_PTRS = {("fused_iter", False): 11, ("fused_iter", True): 9,
           ("pjds_spmm", False): 5, ("pjds_spmm", True): 4,
           ("pjds_spmv", False): 4, ("pjds_spmv", True): 4,
           ("sell_spmv", False): 6, ("sell_spmv", True): 6}
_N_INTS = {"fused_iter": 3, "pjds_spmm": 4, "pjds_spmv": 2, "sell_spmv": 3}


K7_UNROLL = "constexpr int kUnroll = 8;"
K7_CTAS = "constexpr int kMinCtas = 6;"
K7_THREADS = "constexpr int kThreads = 256;"
K7_PAIR = {   # the walk's and the staging's index loads -> one int2 load
    """          p[u] = __ldg(slot + q);
          if (STORED) r[u] = __ldg(L.rows + q);""":
    """          const int2 t = __ldg((const int2*)L.rows + q);
          p[u] = t.x;
          r[u] = t.y;""",
    """      p[u] = __ldg(slot + q);
      r[u] = STORED ? __ldg(L.rows + q) : p[u] % L.width;""":
    """      const int2 t = __ldg((const int2*)L.rows + q);
      p[u] = t.x;
      r[u] = t.y;"""}
NEVER = 1 << 30


def _k7_variants(parent_csrc: pathlib.Path) -> dict:
    """label -> (source directory or None for the tree's library,
    {old text: new text}, how: ``transpose_spmv`` constants to set while
    the plan is built and the call made, ``"other"`` (the mode
    ``staged`` does not pick), ``"reserve"`` (a buffer where the tree
    reserves none), ``"pairs"`` or ``"rows"``; None for the
    parent)."""
    return {
        "parent:transpose_spmv": (parent_csrc, {}, None),
        "parent:op_T": (parent_csrc, {}, None),
        "k7_other_mode": (None, {}, "other"),
        "k7_rows_the_other_way": (None, {}, "rows"),
        "k7_unroll_4": (CSRC, {K7_UNROLL: K7_UNROLL.replace("8", "4")}, {}),
        "k7_unroll_16": (CSRC, {K7_UNROLL: K7_UNROLL.replace("8", "16")},
                         {}),
        "k7_no_register_cap": (CSRC, {
            K7_CTAS: K7_CTAS.replace("6", "1")}, {}),
        "k7_at_most_64_registers": (CSRC, {
            K7_CTAS: K7_CTAS.replace("6", "4")}, {}),
        "k7_at_most_32_registers": (CSRC, {
            K7_CTAS: K7_CTAS.replace("6", "8")}, {}),
        "k7_cta_128": (CSRC, {K7_THREADS: K7_THREADS.replace("256", "128")},
                       {"TILE_COLS": 128}),
        "k7_buffer_1kb": (None, {}, {"TILE_BYTES": 1024}),
        "k7_buffer_8kb": (None, {}, {"TILE_BYTES": 8 * 1024}),
        "k7_buffer_32kb": (None, {}, {"TILE_BYTES": 32 * 1024}),
        "k7_long_16": (None, {}, {"LONG_SLOTS": 16}),
        "k7_long_walked": (None, {}, {"LONG_SLOTS": NEVER}),
        "k7_walk_reserves_buffer": (None, {}, "reserve"),
        "k7_index_pairs": (CSRC, K7_PAIR, "pairs"),
    }


# the variants timed on the long-column matrix (its longest column's
# serial sum paces a call: fewer, single-launch samples)
K7_LONG_COLUMN_VARIANTS = ("parent:transpose_spmv", "k7_other_mode",
                           "k7_long_walked", "k7_buffer_1kb")


def _long_column_matrix():
    """A matrix of power-law column lengths: 1 M rows, 250 k columns,
    Zipf(1.6) lengths up to 5000 and columns of 200 k, 50 k and 10 k
    non-zeros (13.6 M in all), rows drawn uniformly (seed 5)."""
    import numpy as np
    from repro_torch.core import formats as TF
    rng = np.random.default_rng(5)
    n_rows, n_cols = 1_000_000, 250_000
    lens = np.clip(rng.zipf(1.6, n_cols), 1, 5000)
    lens[:3] = (200_000, 50_000, 10_000)
    key = np.unique(np.repeat(np.arange(n_cols, dtype=np.int64), lens)
                    * n_rows + rng.integers(0, n_rows, int(lens.sum())))
    vals = rng.standard_normal(key.size).astype(np.float32)
    return TF.csr_from_coo(key % n_rows, key // n_rows, vals,
                           (n_rows, n_cols))


class _consts:
    """``transpose_spmv``'s constants set to ``values`` inside the
    block."""

    def __init__(self, mod, values):
        self.mod, self.values = mod, dict(values)

    def __enter__(self):
        self.kept = {k: getattr(self.mod, k) for k in self.values}
        for k, v in self.values.items():
            setattr(self.mod, k, v)

    def __exit__(self, *exc):
        for k, v in self.kept.items():
            setattr(self.mod, k, v)


def k7_main(args) -> int:
    """K7 against the parent's and against design alternatives."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import formats as TF
    from repro_torch.core import matrices as TM
    from repro_torch.kernels import _build
    from repro_torch.kernels import transpose_spmv as K7
    from repro_torch.kernels._backend import VALUE_DTYPES, stream_of

    variants = _k7_variants(args.parent / "src" / "repro_torch" / "kernels"
                            / "csrc")
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    procs, libs = {}, {}
    for label, (src_dir, subs, _) in variants.items():
        if src_dir is None or label == "parent:op_T":
            continue
        d = ROOT / "build" / "kernel_ab" / label.replace(":", "_")
        d.mkdir(parents=True, exist_ok=True)
        text = (src_dir / "transpose_spmv.cu").read_text()
        for old, new in subs.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{label}: text to replace not found once")
            text = text.replace(old, new)
        (d / "transpose_spmv.cu").write_text(text)
        procs[label] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "transpose_spmv.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    _build.build_all()
    regs = {}
    for label, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label} failed to build:\n{log}")
        regs[label] = _build.ptxas_usage(log)
        fn = ctypes.CDLL(str(d / "lib.so")).transpose_spmv
        fn.argtypes = ([p_, i_, p_, p_, p_, p_, i_, p_, p_, i_, i_, p_]
                       if label.startswith("parent:") else
                       [p_, i_, p_, p_, p_, p_, i_, i_, i_, p_, p_, i_, i_,
                        i_, p_])
        fn.restype = ctypes.c_int
        libs[label] = fn
    libs["parent:op_T"] = libs["parent:transpose_spmv"]
    print(json.dumps({"phase": "ab:k7_tree_ptxas", "ptxas": _build.ptxas_usage(
        _build.build_log("transpose_spmv"))}), flush=True)
    tree_fn = K7._fn()

    def ctypes_call(fn, d, slot, colptr, y, layout, plan=None, slots=0,
                    stage=False, k=1, parent=False):
        z = torch.empty((colptr.numel() - 1,) + tuple(y.shape[1:]),
                        device="cuda")
        ptr = lambda t: None if t is None else t.data_ptr()
        kind = VALUE_DTYPES.index(d.val.dtype)
        if parent:
            rc = fn(d.val.data_ptr(), kind, slot.data_ptr(),
                    colptr.data_ptr(), ptr(layout.get("base")),
                    ptr(layout.get("row_in_strip")), layout["width"],
                    y.data_ptr(), z.data_ptr(), colptr.numel() - 1, k,
                    stream_of(y))
        else:
            rc = fn(d.val.data_ptr(), kind, slot.data_ptr(),
                    ptr(layout.get("rows")), colptr.data_ptr(),
                    plan.data_ptr(), plan.numel() - 1, layout["width"],
                    y.shape[0], y.data_ptr(), z.data_ptr(), k, slots,
                    int(stage), stream_of(y))
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        return z

    def run_matrix(name, m, labels, timing):
        n = m.n_rows
        rng = np.random.default_rng(0)
        ys = {1: torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              .cuda(),
              4: torch.from_numpy(rng.standard_normal((n, 4)).astype(
                  np.float32)).cuda()}
        a_t = TF.csr_transpose(m)
        at_csr = torch.sparse_csr_tensor(
            torch.from_numpy(a_t.indptr.astype(np.int64)),
            torch.from_numpy(a_t.indices.astype(np.int64)),
            torch.from_numpy(a_t.data.astype(np.float32)),
            size=a_t.shape).cuda()
        del a_t
        for fmt in ("pjds", "sell", "ellpack_r", "cmrs"):
            op = repro_torch.operator(m, fmt)
            sd, d = op.dev, op.dev.dev
            slot, colptr = sd.slot_index()
            # the parent's layout keywords and y (padded, or scattered to
            # the sorted rows); this tree's rows read from the index
            # (slot_rows), ELLPACK-R's computed from the slots' positions
            if fmt in ("sell", "pjds"):
                layout = dict(base=d.row_block, width=d.b_r)
                to_stored = lambda v: sd._scatter_to_storage(v, d.n_rows_pad)
            else:
                layout = (dict(width=d.n_rows_pad) if fmt == "ellpack_r" else
                          dict(base=d.strip_map, width=d.b_r,
                               row_in_strip=d.row_in_strip))
                to_stored = lambda v: sd._pad_rows(v, d.n_rows_pad)
            tree_layout = dict(width=layout["width"], rows=sd.slot_rows())
            lib_ms, modes = {}, {}
            for k, y in ys.items():
                ystored = to_stored(y)
                modes[k] = "staged" if K7.staged(k) else "walked"
                plan, longest = sd.tile_plan(k), sd.longest_column()
                this = lambda: K7.transpose_matvec_kernel_call(
                    d.val, slot, colptr, y, n_rows=n, plan=plan,
                    longest=longest, **tree_layout)
                this_op = lambda: op.T @ y
                lib_ms[k] = time_ms(lambda: torch.mv(at_csr, y) if k == 1
                                    else at_csr @ y, **timing)
                for label in labels:
                    _, _, how = variants[label]
                    if (how == "pairs" and (k != 1 or fmt == "ellpack_r")) or (
                            how == "rows" and fmt != "ellpack_r"):
                        continue
                    fn = libs.get(label, tree_fn)
                    tree = this
                    if label == "parent:transpose_spmv":
                        build = lambda: ctypes_call(
                            fn, d, slot, colptr, ystored, layout, k=k,
                            parent=True)
                    elif label == "parent:op_T":
                        build = lambda: ctypes_call(
                            fn, d, slot, colptr, to_stored(y), layout, k=k,
                            parent=True)
                        tree = this_op
                    else:
                        rows = tree_layout["rows"]
                        if how == "rows":
                            rows = K7.slot_rows(slot, n, width=layout["width"])
                        consts = how if isinstance(how, dict) else {}
                        with _consts(K7, consts):
                            stage = K7.staged(k) != (how == "other")
                            s_v = (K7.tile_slots(k) if stage
                                   or how == "reserve"
                                   else K7.buffer_slots(k, longest))
                            plan_v = K7.tile_plan(
                                colptr, K7.tile_slots(k) if stage else 0)
                        if how == "pairs":
                            rows = torch.stack([slot, rows], 1).reshape(-1)
                        build = (lambda rows=rows, plan_v=plan_v, s_v=s_v,
                                 stage=stage: ctypes_call(
                                     fn, d, slot, colptr, y, dict(
                                         width=layout["width"], rows=rows),
                                     plan=plan_v, slots=s_v, stage=stage,
                                     k=k))
                    got, want = build(), tree()
                    if not torch.equal(got, want):
                        err = float((got - want).abs().max())
                        raise AssertionError(
                            f"{label} on {name} {fmt} k={k}: z differs from "
                            f"this tree's (max {err})")
                    t = [time_ms(f, **timing) for f in (build, tree, tree,
                                                        build)]
                    b_ms = float(np.median([t[0][0], t[3][0]]))
                    t_ms = float(np.median([t[1][0], t[2][0]]))
                    print(json.dumps({
                        "phase": f"ab:{label}", "kernel": "transpose_spmv",
                        "operand": f"{name} {fmt} k={k}", "build_ms": b_ms,
                        "tree_ms": t_ms, "build_over_tree": b_ms / t_ms,
                        "tree_is": "op.T @ y" if tree is this_op else "K7",
                        "tree_mode": modes[k], "same_bits": True,
                        "timing": timing or "burst",
                        "ptxas": regs.get(label, {}),
                        "samples_build_tree_tree_build": t}), flush=True)
            lens = colptr[1:] - colptr[:-1]
            print(json.dumps({
                "phase": "ab:k7_operand", "operand": f"{name} {fmt}",
                "nnz": slot.numel(), "tree_modes": modes,
                "tiles": {k: sd.tile_plan(k).numel() - 1 for k in ys},
                "longest_column": int(lens.max()),
                "columns_over_long_slots": int((lens > K7.LONG_SLOTS).sum()),
                "cusparse_At_ms": lib_ms}), flush=True)
            del op, sd, d, tree_layout

    run_matrix("samg", TM.samg(scale=args.scale),
               [v for v in variants if v != "k7_long_walked"], {})
    run_matrix("long_columns", _long_column_matrix(),
               K7_LONG_COLUMN_VARIANTS, dict(reps=5, warm=1, burst=1))
    return 0


Y_TOL = 1e-5
K5S_STEP = "constexpr int kSplitStep = 4;"
K5S_STREAMS = ("__ldcs(sv + u * st)", "__ldcs(sc + u * st)")
K5S_TILE_32 = ("    case 404: REPRO_SPLIT(4, 4);\n",
               "    case 404: REPRO_SPLIT(4, 4);\n"
               "    case 408: REPRO_SPLIT(4, 8);\n")
K5S_TILES_IN_CTA = {
    "  const int c0 = blockIdx.y * TC, kt = min(TC, k - c0);\n":
        "  for (int c0 = 0; c0 < k; c0 += TC) {\n"
        "  const int kt = min(TC, k - c0);\n",
    "    if (row >= 0) Y[(size_t)row * k + c0 + q] = y;\n  }\n}\n":
        "    if (row >= 0) Y[(size_t)row * k + c0 + q] = y;\n  }\n"
        "  __syncthreads();                            // sum is reused\n"
        "  }\n}\n",
    "(k + TC - 1) / TC);": "1);"}


def _k5s_stage_x(rows: int) -> dict:
    """X[0 : rows, c0 : c0 + TC] (0 past column k) copied into shared
    memory by each CTA before its walk, and gathered from there."""
    return {
        "constexpr int kMaxSlices = 16;\n":
            f"constexpr int kMaxSlices = 16;\nconstexpr int kStageRows = "
            f"{rows};\n",
        "  const int ktl = k - cl;                     // its columns in X "
        "(may be <= 0)\n":
            "  const int ktl = k - cl;\n"
            "  extern __shared__ float xs[];\n"
            "  for (int i = threadIdx.x; i < kStageRows * TC; "
            "i += blockDim.x) {\n"
            "    const int q = i % TC;\n"
            "    xs[i] = q < kt ? __ldg(X + (size_t)(i / TC) * k + c0 + q)"
            " : 0.f;\n"
            "  }\n"
            "  __syncthreads();\n",
        "        load_row<KT>(X + (size_t)cr * k + cl, ktl, vec4, "
        "xv[u][i]);\n":
            "        for (int q = 0; q < KT; ++q)\n"
            "          xv[u][i][q] = xs[(size_t)cr * TC + KT * qg + q];\n",
        "  spmm_split_kernel<V, I, KT, LPR><<<grid, slices * 32, 0, s>>>(":
            "  const size_t smem = sizeof(float) * kStageRows * TC;\n"
            "  if (smem > 48 * 1024)\n"
            "    cudaFuncSetAttribute(spmm_split_kernel<V, I, KT, LPR>,\n"
            "        cudaFuncAttributeMaxDynamicSharedMemorySize, "
            "(int)smem);\n"
            "  spmm_split_kernel<V, I, KT, LPR><<<grid, slices * 32, smem, "
            "s>>>("}


def _k5s_builds() -> dict:
    """label -> ({old text: new text} of pjds_spmm.cu, when): the split
    walk's build alternatives; ``when(k, n_in, tile)`` gives the column
    tile (kt, lanes a row) to launch at, or None where the build does
    not differ from the tree or does not fit."""
    tree = lambda k, n_in, tile: tile
    smem = 227 * 1024

    def staged(rows):
        return lambda k, n_in, tile: tile if n_in == rows and 4 * (
            rows * tile[0] * tile[1] + 32 * (tile[0] * tile[1] + 1)) \
            <= smem else None
    return {
        "k5s_step_2": ({K5S_STEP: K5S_STEP.replace("4", "2")}, tree),
        "k5s_step_8": ({K5S_STEP: K5S_STEP.replace("4", "8")}, tree),
        "k5s_streams_ldg": ({s: s.replace("__ldcs", "__ldg")
                             for s in K5S_STREAMS}, tree),
        "k5s_tile_32": (dict([K5S_TILE_32]),
                        lambda k, n_in, tile: (4, 8) if k > 16 else None),
        "k5s_tiles_in_cta": (K5S_TILES_IN_CTA,
                             lambda k, n_in, tile: tile
                             if k > tile[0] * tile[1] else None),
        "k5s_stage_x_5120": (_k5s_stage_x(5120), staged(5120)),
        "k5s_stage_x_13824": (_k5s_stage_x(13824), staged(13824))}


def k5_ffn_main(args) -> int:
    """K5's lane and split walks on the sparse FFN's weights."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import matrices as TM
    from repro_torch.kernels import _build
    from repro_torch.kernels import pjds_spmm as K5
    from repro_torch.kernels import ref as R
    from repro_torch.kernels._backend import kind_codes, stream_of
    from repro_torch.sparse.sparse_ffn import SparseLinear, prune

    procs, when = {}, {}
    for label, (subs, when[label]) in _k5s_builds().items():
        d = ROOT / "build" / "kernel_ab" / label
        d.mkdir(parents=True, exist_ok=True)
        text = (CSRC / "pjds_spmm.cu").read_text()
        for old, new in subs.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{label}: text to replace not found once:"
                                   f"\n{old}")
            text = text.replace(old, new)
        (d / "pjds_spmm.cu").write_text(text)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        procs[label] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "pjds_spmm.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    _build.build_all()
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    fns, regs = {"tree": K5._fn(True)}, {}
    for label, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label} failed to build:\n{log}")
        regs[label] = _build.ptxas_usage(log)
        fn = ctypes.CDLL(str(d / "lib.so")).pjds_spmm_split
        fn.argtypes = [p_, i_, p_, i_] + [p_] * 5 + [i_] * 7 + [p_]
        fn.restype = ctypes.c_int
        fns[label] = fn
    print(json.dumps({"phase": "ab:k5_tree_ptxas", "ptxas": _build.ptxas_usage(
        _build.build_log("pjds_spmm"))}), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run_operand(name, d, rows, n_out, csr, w16, ks, builds=True):
        gen = torch.Generator(device="cuda").manual_seed(1)
        n_in = csr.shape[1]
        own = K5.split_plan(d.n_blocks, d.b_r, d.val.shape[0], sms)
        base = own if own.walk == "split" else K5.K5Plan("split", slices=4)
        for k in ks:
            x = torch.randn((max(d.max_col + 1, n_in), k), generator=gen,
                            device="cuda")
            want = torch.cat([R.pjds_matmat_ref(
                d.val, d.col_idx, d.row_block, x[:, j:j + 16].contiguous(),
                d.n_blocks) for j in range(0, k, 16)], dim=1)
            want = torch.empty_like(want[:n_out]).index_copy_(
                0, rows.long()[rows >= 0], want[rows >= 0])
            scale = float(want.abs().max())
            alts = {"lane": K5.LANE, "plan": own}
            for s_ in (1, 2, 4, 8, 16):
                alts[f"split_s{s_}"] = K5.K5Plan("split", slices=s_)
            calls = {lbl: (lambda pl=pl: K5.pjds_matmat_kernel_call(
                d.val, d.col_idx, d.block_start, d.warp_len, x,
                n_blocks=d.n_blocks, max_col=d.max_col, out_row=rows,
                n_out=n_out, plan=pl)) for lbl, pl in alts.items()}
            tile = K5.column_tile(k)
            launch = {}
            if builds:
                for lanes in (1, 2):
                    if lanes < tile[1]:
                        launch[f"tile_{4 * lanes}"] = ("tree", (4, lanes))
                for label in procs:
                    at = when[label](k, n_in, tile)
                    if at is not None:
                        launch[label] = (label, at)
            for label, (lib, (kt, lanes)) in launch.items():
                def call(fn=fns[lib], label=label, kt=kt, lanes=lanes):
                    y = torch.empty((n_out, k), device="cuda")
                    vk, ik = kind_codes(d.val, d.col_idx)
                    rc = fn(d.val.data_ptr(), vk, d.col_idx.data_ptr(), ik,
                            d.block_start.data_ptr(), d.warp_len.data_ptr(),
                            x.data_ptr(), rows.data_ptr(), y.data_ptr(),
                            d.n_blocks, d.b_r, k, int(k % 4 == 0), kt,
                            lanes, base.slices, stream_of(x))
                    if rc:
                        raise RuntimeError(f"{label}: CUDA error {rc}")
                    return y
                calls[label] = call
            errs = {}
            for lbl, fn in calls.items():
                y = fn()
                errs[lbl] = float((y - want).abs().max()) / scale
                if not errs[lbl] <= Y_TOL:
                    raise AssertionError(f"{name} k={k} {lbl}: {errs[lbl]} "
                                         f"of max|y| from the plain version")
                if not torch.equal(y, fn()):
                    raise AssertionError(f"{name} k={k} {lbl}: not "
                                         f"bit-repeatable")
            order = list(calls)
            t = {lbl: [] for lbl in order}
            for lbl in 2 * (order + order[::-1]):
                t[lbl].append(time_ms(calls[lbl], graph=True))
            ms = {lbl: float(np.median([v[0] for v in t[lbl]]))
                  for lbl in order}
            burst = time_ms(calls["plan"])[0]
            xt = x[:n_in]
            lib = {"cusparse_ms": time_ms(lambda: torch.sparse.mm(csr, xt))[0]}
            if w16 is not None:
                x16 = xt.T.to(torch.bfloat16).contiguous()
                lib["cublas_bf16_ms"] = time_ms(lambda: x16 @ w16)[0]
            print(json.dumps({
                "phase": "ab:k5_ffn", "operand": name, "k": k,
                "value_dtype": str(d.val.dtype).split(".")[1],
                "index_dtype": str(d.col_idx.dtype).split(".")[1],
                "rows": n_out, "warps": d.n_blocks * d.b_r // 32,
                "stored_diagonals": d.val.shape[0], "b_r": d.b_r,
                "diagonals_a_block": d.val.shape[0] / d.n_blocks,
                "plan": {"walk": own.walk, "slices": own.slices},
                "base_slices": base.slices, "column_tile": list(tile),
                "build_tiles": {lbl: list(at) for lbl, (_, at)
                                in launch.items()},
                "ms": ms, "vs_lane": {lbl: ms[lbl] / ms["lane"]
                                      for lbl in order},
                "plan_burst_ms": burst,
                "samples": t, "max_rel_err_vs_plain": errs, **lib,
                "ptxas": regs}), flush=True)

    rng = np.random.default_rng(0)
    w = {"w1": rng.standard_normal((5120, 13824), dtype=np.float32),
         "w2": rng.standard_normal((13824, 5120), dtype=np.float32)}
    layers = [(n, 0.1, dt, 128) for n in ("w1", "w2")
              for dt in (None, torch.bfloat16)]
    layers += [("w1", dens, None, 128) for dens in (0.002, 0.003, 0.005,
                                                    0.01)]
    layers += [("w1", 0.005, None, 32)]
    # the warps term: 1,024 inputs at density 0.05 (~52 stored diagonals
    # a block) and 13,824-131,072 outputs, 432-4,096 warps
    for n_out in (13824, 32768, 65536, 131072):
        w[f"rand1024x{n_out}"] = rng.standard_normal((1024, n_out),
                                                     dtype=np.float32)
        layers.append((f"rand1024x{n_out}", 0.05, None, 128))
    for n, dens, dt, b_r in layers:
        sl = SparseLinear.from_dense(w[n], dens, dtype=dt, b_r=b_r,
                                     device="cuda")
        wp = prune(w[n], dens)
        csr = torch.from_numpy(np.ascontiguousarray(wp.T)).cuda()
        csr = csr.to_sparse_csr()
        w16 = torch.from_numpy(wp).cuda().to(torch.bfloat16)
        main_ = dens == 0.1
        run_operand(f"{n}@{dens}" + ("" if b_r == 128 else f"/b_r{b_r}"),
                    sl.a, sl.op.dev.row_map(), sl.op.shape[0], csr, w16,
                    (4, 8, 32, 128) if main_ else (4,), builds=main_)
        del sl, csr, w16
        if n.startswith("rand"):
            del w[n]
    mp = TM.poisson_2d(512, 512)
    op = repro_torch.operator(mp, format="sell")
    rows = op.dev.row_map()
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(mp.indptr.astype(np.int64)),
        torch.from_numpy(mp.indices.astype(np.int64)),
        torch.from_numpy(mp.data.astype(np.float32)), size=mp.shape).cuda()
    run_operand("poisson512", op.dev.dev, rows, mp.n_rows, csr, None, (4,),
                builds=False)
    return 0


def time_ms(fn, reps=30, warm=5, burst=10, graph=False):
    """Median and quartiles of ms per call; each sample times ``burst``
    calls back to back (host overhead hidden), or with ``graph`` one
    replay of a CUDA graph that holds them (for kernels shorter than the
    host's launch overhead)."""
    import numpy as np
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(burst)]
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
    t = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        t.append(e0.elapsed_time(e1) / burst)
    return [float(v) for v in np.percentile(t, [50, 25, 75])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=pathlib.Path, nargs="?",
                    help="root of the earlier tree (holds src/repro_torch)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="sAMG scale (1.0: the paper's 3.4 M rows)")
    ap.add_argument("--k7", action="store_true",
                    help="time K7 (the transpose) instead of K3 / K5")
    ap.add_argument("--k5-ffn", action="store_true",
                    help="time K5's walks on the sparse FFN's weights "
                         "(no parent tree needed)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.parent is None and not args.k5_ffn:
        ap.error("the parent tree is needed but with --k5-ffn")
    if args.k7 or args.k5_ffn:
        rc = k7_main(args) if args.k7 else k5_ffn_main(args)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        return rc
    import numpy as np

    import repro_torch
    from repro_torch.core import matrices as TM
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as TO
    from repro_torch.kernels._backend import kind_codes, stream_of
    from repro_torch.kernels.fused_iter import fused_spmv_dots_kernel_call
    from repro_torch.kernels.pjds_spmm import pjds_matmat_kernel_call
    from repro_torch.kernels.pjds_spmv import pjds_matvec_kernel_call
    from repro_torch.kernels.sell_spmv import (sell_matvec_kernel_call,
                                               slab_fits, window_blocks)

    # every build's source, one nvcc each, all at once
    variants = _variants(args.parent / "src" / "repro_torch" / "kernels" /
                         "csrc")
    procs = {}
    for label, (kern, src_dir, subs, full) in variants.items():
        if full:                             # this tree's own library
            continue
        d = ROOT / "build" / "kernel_ab" / label.replace(":", "_")
        d.mkdir(parents=True, exist_ok=True)
        files = {f: (src_dir / f).read_text()
                 for f in ("common.cuh", f"{kern}.cu")}
        for old, new in subs.items():
            if sum(text.count(old) for text in files.values()) != 1:
                raise RuntimeError(f"{label}: text to replace not found once")
            files = {f: text.replace(old, new) for f, text in files.items()}
        for f, text in files.items():
            (d / f).write_text(text)
        procs[label] = (kern, d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / f"{kern}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    _build.build_all()
    fns, regs = {}, {}
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    for label, (kern, d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{label} failed to build:\n{log}")
        regs[label] = _build.ptxas_usage(log)
        fn = getattr(ctypes.CDLL(str(d / "lib.so")),
                     "fused_spmv_dots" if kern == "fused_iter" else kern)
        old = label.startswith("parent:")
        fn.argtypes = ([p_, i_, p_, i_] + [p_] * _N_PTRS[kern, old]
                       + [i_] * _N_INTS[kern] + [p_])
        fn.restype = ctypes.c_int
        fns[label] = fn
    print(json.dumps({"phase": "ab:tree_ptxas", "ptxas": {
        k: _build.ptxas_usage(_build.build_log(k))
        for k in ("fused_iter", "pjds_spmm")}}), flush=True)

    m = TM.samg(scale=args.scale)
    mp = TM.poisson_2d(512, 512)
    rng = np.random.default_rng(0)

    def carriers(d, n_rows):
        """x, w1, w2 at the operand's padded length, zero past n_rows."""
        out = []
        for _ in range(3):
            v = torch.zeros(d.n_rows_pad, device="cuda")
            v[:n_rows] = torch.from_numpy(rng.standard_normal(n_rows).astype(
                np.float32))
            out.append(v)
        return tuple(out)

    op_s = repro_torch.operator(m, format="sell")
    d_s, d_ps = op_s.dev.dev, repro_torch.operator(mp, format="sell").dev.dev
    for d in (d_s, d_ps):
        if not slab_fits(window_blocks(d.sigma, d.b_r, d.n_blocks), d.b_r):
            raise AssertionError("the K3 operands must take the slab path")
    x = carriers(d_s, m.n_rows)[0][: m.n_rows]
    rows = op_s.dev.row_map()
    X8 = torch.from_numpy(rng.standard_normal((m.n_rows, 8)).astype(
        np.float32)).cuda()
    operands = {
        "fused_iter": [("samg", d_s, carriers(d_s, m.n_rows)),
                       ("poisson512", d_ps, carriers(d_ps, mp.n_rows))],
        "pjds_spmm": [("samg k=8", d_s, (X8,)),
                      ("samg k=4", d_s, (X8[:, :4].contiguous(),))],
        "pjds_spmv": [("samg", repro_torch.operator(m, format="pjds")
                       .dev.dev, (x,))],
        "sell_spmv": [("samg", d_s, (x,)),
                      ("poisson512", d_ps, carriers(d_ps, mp.n_rows)[:1])]}

    def launch(label, kern, d, args_):
        old = label.startswith("parent:")
        wl = [] if old else [d.warp_len]
        if kern == "fused_iter":
            v, w1, w2 = args_
            w_b = window_blocks(d.sigma, d.b_r, d.n_blocks)
            y = torch.empty(d.n_rows_pad, device="cuda")
            part = torch.empty((-(-d.n_blocks // w_b), 5), device="cuda")
            dots = torch.empty(5, device="cuda")
            ptrs = [d.block_start, d.inv_perm, *wl, v, w1, w2, y, part, dots]
            tail = [d.n_blocks, d.b_r, w_b]
            out = (y, dots)
        elif kern == "pjds_spmm":
            (xk,) = args_
            y = torch.empty((m.n_rows, xk.shape[1]), device="cuda")
            ptrs = [d.block_start, *wl, xk, rows, y]
            tail = [d.n_blocks, d.b_r, xk.shape[1],
                    int(xk.shape[1] % 4 == 0 and xk.data_ptr() % 16 == 0)]
            out = y
        else:
            (v,) = args_
            y = torch.empty(d.n_rows_pad, device="cuda")
            ptrs = [d.block_start, d.warp_len]
            tail = [d.n_blocks, d.b_r]
            if kern == "sell_spmv":
                ptrs.append(d.inv_perm)
                tail.append(window_blocks(d.sigma, d.b_r, d.n_blocks))
            ptrs += [v, y]
            out = y
        ptrs = [t.data_ptr() for t in ptrs]
        if kern in ("fused_iter", "sell_spmv"):
            ptrs.append(None)                  # slab path: no scratch
        if kern == "fused_iter" and not old:
            ptrs.append(None)                  # no done latch
        vk, ik = kind_codes(d.val, d.col_idx)
        rc = fns[label](d.val.data_ptr(), vk, d.col_idx.data_ptr(), ik,
                        *ptrs, *tail, stream_of(d.val))
        if rc:
            raise RuntimeError(f"{label}: CUDA error {rc}")
        return out

    def tree(kern, d, args_, full=False):
        wl = TO.stored_warp_len(d.block_start, d.b_r) if full else d.warp_len
        if kern == "fused_iter":
            return fused_spmv_dots_kernel_call(
                d.val, d.col_idx, d.block_start, d.inv_perm, wl, *args_,
                n_blocks=d.n_blocks, sigma=d.sigma, max_col=d.max_col)
        if kern == "pjds_spmm":
            return pjds_matmat_kernel_call(
                d.val, d.col_idx, d.block_start, wl, *args_,
                n_blocks=d.n_blocks, max_col=d.max_col, out_row=rows,
                n_out=m.n_rows)
        if kern == "pjds_spmv":
            return pjds_matvec_kernel_call(
                d.val, d.col_idx, d.block_start, wl, *args_,
                n_blocks=d.n_blocks, max_col=d.max_col)
        return sell_matvec_kernel_call(
            d.val, d.col_idx, d.block_start, d.inv_perm, wl, *args_,
            n_blocks=d.n_blocks, sigma=d.sigma, max_col=d.max_col)

    def agree(label, where, got, want):
        """y bit for bit; K3's dots within DOT_TOL relative."""
        if isinstance(want, tuple):
            (got, dots), (want, want_dots) = got, want
            rel = ((dots.double() - want_dots.double()).abs()
                   / want_dots.double().abs().clamp(min=1e-30))
            if float(rel.max()) > DOT_TOL:
                raise AssertionError(f"{label} on {where}: dots differ from "
                                     f"this tree's by {rel.tolist()}")
        if not torch.equal(got, want):
            err = float((got.double() - want.double()).abs().max())
            raise AssertionError(f"{label} on {where}: y differs from this "
                                 f"tree's (max |diff| {err})")

    for label, (kern, _, _, full) in variants.items():
        for where, d, args_ in operands[kern]:
            if full:
                build = lambda: tree(kern, d, args_, full=True)
            else:
                build = lambda: launch(label, kern, d, args_)
            this = lambda: tree(kern, d, args_)
            agree(label, where, build(), this())
            small = where == "poisson512"
            t = [time_ms(fn, graph=small)
                 for fn in (build, this, this, build)]
            b_ms = float(np.median([t[0][0], t[3][0]]))
            t_ms = float(np.median([t[1][0], t[2][0]]))
            print(json.dumps({
                "phase": f"ab:{label}", "kernel": kern, "operand": where,
                "n_rows": d.n_rows_pad, "build_ms": b_ms, "tree_ms": t_ms,
                "build_over_tree": b_ms / t_ms, "same_bits": True,
                "timing": "cuda graph" if small else "burst",
                "ptxas": regs.get(label, {}),
                "samples_build_tree_tree_build": t}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
