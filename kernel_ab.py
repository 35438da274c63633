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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=pathlib.Path,
                    help="root of the earlier tree (holds src/repro_torch)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="sAMG scale (1.0: the paper's 3.4 M rows)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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

    def time_ms(fn, reps=30, warm=5, burst=10, graph=False):
        """Median and quartiles of ms per call; each sample times
        ``burst`` calls back to back (host overhead hidden), or with
        ``graph`` one replay of a CUDA graph that holds them (for kernels
        shorter than the host's launch overhead)."""
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
