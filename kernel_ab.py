#!/usr/bin/env python3
"""Time K1 (pJDS) and K4 (ELLPACK-R) against other builds of them, in one
process on one CUDA card, at the 3.4 M-row sAMG size (K4 also on the
512 x 512 Poisson operator, where the dispatch launches it).

    mkdir -p experiments/parent
    git archive 029ce31 | tar -x -C experiments/parent
    python3 kernel_ab.py experiments/parent

Each build first has to give this tree's y bit for bit (``torch.equal``)
on the same operands; it is then timed in turns with this tree's kernel
(build, this tree, this tree, build; CUDA events, median and quartiles
of 30 samples of 10 back-to-back launches each, so the host's launch
overhead stays hidden; on Poisson, where one launch's host overhead
outlasts the kernel, the 10 launches are one CUDA graph).  The builds:

* ``parent``: ``<parent>/src/repro_torch/kernels/csrc/{pjds,ellr,sell}
  _spmv.cu`` as the earlier tree had them, bound through the C interface
  they had there (commit 029ce31: K1 without ``warp_len``, walking every
  stored diagonal, one CTA per row block; K4 one thread per row looping
  to its own rowlen; K2 with its walk in its own source);
* design alternatives, each this tree's source with a line or two
  replaced: K1 with 256, 512 or 1024 threads per CTA instead of 128 (one
  CTA per row block at b_r 128); K4 with each lane looping to its own
  rowlen instead of the warp's longest row, with 1, 3 or 4 diagonals per
  step instead of 2 (4 also held to 32 registers, so that every thread
  slot of an SM fills), with 128 or 512 threads per CTA instead of 256,
  with its streams read through ``__ldg`` instead of ``__ldcs``, and
  with two rows per thread (i and i + 32) at 2 or 1 diagonals per step.

Sources and libraries go to ``build/kernel_ab/``.  Prints one JSON line
per build and operand, then ``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

K1_THREADS = "constexpr int kThreads = 128;"
K4_THREADS = "constexpr int kThreads = 256;"
K4_BOUNDS = "__launch_bounds__(kThreads)"
K4_ROWS = "constexpr int kRows = 1;"
K4_UNROLL = "constexpr int kUnroll = 2;"
K4_WARP_MAX = "most = __reduce_max_sync(0xffffffffu, most);"
K4_LOADS = ("v[k][u] = __ldcs(val + off);", "c[k][u] = __ldcs(col + off);")


def _variants(parent_csrc: pathlib.Path) -> dict:
    """label -> (kernel, source directory, {old text: new text})."""
    out = {f"parent:{k}": (k, parent_csrc, {})
           for k in ("pjds_spmv", "ellr_spmv", "sell_spmv")}
    for t in (256, 512, 1024):
        out[f"k1_threads_{t}"] = ("pjds_spmv", CSRC, {
            K1_THREADS: f"constexpr int kThreads = {t};"})
    k4 = {"k4_lane_bound": {K4_WARP_MAX: ""},
          "k4_streams_ldg": {t: t.replace("__ldcs", "__ldg")
                             for t in K4_LOADS},
          "k4_unroll_4_32_registers": {
              K4_UNROLL: "constexpr int kUnroll = 4;",
              K4_BOUNDS: "__launch_bounds__(kThreads, 2048 / kThreads)"},
          "k4_two_rows": {K4_ROWS: "constexpr int kRows = 2;"},
          "k4_two_rows_unroll_1": {K4_ROWS: "constexpr int kRows = 2;",
                                   K4_UNROLL: "constexpr int kUnroll = 1;"}}
    for u in (1, 3, 4):
        k4[f"k4_unroll_{u}"] = {K4_UNROLL: f"constexpr int kUnroll = {u};"}
    for t in (128, 512):
        k4[f"k4_threads_{t}"] = {K4_THREADS: f"constexpr int kThreads = {t};"}
    out.update({label: ("ellr_spmv", CSRC, subs)
                for label, subs in k4.items()})
    return out


# pointer arguments between (val, kind, col, kind) and the int tail
_N_PTRS = {("pjds_spmv", True): 3, ("pjds_spmv", False): 4,
           ("ellr_spmv", True): 3, ("ellr_spmv", False): 3,
           ("sell_spmv", True): 6, ("sell_spmv", False): 6}
_N_INTS = {"pjds_spmv": 2, "ellr_spmv": 1, "sell_spmv": 3}


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
    from repro_torch.kernels._backend import kind_codes, stream_of
    from repro_torch.kernels.ellr_spmv import ell_matvec_kernel_call
    from repro_torch.kernels.pjds_spmv import pjds_matvec_kernel_call
    from repro_torch.kernels.sell_spmv import (sell_matvec_kernel_call,
                                               window_blocks)

    # every build's source, one nvcc each, all at once
    variants = _variants(args.parent / "src" / "repro_torch" / "kernels" /
                         "csrc")
    procs = {}
    for label, (kern, src_dir, subs) in variants.items():
        d = ROOT / "build" / "kernel_ab" / label.replace(":", "_")
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(src_dir / "common.cuh", d / "common.cuh")
        text = (src_dir / f"{kern}.cu").read_text()
        for old, new in subs.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{label}: text to replace not found once")
            text = text.replace(old, new)
        (d / f"{kern}.cu").write_text(text)
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
        regs[label] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln]
        fn = getattr(ctypes.CDLL(str(d / "lib.so")), kern)
        old = label.startswith("parent:")
        fn.argtypes = ([p_, i_, p_, i_] + [p_] * _N_PTRS[kern, old]
                       + [i_] * _N_INTS[kern] + [p_])
        fn.restype = ctypes.c_int
        fns[label] = fn

    m = TM.samg(scale=args.scale)
    mp = TM.poisson_2d(512, 512)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(m.n_rows).astype(
        np.float32)).cuda()
    xp = torch.from_numpy(rng.standard_normal(mp.n_rows).astype(
        np.float32)).cuda()
    op_pe = repro_torch.operator(mp)
    if op_pe.fmt != "ellpack_r":
        raise AssertionError(f"auto picked {op_pe.fmt} on Poisson 512^2")
    operands = {
        "pjds_spmv": [("samg", repro_torch.operator(m, format="pjds")
                       .dev.dev, x)],
        "ellr_spmv": [("samg", repro_torch.operator(m, format="ellpack_r")
                       .dev.dev, x), ("poisson512", op_pe.dev.dev, xp)],
        "sell_spmv": [("samg", repro_torch.operator(m, format="sell")
                       .dev.dev, x)]}

    def launch(label, kern, d, v):
        old = label.startswith("parent:")
        y = torch.empty(d.n_rows_pad, device=v.device)
        if kern == "pjds_spmv":
            ptrs = [d.block_start] + ([] if old else [d.warp_len])
            tail = [d.n_blocks, d.b_r]
        elif kern == "ellr_spmv":
            ptrs, tail = [d.rowlen], [d.n_rows_pad]
        else:
            ptrs = [d.block_start, d.warp_len, d.inv_perm]
            tail = [d.n_blocks, d.b_r,
                    window_blocks(d.sigma, d.b_r, d.n_blocks)]
        ptrs = [t.data_ptr() for t in ptrs] + [v.data_ptr(), y.data_ptr()]
        if kern == "sell_spmv":
            ptrs.append(None)                  # slab path: no scratch
        vk, ik = kind_codes(d.val, d.col_idx)
        rc = fns[label](d.val.data_ptr(), vk, d.col_idx.data_ptr(), ik,
                        *ptrs, *tail, stream_of(v))
        if rc:
            raise RuntimeError(f"{label}: CUDA error {rc}")
        return y

    def tree(kern, d, v):
        if kern == "pjds_spmv":
            return pjds_matvec_kernel_call(
                d.val, d.col_idx, d.block_start, d.warp_len, v,
                n_blocks=d.n_blocks, max_col=d.max_col)
        if kern == "ellr_spmv":
            return ell_matvec_kernel_call(d.val, d.col_idx, d.rowlen, v,
                                          max_col=d.max_col)
        return sell_matvec_kernel_call(
            d.val, d.col_idx, d.block_start, d.inv_perm, d.warp_len, v,
            n_blocks=d.n_blocks, sigma=d.sigma, max_col=d.max_col)

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

    for label, (kern, _, _) in variants.items():
        for where, d, v in operands[kern]:
            y_b, y_t = launch(label, kern, d, v), tree(kern, d, v)
            if not torch.equal(y_b, y_t):
                err = float((y_b.double() - y_t.double()).abs().max())
                raise AssertionError(f"{label} on {where}: y differs from "
                                     f"this tree's {kern} (max |diff| {err})")
            small = where == "poisson512"
            t = [time_ms(fn, graph=small) for fn in (
                lambda: launch(label, kern, d, v), lambda: tree(kern, d, v),
                lambda: tree(kern, d, v), lambda: launch(label, kern, d, v))]
            b_ms = float(np.median([t[0][0], t[3][0]]))
            t_ms = float(np.median([t[1][0], t[2][0]]))
            print(json.dumps({
                "phase": f"ab:{label}", "kernel": kern, "operand": where,
                "n_rows": d.n_rows_pad, "build_ms": b_ms, "tree_ms": t_ms,
                "build_over_tree": b_ms / t_ms, "same_bits": True,
                "timing": "cuda graph" if small else "burst",
                "ptxas": regs[label],
                "samples_build_tree_tree_build": t}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
