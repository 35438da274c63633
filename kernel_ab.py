#!/usr/bin/env python3
"""Time K6 (CMRS) and K2 (SELL-C-sigma) against other builds of them, in
one process on one CUDA card, at the 3.4 M-row sAMG size.

    mkdir -p experiments/parent
    git archive 2855192 | tar -x -C experiments/parent
    python3 kernel_ab.py experiments/parent

Each build is timed in turns with this tree's kernel on the same
operands (build, this tree, this tree, build; CUDA events, median and
quartiles of 30 samples of 10 back-to-back launches each, so the host's
launch overhead stays hidden) after a check that the two agree within
1e-5 * max|y|.  The builds:

* ``parent``: ``<parent>/src/repro_torch/kernels/csrc/{cmrs,sell}_spmv.cu``
  as an earlier tree had them, bound through the C interface they had
  before they took walk lengths (commit 2855192: K6 without
  ``strip_nnz``, K2 without ``warp_len``);
* design alternatives, each this tree's source with one line replaced:
  K2 walking per-row lengths (one entry per row, derived by the same
  rule as ``ops.sell_warp_len``) instead of per-warp ones; K2 with 256,
  512 or 1024 threads per window CTA instead of 128 (1024: one thread
  per row of the window at sigma 1024); K6 with 2, 8 or 16 strips per
  CTA instead of 4, and K6 held to 32 registers so that 16 CTAs (every
  thread slot) fit an SM.

Sources and libraries go to ``build/kernel_ab/``.  Prints one JSON line
per build, then ``nvidia-smi``'s name and power limit.
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
Y_TOL = 1e-5

K2_LEN = ("const int n = min(max(warp_len[b * (b_r >> 5) + (r >> 5)], 0), "
          "stored);")
K2_THREADS = "constexpr int kWindowThreads = 128;"
K6_BOUNDS = "__global__ void __launch_bounds__(kWarps * 32)"
K6_WARPS = "constexpr int kWarps = 4;       // strips per CTA"


def _variants(parent_csrc: pathlib.Path) -> dict:
    """label -> (kernel, source directory, {old line: new line})."""
    out = {"parent:cmrs_spmv": ("cmrs_spmv", parent_csrc, {}),
           "parent:sell_spmv": ("sell_spmv", parent_csrc, {}),
           "k2_per_row_lengths": ("sell_spmv", CSRC, {
               K2_LEN: K2_LEN.replace("b * (b_r >> 5) + (r >> 5)",
                                      "b * b_r + r")})}
    for t in (256, 512, 1024):
        out[f"k2_threads_{t}"] = ("sell_spmv", CSRC, {
            K2_THREADS: f"constexpr int kWindowThreads = {t};"})
    for w in (2, 8, 16):
        out[f"k6_strips_per_cta_{w}"] = ("cmrs_spmv", CSRC, {
            K6_WARPS: f"constexpr int kWarps = {w};"})
    out["k6_32_registers"] = ("cmrs_spmv", CSRC, {
        K6_BOUNDS: K6_BOUNDS.replace("kWarps * 32", "kWarps * 32, 16")})
    return out


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
    from repro_torch.kernels.cmrs_spmv import cmrs_matvec_kernel_call
    from repro_torch.kernels.sell_spmv import (sell_matvec_kernel_call,
                                               window_blocks)

    # every build's source, one nvcc each, all at once
    variants = _variants(args.parent / "src" / "repro_torch" / "kernels" /
                         "csrc")
    procs = {}
    for label, (kern, src_dir, subs) in variants.items():
        d = ROOT / "build" / "kernel_ab" / label
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(src_dir / "common.cuh", d / "common.cuh")
        text = (src_dir / f"{kern}.cu").read_text()
        for old, new in subs.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{label}: line to replace not found once")
            text = text.replace(old, new)
        (d / f"{kern}.cu").write_text(text)
        procs[label] = (kern, d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / f"{kern}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    _build.build_all()
    fns = {}
    for label, (kern, d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{label} failed to build:\n{log}")
        fns[label] = getattr(ctypes.CDLL(str(d / "lib.so")), kern)
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    for label, fn in fns.items():
        old = label.startswith("parent:")
        if label.endswith("cmrs_spmv") or label.startswith("k6"):
            fn.argtypes = [p_, i_, p_, i_] + [p_] * (4 if old else 5) + [
                i_, i_, p_]
        else:
            fn.argtypes = [p_, i_, p_, i_] + [p_] * (5 if old else 6) + [
                i_, i_, i_, p_]
        fn.restype = ctypes.c_int

    m = TM.samg(scale=args.scale)
    c = repro_torch.operator(m, format="cmrs").dev.dev
    s = repro_torch.operator(m, format="sell").dev.dev
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        m.n_rows).astype(np.float32)).cuda()
    w_b = window_blocks(s.sigma, s.b_r, s.n_blocks)
    # per-row lengths: each lane's last non-padding diagonal (1-based)
    real = (s.val != 0) | (s.col_idx != 0)
    total = real.shape[0]
    rb = s.row_block.long()
    j = (torch.arange(1, total + 1, dtype=torch.int32, device=x.device)
         - s.block_start[rb])
    row_len = torch.zeros((s.n_blocks, s.b_r), dtype=torch.int32,
                          device=x.device)
    row_len.scatter_reduce_(0, rb[:, None].expand(total, s.b_r),
                            j[:, None] * real, "amax")
    row_len = row_len.reshape(-1)

    def launch(label):
        fn = fns[label]
        if label.endswith("cmrs_spmv") or label.startswith("k6"):
            d, ptrs = c, [c.row_in_strip.data_ptr(), c.strip_start.data_ptr()]
            if not label.startswith("parent"):
                ptrs.append(c.strip_nnz.data_ptr())
            tail = [c.n_strips, c.b_r]
        else:
            d, ptrs = s, [s.block_start.data_ptr()]
            if not label.startswith("parent"):
                ptrs.append((row_len if label == "k2_per_row_lengths"
                             else s.warp_len).data_ptr())
            ptrs.append(s.inv_perm.data_ptr())
            tail = [s.n_blocks, s.b_r, w_b]
        y = torch.empty(d.n_rows_pad, device=x.device)
        vk, ik = kind_codes(d.val, d.col_idx)
        ptrs += [x.data_ptr(), y.data_ptr()]
        if d is s:
            ptrs.append(None)                  # slab path: no scratch
        rc = fn(d.val.data_ptr(), vk, d.col_idx.data_ptr(), ik, *ptrs, *tail,
                stream_of(x))
        if rc:
            raise RuntimeError(f"{label}: CUDA error {rc}")
        return y

    def tree(kern):
        if kern == "cmrs_spmv":
            return cmrs_matvec_kernel_call(
                c.val, c.col_idx, c.row_in_strip, c.strip_start, c.strip_nnz,
                x, n_strips=c.n_strips, max_col=c.max_col)
        return sell_matvec_kernel_call(
            s.val, s.col_idx, s.block_start, s.inv_perm, s.warp_len, x,
            n_blocks=s.n_blocks, sigma=s.sigma, max_col=s.max_col)

    def time_ms(fn, reps=30, warm=5, burst=10):
        """Median and quartiles of ms per call; each sample times
        ``burst`` calls back to back (host overhead hidden)."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(burst):
                fn()
            e1.record()
            e1.synchronize()
            t.append(e0.elapsed_time(e1) / burst)
        return [float(v) for v in np.percentile(t, [50, 25, 75])]

    for label, (kern, _, _) in variants.items():
        y_b, y_t = launch(label).double(), tree(kern).double()
        err = float((y_b - y_t).abs().max()
                    / y_t.abs().max().clamp(min=1e-30))
        if not err <= Y_TOL:
            raise AssertionError(f"{label}: differs from this tree's "
                                 f"{kern} by {err} * max|y|")
        t = [time_ms(fn) for fn in (lambda: launch(label), lambda: tree(kern),
                                    lambda: tree(kern), lambda: launch(label))]
        b_ms = float(np.median([t[0][0], t[3][0]]))
        t_ms = float(np.median([t[1][0], t[2][0]]))
        print(json.dumps({
            "phase": f"ab:{label}", "kernel": kern, "n_rows": m.n_rows,
            "nnz": m.nnz, "build_ms": b_ms, "tree_ms": t_ms,
            "build_over_tree": b_ms / t_ms, "max_rel_err_vs_tree": err,
            "samples_build_tree_tree_build": t}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
