#!/usr/bin/env python3
"""Drive the repro_torch port's main path on one CUDA card, at full size.

Builds the three hand-written kernels (K1 pJDS spMV, K2 SELL-C-sigma
spMV, K3 fused spMV + dots) from ``src/repro_torch/kernels/csrc``, runs
the paper's pipeline on the sAMG analogue at its published 3.4 M rows
-- ``operator(m, format=...) @ x`` and ``repro_torch.solve`` -- and holds
every kernel against its plain PyTorch version and every product
against a float64 scipy reference.  Each phase prints one JSON line;
any failed check raises, and the script then exits non-zero without its
final line.

    python3 chip_smoke.py

Needs one CUDA card of compute capability >= 9.0, ``nvcc`` and scipy.
It exits non-zero at once when CUDA is absent, and when run from a
directory that does not hold the repository's ``src/repro_torch``.
The last line is ``{"ok": true, "device": {...}}``; the line before it
is ``nvidia-smi``'s name and power limit, and the one before that the
per-kernel record (launches, errors, times and bounds).
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
Y_TOL = 1e-5                     # max |kernel - plain| <= Y_TOL * max|y|
DOT_TOL = 1e-4                   # relative, per dot
SCIPY_TOL = 1e-5                 # max |kernel - f64| <= SCIPY_TOL * max|y|


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no repro_torch package under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    import numpy as np
    import scipy.sparse as sp

    import repro_torch
    from repro_torch.core import matrices as TM
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.fused_iter import (fused_matvec_dots,
                                                fused_spmv_dots_kernel_call)
    from repro_torch.kernels.pjds_spmv import pjds_matvec_kernel_call
    from repro_torch.kernels.sell_spmv import (sell_matvec_kernel_call,
                                               slab_fits, window_blocks)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = {"pjds_spmv": pjds_matvec_kernel_call,
               "sell_spmv": sell_matvec_kernel_call,
               "fused_iter": fused_spmv_dots_kernel_call}
    plains = (R.pjds_matvec_ref, R.sell_matvec_ref, R.fused_matvec_dots_ref,
              R.csr_matvec_ref)

    def reset_counts():
        for k in kernels.values():
            k.launches = 0
        R.reset_calls()

    def counts():
        torch.cuda.synchronize()
        return ({n: k.launches for n, k in kernels.items()},
                {f.__name__: f.calls for f in plains})

    def rel_err(y, y_ref):
        y, y_ref = y.double().cpu(), y_ref.double().cpu()
        scale = max(float(y_ref.abs().max()), 1e-30)
        err = float((y - y_ref).abs().max())
        return err, err / scale

    def time_ms(fn, reps=30, warm=5):
        """(median, 25th, 75th percentile) ms of ``fn`` by CUDA events,
        one launch per sample, after ``warm`` launches."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return tuple(float(v) for v in np.percentile(out, [50, 25, 75]))

    # ---- 1. kernel build ------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in _build.SOURCES}
    emit("build", seconds=time.perf_counter() - t0, compiled=built,
         dir=str(_build.build_dir().relative_to(ROOT)), ptxas=ptxas)

    # ---- 2. setup: the card and the sAMG matrix at full size ------------
    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    m = TM.samg(scale=1.0)
    t_gen = time.perf_counter() - t0
    n = m.n_rows
    a64 = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    t0 = time.perf_counter()
    op_p = repro_torch.operator(m, format="pjds")
    t_pjds = time.perf_counter() - t0
    t0 = time.perf_counter()
    op_s = repro_torch.operator(m, format="sell")
    t_sell = time.perf_counter() - t0
    d_p, d_s = op_p.dev.dev, op_s.dev.dev
    emit("setup", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         n_rows=n, nnz=m.nnz, max_row=int(m.row_lengths().max()),
         stored_elements=int(d_s.val.numel()),
         stored_over_nnz=d_s.val.numel() / m.nnz,
         generate_s=t_gen, pjds_build_s=t_pjds, sell_build_s=t_sell,
         index_dtype=str(d_s.col_idx.dtype))

    rng = np.random.default_rng(SEED)
    x_np = rng.standard_normal(n).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    y64 = a64 @ x_np.astype(np.float64)
    y64_t = torch.from_numpy(y64)
    errs, main_launches = {}, {}

    # ---- 3. K1 and K2 at full size, through the operator ----------------
    for name, op in (("pjds_spmv", op_p), ("sell_spmv", op_s)):
        reset_counts()
        y = op @ x
        launched, plain_calls = counts()
        require(launched[name] >= 1, f"{name} was not launched")
        require(not any(plain_calls.values()),
                f"plain version ran on the main path: {plain_calls}")
        d = op.dev.dev
        if name == "pjds_spmv":
            y_k = pjds_matvec_kernel_call(d.val, d.col_idx, d.block_start,
                                          x, n_blocks=d.n_blocks,
                                          max_col=d.max_col)
            y_r = R.pjds_matvec_ref(d.val, d.col_idx, d.row_block, x,
                                    d.n_blocks)
        else:
            y_k = sell_matvec_kernel_call(d.val, d.col_idx, d.block_start,
                                          d.inv_perm, x, n_blocks=d.n_blocks,
                                          sigma=d.sigma, max_col=d.max_col)
            y_r = R.sell_matvec_ref(d.val, d.col_idx, d.row_block,
                                    d.inv_perm, x, d.n_blocks)
        e_abs, e_rel = rel_err(y_k, y_r)
        s_abs, s_rel = rel_err(y, y64_t)
        require(e_rel <= Y_TOL, f"{name} vs plain: {e_rel}")
        require(s_rel <= SCIPY_TOL, f"{name} vs scipy f64: {s_rel}")
        require(tuple(y.shape) == (n,) and bool(torch.isfinite(y).all()),
                f"{name}: bad output")
        errs[name] = (e_abs, e_rel)
        main_launches[name] = launched[name]
        emit(f"matvec:{name}", launches=launched[name],
             max_abs_err_vs_plain=e_abs, max_rel_err_vs_plain=e_rel,
             max_abs_err_vs_scipy_f64=s_abs, max_rel_err_vs_scipy_f64=s_rel)

    # ---- 4. K3 against its plain version --------------------------------
    n_pad = d_s.n_rows_pad
    w1 = torch.zeros(n_pad, device=dev)
    w2 = torch.zeros(n_pad, device=dev)
    w1[:n] = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    w2[:n] = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    xp = torch.zeros(n_pad, device=dev)
    xp[:n] = x
    y_k, dots_k = fused_matvec_dots(d_s, xp, w1, w2)
    y_r, dots_r = R.fused_matvec_dots_ref(d_s.val, d_s.col_idx, d_s.row_block,
                                          d_s.inv_perm, xp, w1, w2,
                                          d_s.n_blocks)
    e_abs, e_rel = rel_err(y_k, y_r)
    dk, dr = dots_k.double().cpu(), dots_r.double().cpu()
    dot_rel = ((dk - dr).abs() / dr.abs().clamp(min=1e-30)).tolist()
    require(e_rel <= Y_TOL, f"fused_iter y vs plain: {e_rel}")
    require(max(dot_rel) <= DOT_TOL, f"fused_iter dots vs plain: {dot_rel}")
    errs["fused_iter"] = (e_abs, e_rel)
    emit("fused:fused_iter", max_abs_err_vs_plain=e_abs,
         max_rel_err_vs_plain=e_rel, dots=dk.tolist(),
         dots_rel_err_vs_plain=dot_rel)

    # ---- 5. fused-CG solve on sAMG --------------------------------------
    b_np = rng.standard_normal(n).astype(np.float32)
    reset_counts()
    t0 = time.perf_counter()
    res = repro_torch.solve(m, b_np, tune="off", fallback="off")
    launched, plain_calls = counts()
    t_solve = time.perf_counter() - t0
    r64 = b_np - a64 @ res.x.double().cpu().numpy()
    sci_res = float(np.linalg.norm(r64) / np.linalg.norm(b_np))
    emit("solve:samg:fused", status=res.status,
         strategy=res.info["strategy"], iters=res.iters,
         true_residual=res.diagnostics["true_residual"],
         scipy_f64_residual=sci_res, host_syncs=res.info["host_syncs"],
         launches=launched, plain_calls=plain_calls, seconds=t_solve)
    require(res.status == "converged", f"fused solve: {res.status}")
    require(res.info["strategy"] == "fused", "strategy is not fused")
    require(res.diagnostics["true_residual"] <= 1e-6, "certified residual")
    require(sci_res <= 1e-5, f"scipy residual {sci_res}")
    require(launched["fused_iter"] >= res.iters + 1, "K3 launches")
    require(not any(plain_calls.values()), f"plain calls {plain_calls}")
    main_launches["fused_iter"] = launched["fused_iter"]

    # ---- 6. long fused loop: 2-D Poisson 512 x 512 ----------------------
    mp = TM.poisson_2d(512, 512)
    bp = np.random.default_rng(SEED).standard_normal(mp.n_rows).astype(
        np.float32)
    reset_counts()
    t0 = time.perf_counter()
    resp = repro_torch.solve(mp, bp, tol=1e-5, maxiter=5000, tune="off",
                             fallback="off")
    launched, plain_calls = counts()
    t_p = time.perf_counter() - t0
    ms_iter = 1e3 * resp.info["phase_s"]["solve"] / max(resp.iters, 1)
    dp = repro_torch.operator(mp, format="sell").dev.dev
    vp = [torch.ones(dp.n_rows_pad, device=dev) for _ in range(3)]
    k3_ms = time_ms(lambda: fused_spmv_dots_kernel_call(
        dp.val, dp.col_idx, dp.block_start, dp.inv_perm, *vp,
        n_blocks=dp.n_blocks, sigma=dp.sigma, max_col=dp.max_col))[0]
    emit("solve:poisson512:fused", status=resp.status, iters=resp.iters,
         true_residual=resp.diagnostics["true_residual"],
         restarts=resp.diagnostics["restarts"],
         host_syncs=resp.info["host_syncs"], launches=launched,
         plain_calls=plain_calls, seconds=t_p, ms_per_iter=ms_iter,
         k3_ms_at_this_size=k3_ms, k3_share_of_iteration=k3_ms / ms_iter)
    require(resp.status == "converged", f"poisson solve: {resp.status}")
    require(not any(plain_calls.values()), f"plain calls {plain_calls}")

    # ---- 7. composed CG over K1 -----------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    resc = repro_torch.solve(m, b_np, format="pjds", tune="off",
                             fallback="off")
    launched, plain_calls = counts()
    r64 = b_np - a64 @ resc.x.double().cpu().numpy()
    sci_c = float(np.linalg.norm(r64) / np.linalg.norm(b_np))
    emit("solve:samg:composed", status=resc.status,
         strategy=resc.info["strategy"], iters=resc.iters,
         true_residual=resc.diagnostics["true_residual"],
         scipy_f64_residual=sci_c, host_syncs=resc.info["host_syncs"],
         launches=launched, plain_calls=plain_calls,
         seconds=time.perf_counter() - t0)
    require(resc.status == "converged", f"composed solve: {resc.status}")
    require(sci_c <= 1e-5, f"composed scipy residual {sci_c}")
    require(launched["pjds_spmv"] >= resc.iters + 1, "K1 launches")
    require(not any(plain_calls.values()), f"plain calls {plain_calls}")

    # ---- 8. small builds: bf16 + int16, and the device-memory path ------
    ms = TM.samg(scale=0.009)
    xs = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        ms.n_rows).astype(np.float32)).to(dev)
    cases = [("bf16+int16", dict(dtype=torch.bfloat16, index_dtype="int16")),
             ("f32+int16", dict(index_dtype="int16")),
             ("f32+int32 sigma>n", dict(index_dtype="int32", sigma=1 << 16)),
             ("bf16+int16 sigma>n", dict(dtype=torch.bfloat16,
                                         index_dtype="int16",
                                         sigma=1 << 16))]
    for label, kw in cases:
        sigma = kw.pop("sigma", None)
        opp = repro_torch.operator(ms, format="pjds", **kw)
        ops_ = repro_torch.operator(ms, format="sell", sigma=sigma, **kw)
        p, s = opp.dev.dev, ops_.dev.dev
        e1 = rel_err(pjds_matvec_kernel_call(
            p.val, p.col_idx, p.block_start, xs, n_blocks=p.n_blocks,
            max_col=p.max_col),
            R.pjds_matvec_ref(p.val, p.col_idx, p.row_block, xs,
                              p.n_blocks))[1]
        e2 = rel_err(sell_matvec_kernel_call(
            s.val, s.col_idx, s.block_start, s.inv_perm, xs,
            n_blocks=s.n_blocks, sigma=s.sigma, max_col=s.max_col),
            R.sell_matvec_ref(s.val, s.col_idx, s.row_block, s.inv_perm, xs,
                              s.n_blocks))[1]
        npd = s.n_rows_pad
        v = [torch.zeros(npd, device=dev) for _ in range(3)]
        for t in v:
            t[: ms.n_rows] = xs
        v[1].mul_(0.5)
        v[2].neg_()
        yk, dk = fused_spmv_dots_kernel_call(
            s.val, s.col_idx, s.block_start, s.inv_perm, v[0], v[1], v[2],
            n_blocks=s.n_blocks, sigma=s.sigma, max_col=s.max_col)
        yr, dr = R.fused_matvec_dots_ref(s.val, s.col_idx, s.row_block,
                                         s.inv_perm, v[0], v[1], v[2],
                                         s.n_blocks)
        e3 = rel_err(yk, yr)[1]
        d3 = float(((dk.double() - dr.double()).abs()
                    / dr.double().abs().clamp(min=1e-30)).max())
        slab = slab_fits(window_blocks(s.sigma, s.b_r, s.n_blocks), s.b_r)
        emit(f"small:{label}", n_rows=ms.n_rows, value_dtype=str(s.val.dtype),
             index_dtype=str(s.col_idx.dtype), sigma=s.sigma,
             sell_path="shared-memory slab" if slab else "device memory",
             pjds_rel_err=e1, sell_rel_err=e2, fused_y_rel_err=e3,
             fused_dots_rel_err=d3)
        require(max(e1, e2, e3) <= Y_TOL and d3 <= DOT_TOL,
                f"small build {label} disagrees with the plain version")
        require(str(s.col_idx.dtype) == ("torch." + kw["index_dtype"]),
                "index dtype not kept")
        require(slab == (sigma is None), "wrong unpermute path exercised")

    # ---- 9. timings at full size (CUDA events, median of 30) -------------
    vb = d_s.val.element_size()
    ib = d_s.col_idx.element_size()
    stored = d_s.val.numel()
    n_blocks = d_s.n_blocks
    w_b = window_blocks(d_s.sigma, d_s.b_r, n_blocks)
    n_part = -(-n_blocks // w_b)
    base = stored * (vb + ib) + n * 4 + n_pad * 4 + (n_blocks + 1) * 4
    bytes_ = {"pjds_spmv": float(d_p.val.numel() * (vb + ib) + n * 4
                                 + n_pad * 4 + (n_blocks + 1) * 4),
              "sell_spmv": float(base + n_pad * 4),
              "fused_iter": float(base + n_pad * 4 + 2 * n_pad * 4
                                  + 2 * n_part * 5 * 4 + 5 * 4)}
    flops = {"pjds_spmv": 2.0 * d_p.val.numel(),
             "sell_spmv": 2.0 * stored,
             "fused_iter": 2.0 * stored + 2.0 * 5 * n_pad}
    a_csr = torch.sparse_csr_tensor(
        torch.from_numpy(m.indptr.astype(np.int64)),
        torch.from_numpy(m.indices.astype(np.int64)),
        torch.from_numpy(m.data.astype(np.float32)), size=m.shape).to(dev)
    try:      # a yardstick only: the port never calls cuSPARSE
        lib_ms = time_ms(lambda: torch.mv(a_csr, x))[0]
    except RuntimeError as e:
        emit("library", error=f"{type(e).__name__}: {e}")
        lib_ms = None
    runs = {
        "pjds_spmv": (
            lambda: pjds_matvec_kernel_call(d_p.val, d_p.col_idx,
                                            d_p.block_start, x,
                                            n_blocks=d_p.n_blocks,
                                            max_col=d_p.max_col),
            lambda: R.pjds_matvec_ref(d_p.val, d_p.col_idx, d_p.row_block,
                                      x, d_p.n_blocks)),
        "sell_spmv": (
            lambda: sell_matvec_kernel_call(d_s.val, d_s.col_idx,
                                            d_s.block_start, d_s.inv_perm, x,
                                            n_blocks=n_blocks,
                                            sigma=d_s.sigma,
                                            max_col=d_s.max_col),
            lambda: R.sell_matvec_ref(d_s.val, d_s.col_idx, d_s.row_block,
                                      d_s.inv_perm, x, n_blocks)),
        "fused_iter": (
            lambda: fused_spmv_dots_kernel_call(
                d_s.val, d_s.col_idx, d_s.block_start, d_s.inv_perm, xp, w1,
                w2, n_blocks=n_blocks, sigma=d_s.sigma, max_col=d_s.max_col),
            lambda: R.fused_matvec_dots_ref(d_s.val, d_s.col_idx,
                                            d_s.row_block, d_s.inv_perm, xp,
                                            w1, w2, n_blocks)),
    }
    sources = {"pjds_spmv": ("src/repro/kernels/pjds_spmv.py:150",
                             "pjds_matvec_kernel_call"),
               "sell_spmv": ("src/repro/kernels/sell_spmv.py:180",
                             "sell_matvec_kernel_call"),
               "fused_iter": ("src/repro/kernels/fused_iter.py:199",
                              "fused_spmv_dots_kernel_call")}
    record = []
    for name, (kern, plain) in runs.items():
        k_ms, k_q25, k_q75 = time_ms(kern)
        p_ms = time_ms(plain, reps=20, warm=2)[0]
        bound_ms = 1e3 * max(bytes_[name] / HBM_BYTES_PER_S,
                             flops[name] / F32_FLOPS)
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": sources[name][0],
               "launches": main_launches[name],
               "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
               "ms": k_ms, "ms_q25_q75": [k_q25, k_q75], "samples": 30,
               "plain_ms": p_ms, "bound_ms": bound_ms,
               "bound_by": "bytes"
               if bytes_[name] / HBM_BYTES_PER_S >= flops[name] / F32_FLOPS
               else "operations",
               "library_ms": lib_ms, "bytes": bytes_[name],
               "gbps": bytes_[name] / (k_ms * 1e-3) / 1e9}
        record.append(rec)
        emit(f"time:{name}", **rec)
    emit("memory", max_allocated_gib=torch.cuda.max_memory_allocated()
         / 2 ** 30)

    # ---- 10. the record, the card, the verdict ---------------------------
    print(json.dumps({"kernels": record}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
