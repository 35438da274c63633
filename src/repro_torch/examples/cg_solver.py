"""Distributed solves over the distributed operator (paper §3 workload).

Partitions a Poisson system row-wise with ``dist_operator`` over eight
ranks -- the same protocol object a single device uses -- and runs
``repro_torch.solve`` CG with each of the paper's three communication
modes, then Jacobi-preconditioned CG, block CG (4 right-hand sides per
matrix stream) and BiCGStab on a non-symmetric perturbation (whose
transpose partition backs ``op.T``).

The reference runs eight host devices of one process.  Here the eight
ranks are threads of one process (``ThreadComm``), each on a stream of
the one card (or on the CPU with ``--device cpu``); under ``torchrun``
every process is one rank of the default process group (``GroupComm``:
NCCL on the cards, gloo with ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.examples.cg_solver [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        -m repro_torch.examples.cg_solver --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import repro_torch
from repro_torch.core import matrices as M
from repro_torch.core.dist_comm import GroupComm, ThreadComm, run_ranks
from repro_torch.core.operator import dist_operator
from repro_torch.kernels._backend import resolve_device


def _matvec(m, x: np.ndarray) -> np.ndarray:
    """Host CSR product in float64."""
    rows = np.repeat(np.arange(m.n_rows), np.diff(m.indptr))
    return np.bincount(rows, weights=m.data.astype(np.float64)
                       * x.astype(np.float64)[m.indices],
                       minlength=m.n_rows)


def _true_res(m, x: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(_matvec(m, x) - b) / np.linalg.norm(b))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank(comm, dev, m, mn, b, bk) -> dict:
    """One rank's run; rank 0 prints.  Every solve is collective."""
    say = print if comm.rank == 0 else (lambda *a, **k: None)
    n = m.n_rows
    op = dist_operator(m, comm, b_r=128, device=dev)
    dist = op.dist
    say(f"row partition: {dist.n_loc} rows/device, halo_w={dist.halo_w}, "
        f"halo traffic {dist.comm_bytes_per_device(4)/1e3:.1f} kB/dev/spMVM "
        f"gathered ({dist.comm_bytes_per_device(4, halo='full')/1e3:.1f} kB "
        f"full-slice)")
    bl = op.shard_vector(b)
    out = {"modes": {}}
    for mode in ("vector", "naive", "overlap"):
        # reuse the partition already built for `op`: only the
        # communication schedule changes
        op_m = dist_operator(op.dist, comm, mode=mode, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        res = repro_torch.solve(op_m, bl, method="cg", maxiter=4000,
                                tol=1e-6)
        _sync(dev)
        dt = time.perf_counter() - t0
        say(f"mode={mode:8s} iters={int(res.iters):4d} "
            f"rel_res={float(res.residual):.2e} wall={dt:.2f}s")
        out["modes"][mode] = {"iters": int(res.iters),
                              "rel_res": float(res.residual),
                              "status": res.status, "wall_s": dt}

    # Jacobi-preconditioned CG: M from op.diagonal()
    res_j = repro_torch.solve(op, bl, method="cg", precond="jacobi",
                              maxiter=4000, tol=1e-6)
    say(f"jacobi-pcg    iters={int(res_j.iters):4d} "
        f"rel_res={float(res_j.residual):.2e}")
    out["jacobi"] = {"iters": int(res_j.iters),
                     "rel_res": float(res_j.residual),
                     "status": res_j.status}

    # block CG: 4 right-hand sides through the operator's matmat at once
    k = bk.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    # 2e-6: "converged" is certified against the true residual, and the
    # worst of the 4 columns lands just above 1e-6 at f32's floor here
    bres = repro_torch.solve(op, op.shard_vector(bk), method="block_cg",
                             maxiter=4000, tol=2e-6)
    _sync(dev)
    dt = time.perf_counter() - t0
    worst = float(np.max(np.asarray(bres.residual)))
    say(f"block-CG  k={k}   iters={int(bres.iters):4d} "
        f"rel_res={worst:.2e} wall={dt:.2f}s")
    xb = op.gather_vector(bres.x).cpu().numpy()[:n]
    out["block_cg"] = {"k": k, "iters": int(bres.iters), "rel_res": worst,
                       "status": bres.status, "wall_s": dt,
                       "true_res": max(_true_res(m, xb[:, j], bk[:, j])
                                       for j in range(k))}

    # BiCGStab on a non-symmetric system: a convection-diffusion operator
    # (Poisson + upwind skew on the x-neighbours); the transpose
    # partition dist_operator builds also powers op_n.T
    op_n = dist_operator(mn, comm, b_r=128, device=dev)
    nres = repro_torch.solve(op_n, op_n.shard_vector(b), method="bicgstab",
                             maxiter=4000, tol=1e-6)
    x = op_n.gather_vector(nres.x).cpu().numpy()[:n]
    err = _true_res(mn, x, b)
    say(f"bicgstab (non-sym) iters={int(nres.iters):4d} true_res={err:.2e}")
    xt = op_n.gather_vector(op_n.T @ op_n.shard_vector(b)).cpu().numpy()[:n]
    rows = np.repeat(np.arange(n), np.diff(mn.indptr))
    want = np.bincount(mn.indices, weights=mn.data.astype(np.float64)
                       * b.astype(np.float64)[rows], minlength=n)
    t_err = float(np.abs(xt - want).max() / np.abs(want).max())
    say(f"op_n.T @ b vs host A^T b: rel max err = {t_err:.2e}")
    out["bicgstab"] = {"iters": int(nres.iters), "true_res": err,
                       "status": nres.status}
    out["transpose_rel_err"] = t_err

    # verify CG against the host product (1e-6 is what f32 storage and
    # f32 carriers certify on this system)
    res = repro_torch.solve(op, bl, method="cg", maxiter=4000, tol=1e-6)
    x = op.gather_vector(res.x).cpu().numpy()[:n]
    err = _true_res(m, x, b)
    say(f"true relative residual: {err:.2e}")
    out["cg_true_res"] = err
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ranks", type=int, default=8,
                    help="ThreadComm ranks when not under torchrun")
    ap.add_argument("--side", type=int, default=96)
    args = ap.parse_args(argv)

    m = M.poisson_2d(args.side, args.side)
    mn = M.convection_poisson(args.side, args.side, beta=0.5)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(m.n_rows).astype(np.float32)
    bk = rng.standard_normal((m.n_rows, 4)).astype(np.float32)

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from repro_torch.launch import mesh as LM
        dev = LM.join(args.device)
        comm = GroupComm()
        if comm.rank == 0:
            print(f"Poisson system: {m.shape}, nnz={m.nnz}, "
                  f"ranks={comm.size} (process group)")
        try:
            out = _rank(comm, dev, m, mn, b, bk)
        finally:
            LM.leave()
        out["ranks"] = comm.size
        return out
    dev = resolve_device(args.device)
    print(f"Poisson system: {m.shape}, nnz={m.nnz}, ranks={args.ranks} "
          f"(threads on {dev})")
    comms = ThreadComm.create(args.ranks, dev)
    outs = run_ranks(comms, lambda c: _rank(c, dev, m, mn, b, bk))
    out = outs[0]
    out["ranks"] = args.ranks
    out["ranks_agree"] = all(
        o["modes"][md]["iters"] == out["modes"][md]["iters"]
        for o in outs for md in out["modes"])
    return out


if __name__ == "__main__":
    main()
