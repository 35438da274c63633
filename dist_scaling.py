#!/usr/bin/env python3
"""Time the distributed layer across cards: four ranks, one process and
one card each, on an NCCL process group (paper §3's multi-GPU spMVM).

    python3 dist_scaling.py                        # 4 ranks, 4 cards
    python3 dist_scaling.py --backend gloo --scale 0.01   # 4 CPU processes

Each rank partitions the sAMG analogue (``samg(scale)``, 3.4 M rows at
1.0) with ``dist_spmv.partition_csr`` (1-D over the four ranks, then
the 2 x 2 grid), builds its ``DistOperator`` on its own card and, for
every mode x halo flavour of each, checks the gathered y against scipy
in float64 (within 1e-5 * max|y|) and times ``op @ x``
(``tune.measure.median_seconds``: CUDA events around bursts of 10
calls, median of 30 samples, after a barrier; every rank times its own
calls, and a product waits for its messages, so the slowest rank sets
the pace).  It also times, alone on each rank, the local K1 and the halo
exchange (messages only, gathered and full), runs CG through
``repro_torch.solve`` (every rank the same status and iterations), and
times the same product on rank 0's card alone (a one-rank group, the
P = 1 baseline) in the same run, so the speedup compares one call's
cards.  What one 1-entry message and one 1-entry ``all_reduce`` cost,
and the host's time to launch a product and an exchange (calls back to
back, no synchronisation), say whether the link or the host sets the
pace, and a ``torch.profiler`` trace of 20 products (rank 0's printed)
says where: host time per operation, device time per kernel, and the
shares of the traced wall time the compute kernels and the NCCL
kernels held the card.  On the CPU (``--backend gloo``) the same runs
check the message logic; its times are host-clock and name no device.

Rank processes are started with ``torch.multiprocessing`` (spawn) and
meet through a ``FileStore`` in a temporary directory; the script waits
for them at most ``--timeout`` seconds and ends any still running.
Prints one JSON line per result, ``nvidia-smi``'s name and power limit,
and last ``{"ok": true, ...}``; exits non-zero if a check fails, a rank
fails, or fewer than four cards are present for NCCL.

This is the port's only multi-card measurement; a benchmark of the
port takes it over (ROADMAP 1.17).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
TOL = 1e-5                      # max|y - y64| <= TOL * max|y64|
RANKS = 4


def worker(rank: int, a: dict, store_path: str, out_dir: str) -> None:
    """One rank: partition, check and time every mode x halo, the
    pieces alone, CG, and (rank 0) the one-rank baseline."""
    sys.path.insert(0, str(SRC))
    import copy

    import numpy as np
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    import repro_torch
    from repro_torch.core import dist_spmv as D
    from repro_torch.core import matrices as TM
    from repro_torch.core import perf_model as PM
    from repro_torch.core.dist_comm import GroupComm
    from repro_torch.core.operator import DistOperator
    from repro_torch.kernels import ops
    from repro_torch.tune.measure import median_seconds

    p_ranks = RANKS
    cuda = a["backend"] == "nccl"
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group(
        a["backend"], store=dist.FileStore(store_path, p_ranks), rank=rank,
        world_size=p_ranks, timeout=datetime.timedelta(seconds=a["timeout"]))
    out = {"rank": rank, "device": (torch.cuda.get_device_name(dev)
                                    if cuda else "cpu")}
    try:
        comm = GroupComm()

        def time_ms(fn):
            return 1e3 * median_seconds(fn, warmup=5, iters=30, device=dev)

        def barrier():
            comm.all_reduce_sum(torch.zeros(1, device=dev))

        t0 = time.perf_counter()
        m = TM.samg(scale=a["scale"])
        rng = np.random.default_rng(SEED)
        x = rng.standard_normal(m.n_rows).astype(np.float32)
        b = rng.standard_normal(m.n_rows).astype(np.float32)
        out["generate_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = D.partition_csr(m, p_ranks)
        out["partition_s"] = time.perf_counter() - t0
        op = DistOperator(plan, comm, device=dev)
        xl = op.shard_vector(x)
        y64 = None
        if rank == 0:
            a64 = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
            y64 = a64 @ x.astype(np.float64)
        out.update(n_rows=m.n_rows, nnz=m.nnz, halo_w=plan.halo_w,
                   halo_lens=list(plan.halo_lens),
                   local_nnz=int((op.shard.loc.val != 0).sum()),
                   remote_nnz=int((op.shard.rem.val != 0).sum()))
        fails = []

        def run_modes(op, plan, label):
            """Check and time every mode x halo flavour of ``op``."""
            xl = op.shard_vector(x)
            modes = {}
            for mode in D.MODES:
                for halo in D.HALOS:
                    o = copy.copy(op)
                    o.mode, o.halo = mode, halo
                    y = o @ xl
                    yg = o.gather_vector(y).cpu().double().numpy()[
                        :m.n_rows]
                    rec = {}
                    if rank == 0:
                        err = float(np.abs(yg - y64).max()
                                    / np.abs(y64).max())
                        rec["max_rel_err_vs_scipy_f64"] = err
                        if not err <= TOL:
                            fails.append(f"{label} {mode}:{halo} err {err}")
                    barrier()
                    rec["ms"] = time_ms(lambda o=o: o @ xl)
                    rec["model_ms"] = 1e3 * PM.predicted_dist_spmv_seconds(
                        plan, halo, mode, calibration=None)
                    modes[f"{mode}:{halo}"] = rec
            return modes

        out["modes"] = run_modes(op, plan, "1-D")
        # the 2 x 2 grid: a smaller x halo, and the partial-sum
        # reduction's messages along grid rows
        plan2 = D.partition_csr(m, p_ranks, grid=(2, 2))
        op2 = DistOperator(plan2, comm, device=dev)
        out["grid"] = {"grid": [2, 2], "halo_w": plan2.halo_w,
                       "halo_lens": list(plan2.halo_lens),
                       "red_w": plan2.red_w,
                       "red_lens": list(plan2.red_lens),
                       "modes": run_modes(op2, plan2, "2x2")}
        del op2, plan2
        # the pieces alone: the local K1, and the messages of one product
        sh = op.shard
        out["k1_local_ms"] = time_ms(lambda: ops.pjds_matvec(sh.loc, xl))
        ks = range(2 * plan.halo_w)
        for halo in D.HALOS:
            barrier()
            out[f"exchange_{halo}_ms"] = time_ms(
                lambda h=halo: D._post_halo(sh, xl, comm, h, ks)[0].wait())
            out[f"exchange_{halo}_bytes"] = plan.comm_bytes_per_device(
                4, halo=halo)
        # what one message and one sum cost (a 1-entry exchange with the
        # ring neighbours, a 1-entry all_reduce), and the host's time to
        # launch a product and an exchange: calls back to back with no
        # synchronisation between them, so where it matches the event
        # time above, the host sets the pace
        nxt, prv = (rank + 1) % p_ranks, (rank - 1) % p_ranks
        one, got = torch.ones(1, device=dev), torch.empty(1, device=dev)
        barrier()
        out["message_1_ms"] = time_ms(lambda: comm.exchange(
            [(one, nxt, 0)], [(got, prv, 0)]).wait())
        out["all_reduce_1_ms"] = time_ms(lambda: comm.all_reduce_sum(one))

        def host_ms(fn, n=200):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t = time.perf_counter() - t0
            if cuda:
                torch.cuda.synchronize()
            return t * 1e3 / n

        barrier()
        out["matvec_host_ms"] = host_ms(lambda: op @ xl)
        barrier()
        out["exchange_gathered_host_ms"] = host_ms(
            lambda: D._post_halo(sh, xl, comm, "gathered", ks)[0].wait())
        # where a product's time goes: a profiler trace of 20 products
        # (overlap, gathered), host time per op and device time per
        # kernel, per product.  Device time counts kernels only (not
        # the annotations NCCL also reports as device ranges); an NCCL
        # kernel holds its SMs while it waits for the peers, so it is
        # given apart from the compute kernels.  The profiler slows the
        # host, so these shares describe the traced run only.
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        n_prof = 20
        barrier()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                op @ xl
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        ka = [e for e in prof.key_averages()
              if not getattr(e, "is_user_annotation", False)]
        top = sorted(ka, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:10]
        top += [e for e in sorted(ka, key=dev_us, reverse=True)[:6]
                if e not in top]
        kernel_us = sum(dev_us(e) for e in ka)
        nccl_us = sum(dev_us(e) for e in ka if e.key.startswith("nccl"))
        out["profile"] = {
            "products": n_prof, "wall_ms_per_product": wall * 1e3 / n_prof,
            "kernel_ms_per_product": kernel_us / 1e3 / n_prof,
            "nccl_kernel_ms_per_product": nccl_us / 1e3 / n_prof,
            "compute_busy_share": (kernel_us - nccl_us) / 1e6 / wall,
            "nccl_busy_share": nccl_us / 1e6 / wall,
            "ops": [{"name": e.key, "calls_per_product": e.count / n_prof,
                     "self_host_us": e.self_cpu_time_total / n_prof,
                     "self_device_us": dev_us(e) / n_prof} for e in top]}
        # CG: every rank must end alike
        bl = op.shard_vector(b)
        barrier()
        t0 = time.perf_counter()
        res = repro_torch.solve(op, bl)
        out["cg"] = {"status": res.status, "iters": res.iters,
                     "host_syncs": res.info["host_syncs"],
                     "seconds": time.perf_counter() - t0}
        barrier()
        t0 = time.perf_counter()
        res2 = repro_torch.solve(op, bl)
        out["cg"]["seconds_second_call"] = time.perf_counter() - t0
        out["cg"]["iters_second_call"] = res2.iters
        if res.status != "converged":
            fails.append(f"cg {res.status}")
        # the one-rank baseline on rank 0's card, in the same run
        g0 = dist.new_group([0])
        if rank == 0:
            plan1 = D.partition_csr(m, 1)
            op1 = DistOperator(plan1, GroupComm(g0), device=dev)
            x1 = op1.shard_vector(x)
            y1 = op1 @ x1
            err1 = float(np.abs(y1.cpu().double().numpy()[:m.n_rows] - y64)
                         .max() / np.abs(y64).max())
            if not err1 <= TOL:
                fails.append(f"P=1 err {err1}")
            out["p1"] = {"ms": time_ms(lambda: op1 @ x1),
                         "k1_ms": time_ms(lambda: ops.pjds_matvec(
                             op1.shard.loc, x1)),
                         "max_rel_err_vs_scipy_f64": err1}
        barrier()
        out["fails"] = fails
    finally:
        dist.destroy_process_group()
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(
            json.dumps(out))


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--timeout", type=int, default=600)
    a = ap.parse_args()
    import torch
    if a.backend == "nccl" and torch.cuda.device_count() < RANKS:
        print(f"dist_scaling: {RANKS} ranks need {RANKS} CUDA cards; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"dist_scaling: no repro_torch package under {SRC}",
              file=sys.stderr)
        return 2
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dist_scaling_") as tmp:
        procs = [ctx.Process(target=worker, args=(
            r, vars(a), os.path.join(tmp, "store"), tmp))
            for r in range(RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + a.timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung or any(p.exitcode != 0 for p in procs):
            print(f"dist_scaling: rank exit codes "
                  f"{[p.exitcode for p in procs]}", file=sys.stderr)
            return 1
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{r}.json")
                            .read_text()) for r in range(RANKS)]
    fails = [f for r in ranks for f in r["fails"]]
    if len({(r["cg"]["status"], r["cg"]["iters"]) for r in ranks}) != 1:
        fails.append("the ranks' CG results differ")
    r0 = ranks[0]
    summary = {"backend": a.backend, "ranks": RANKS,
               "devices": [r["device"] for r in ranks],
               "n_rows": r0["n_rows"], "nnz": r0["nnz"],
               "halo_w": r0["halo_w"], "halo_lens": r0["halo_lens"],
               "partition_s": [r["partition_s"] for r in ranks],
               "p1": r0["p1"], "cg": r0["cg"]}
    print(json.dumps({"phase": "dist_scaling:setup", **summary}), flush=True)
    for key in r0["modes"]:
        ms = [r["modes"][key]["ms"] for r in ranks]
        print(json.dumps({
            "phase": f"dist_scaling:{key}", "ms_per_rank": ms,
            "ms_max": max(ms), "speedup_vs_p1": r0["p1"]["ms"] / max(ms),
            "model_ms": r0["modes"][key]["model_ms"],
            "max_rel_err_vs_scipy_f64":
                r0["modes"][key]["max_rel_err_vs_scipy_f64"]}), flush=True)
    g = r0["grid"]
    print(json.dumps({"phase": "dist_scaling:2x2", **{
        k: v for k, v in g.items() if k != "modes"}}), flush=True)
    for key in g["modes"]:
        ms = [r["grid"]["modes"][key]["ms"] for r in ranks]
        print(json.dumps({
            "phase": f"dist_scaling:2x2:{key}", "ms_per_rank": ms,
            "ms_max": max(ms), "speedup_vs_p1": r0["p1"]["ms"] / max(ms),
            "model_ms": g["modes"][key]["model_ms"],
            "max_rel_err_vs_scipy_f64":
                g["modes"][key]["max_rel_err_vs_scipy_f64"]}), flush=True)
    print(json.dumps({"phase": "dist_scaling:pieces", **{
        k: [r[k] for r in ranks]
        for k in ("k1_local_ms", "exchange_gathered_ms", "exchange_full_ms",
                  "exchange_gathered_bytes", "exchange_full_bytes",
                  "message_1_ms", "all_reduce_1_ms", "matvec_host_ms",
                  "exchange_gathered_host_ms", "local_nnz", "remote_nnz")}}),
          flush=True)
    print(json.dumps({"phase": "dist_scaling:profile:rank0",
                      **r0["profile"]}), flush=True)
    if fails:
        print(f"dist_scaling: failed: {fails}", file=sys.stderr)
        return 1
    if a.backend == "nccl":
        print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "backend": a.backend,
                      "ranks": RANKS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
