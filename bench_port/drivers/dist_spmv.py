"""Traffic kind ``dist_spmv``: back-to-back distributed products
``y = op @ x_local`` on ``core.operator.dist_operator(m, comm, ...)``,
one rank process per card on NCCL (gloo on the CPU, for the tests), a
closed loop on every rank with x taken in turn from a ring of global
vectors made from the seed and cut to the rank's slice.

Rank processes are started with ``multiprocessing``'s spawn and meet
through a ``FileStore`` in a directory under ``TMPDIR``; each writes its
record there, and the parent waits for all (at most ``timeout_s``) and
ends any that is left.  Every rank runs the same number of products:
after each block of about ``block_s`` seconds, rank 0's decision to
stop (its host clock past ``--seconds``) goes to all ranks in one
``all_reduce``.  The window starts after a barrier and ends after a
synchronisation and a barrier on every rank, so the slowest rank sets
it.

Parameters: ``ranks``, ``ring``, ``mode``, ``halo``, ``grid``
(``dist_operator``'s; ``null`` for its defaults), ``trace_calls``,
``samples``, ``block_s``, ``timeout_s``.

The check: rank 0 gathers every kept y from the ranks' slices
(``DistOperator.gather_vector``) and compares it with the float64
product (``y_err``).
"""
from __future__ import annotations

import datetime
import json
import os
import shutil
import sys
import tempfile
import time

from bench_port.drivers import _common as C

__all__ = ["run", "rank_main"]


def run(ctx) -> dict:
    import multiprocessing as mp
    tr = ctx.traffic
    ranks = tr["ranks"]
    cuda = ctx.device.type == "cuda"
    work = tempfile.mkdtemp(prefix="bench_port_dist_", dir=ctx.tmpdir)
    start_wall = time.time() - ctx.setup_s_now()
    a = dict(seed=ctx.seed, seconds=ctx.seconds, trace=ctx.trace,
             config=ctx.config, traffic=tr, ranks=ranks,
             backend="nccl" if cuda else "gloo", work=work,
             store=os.path.join(work, "store"), fault=ctx.fault,
             tmpdir=ctx.tmpdir, sys_path=list(sys.path))
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=rank_main, args=(r, a), daemon=False)
             for r in range(ranks)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + tr["timeout_s"]
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    try:
        recs = []
        for r in range(ranks):
            path = os.path.join(work, f"rank{r}.json")
            if not os.path.exists(path):
                raise RuntimeError(
                    f"rank {r} left no record (exit code "
                    f"{procs[r].exitcode}); see its standard error")
            with open(path) as f:
                recs.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    r0 = recs[0]
    rec = dict(r0)
    rec["window_s"] = max(r["window_s"] for r in recs)
    rec["setup_s"] = max(r["window_start_wall"] for r in recs) - start_wall
    rec["memory_peak_bytes"] = (None if r0["memory_peak_bytes"] is None else
                                max(r["memory_peak_bytes"] for r in recs))
    rec["halo_bytes"] = sum(r["halo_bytes"] for r in recs) / ranks
    rec["rank_forbidden"] = {r["rank"]: r["forbidden"] for r in recs
                             if r["forbidden"]}
    if ctx.trace and all((r.get("trace") or {}).get("card_only")
                         for r in recs):
        rec["device_busy"] = tuple(
            sum(r["trace"]["card_only"][k] for r in recs) / ranks
            for k in ("busy_s", "window_s"))
    rec["info"] = dict(r0["info"], ranks=[
        {k: r[k] for k in ("rank", "window_s", "products", "build_s",
                           "partition_s", "halo_bytes", "device_kind")}
        for r in recs])
    return rec


def _timed(fn, acc: list):
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            acc.append(time.perf_counter() - t0)
    return wrapper


def rank_main(rank: int, a: dict) -> None:
    """One rank: generate, partition, warm, measure, check; writes
    ``rank<r>.json`` into the run's directory."""
    sys.path[:0] = [p for p in a["sys_path"] if p not in sys.path]
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")
    import torch
    import torch.distributed as dist

    from bench_port import generators as G
    from bench_port import reference as R
    from bench_port.harness import forbidden_modules, resolve, sub_seed
    from bench_port.tracing import Spans, TraceSlice

    tr, ranks, seed = a["traffic"], a["ranks"], a["seed"]
    cuda = a["backend"] == "nccl"
    torch.set_num_threads(1)
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        a["backend"], store=dist.FileStore(a["store"], ranks), rank=rank,
        world_size=ranks,
        timeout=datetime.timedelta(seconds=tr["timeout_s"]))
    try:
        from repro_torch.core import dist_spmv as D
        from repro_torch.core.dist_comm import GroupComm
        from repro_torch.core.formats import CSRMatrix
        from repro_torch.core.operator import dist_operator

        comm = GroupComm()
        fault = resolve(a["fault"])
        if fault is not None:
            comm = fault("comm", comm)

        def barrier():
            comm.all_reduce_sum(torch.zeros(1, device=dev))
            C.sync(dev)

        sp = Spans()
        with sp("start_card"):
            C.start(dev)
        conf = a["config"]
        with sp("generate"):
            indptr, indices, data, shape = G.generate(
                conf["generator"], conf["args"], sub_seed(seed, 0))
            data = data.astype(conf["value_dtype"])
        nnz = int(indptr[-1])
        if rank == 0:
            kernels = C.build_kernels(dev)
        barrier()
        if rank != 0:
            kernels = C.build_kernels(dev)
        m = CSRMatrix(indptr, indices, data, shape)
        xs = C.ring(shape[1], tr["ring"], sub_seed(seed, 1), dev)

        part_s = []
        real = D.partition_csr
        D.partition_csr = _timed(real, part_s)
        try:
            with sp("build"):
                kw = {k: tr[k] for k in ("mode", "halo", "grid")
                      if tr.get(k) is not None}
                op = dist_operator(m, comm, transpose=None, device=dev, **kw)
        finally:
            D.partition_csr = real
        xl = [op.shard_vector(x) for x in xs]
        links = op.shard.links
        halo_bytes = 4 * sum((ln.recv_idx.numel() if op.halo == "gathered"
                              else op.n_loc) for ln in links)

        for x in xl:
            y = op @ x
        barrier()
        t0 = time.perf_counter()
        for j in range(2 * len(xl)):
            y = op @ xl[j % len(xl)]
        barrier()
        # one block size and sample for all ranks: the mean of their times
        per_call = float(comm.all_reduce_sum(torch.tensor(
            [(time.perf_counter() - t0) / (2 * len(xl))], dtype=torch.float64,
            device=dev)).item()) / ranks

        rec = {"rank": rank, "n_rows": shape[0], "n_cols": shape[1],
               "nnz": nnz, "halo_bytes": halo_bytes,
               "build_s": sp.total("build"),
               "partition_s": float(sum(part_s)),
               "device_kind": C.device_kind(dev)}
        if a["trace"]:
            path = os.path.join(a["work"], f"trace{rank}.json")
            slices = [TraceSlice(sp, dev, path), TraceSlice(sp, dev, path,
                                                             host=False)]
            for ts in slices:
                with ts:
                    for j in range(tr["trace_calls"]):
                        with sp("dist_spmv"):
                            y = op @ xl[j % len(xl)]
            rec["trace"] = dict(slices[0].summary, calls=tr["trace_calls"],
                                card_only=slices[1].summary)

        block = max(1, int(tr["block_s"] / max(per_call, 1e-7)))
        keep = C.Reservoir(tr["samples"], sub_seed(seed, 2))
        stop = torch.zeros(1, device=dev)
        barrier()
        rec["window_start_wall"] = time.time()
        t0 = time.perf_counter()
        i = 0
        while True:
            for _ in range(block):
                y = op @ xl[i % len(xl)]
                keep.offer(i, y)
                i += 1
            stop.fill_(float(rank == 0 and time.perf_counter() - t0
                             >= a["seconds"]))
            if comm.all_reduce_sum(stop).item() > 0:
                break
        C.sync(dev)
        barrier()
        rec["window_s"] = time.perf_counter() - t0
        kept = keep.items()
        rec["memory_peak_bytes"] = C.peak(dev)
        rec["products"] = i

        gathered = [(k, op.gather_vector(yk)) for k, yk in kept]
        rec["compared"] = {}
        if rank == 0:
            a64 = R.csr_f64(indptr, indices, data, shape)
            errs = [R.rel_err(y.double().cpu().numpy()[:shape[0]],
                              a64 @ xs[k % len(xs)].double().cpu().numpy())
                    for k, y in gathered]
            rec["compared"] = {"y_err": max(errs)}
        rec.update(attempted=i, failed=0,
                   spans={k: list(v) for k, v in sp.times.items()},
                   forbidden=forbidden_modules(),
                   info={"picked": {"mode": op.mode, "halo": op.halo,
                                    "grid": list(op.dist.grid_eff),
                                    "halo_w": op.dist.halo_w,
                                    "halo_lens": list(op.dist.halo_lens)},
                         "kernels": kernels, "n_rows": shape[0], "nnz": nnz,
                         "warm_call_s": per_call,
                         "checked_calls": len(gathered),
                         "spans_s": {k: sum(v) for k, v in sp.times.items()}})
        with open(os.path.join(a["work"], f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()
