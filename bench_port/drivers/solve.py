"""Traffic kind ``solve``: back-to-back solves through the front door,
``repro_torch.solve(op, b, method=..., tol=..., maxiter=...)``, a closed
loop from x0 = 0 with a new right-hand side from the seed each time.

b = A u for an exact solution u uniform on [0, 1) from the seed, as
PETSc's ``ex2 -random_exact_sol`` makes it, so the solution is
representable in float32 well below the configuration's tolerance.
Parameters (the traffic file): ``method``; ``tune``: set up through
``tune.tune_solver`` and build the operator with its layout;
``trace_solves``: solves in the profiled slice; ``samples``: solves
kept for the check, besides the last.  The configuration gives
``rtol`` and ``max_it``.

The check: the float64 relative residual of every kept solve that the
program reported converged (``residual``), against the configuration's
``rtol``.
"""
from __future__ import annotations

import statistics
import time

from bench_port.drivers import _common as C

__all__ = ["run"]


class _Rhs:
    """b = A u for u uniform on [0, 1) from the seed (PETSc's
    ``-random_exact_sol``: ``PetscRandom``'s default interval), made on
    the card with A in a padded row layout of the benchmark's own (each
    row summed in a fixed order, so a seed gives the same b)."""

    def __init__(self, indptr, indices, data, shape, device):
        import numpy as np
        import torch
        lens = np.diff(indptr)
        w = int(lens.max(initial=1))
        n = shape[0]
        pos = np.arange(len(indices)) - np.repeat(indptr[:-1], lens)
        cols = np.zeros((n, w), dtype=np.int64)
        vals = np.zeros((n, w), dtype=data.dtype)
        rows = np.repeat(np.arange(n), lens)
        cols[rows, pos] = indices
        vals[rows, pos] = data
        self.cols = torch.from_numpy(cols).to(device)
        self.vals = torch.from_numpy(vals).to(device)
        self.n, self.device = shape[1], device

    def make(self, seed: int):
        import torch
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        u = torch.rand(self.n, generator=g, device=self.device,
                       dtype=self.vals.dtype)
        return (self.vals * u[self.cols]).sum(dim=1)


def _one(solve, op, b, kw, SolveFailure):
    try:
        res = solve(op, b, **kw)
    except SolveFailure as e:
        return e.result, False
    return res, res.status == "converged"


def run(ctx) -> dict:
    import repro_torch
    from repro_torch.api import SolveFailure
    from repro_torch.core.formats import CSRMatrix
    from repro_torch.core.operator import operator

    from bench_port import reference as R
    from bench_port.tracing import Spans, TraceSlice

    dev, tr, conf = ctx.device, ctx.traffic, ctx.config
    sp = Spans()
    with sp("start_card"):
        C.start(dev)
    with sp("generate"):
        indptr, indices, data, shape = ctx.generate()
    nnz = int(indptr[-1])
    kernels = C.build_kernels(dev)
    m = CSRMatrix(indptr, indices, data, shape)
    rhs = _Rhs(indptr, indices, data, shape, dev)
    kw = dict(method=tr["method"], tol=conf["rtol"], maxiter=conf["max_it"])

    mem0 = C.allocated(dev)
    picked = {}
    layout = {}
    if tr["tune"]:
        from repro_torch.tune import tune_solver
        with sp("tune"):
            st = tune_solver(m, method=tr["method"], device=dev)
        layout = st.layout.build_kwargs()
        picked = {"tuner_strategy": st.strategy,
                  "tuner_layout": st.layout.label(),
                  "tuner_rows": [[r["label"], r["seconds_per_iter"]]
                                 for r in st.rows]}
    with sp("build"):
        op = operator(m, device=dev, **layout)
    res, _ = _one(repro_torch.solve, op, rhs.make(ctx.seed_of(1, 2 ** 32)),
                  kw, SolveFailure)
    picked.update(format=op.fmt, strategy=res.info.get("strategy"),
                  warm_iters=res.iters, warm_status=res.status)
    del res
    operand = None if mem0 is None else C.allocated(dev) - mem0

    rec = {"n_rows": shape[0], "n_cols": shape[1], "nnz": nnz,
           "operand_bytes": operand,
           "stored_slots": op.dev.storage_elements(),
           "device_kind": C.device_kind(dev)}

    if ctx.trace:
        path = f"{ctx.tmpdir}/bench_port_trace.json"
        iters = [0, 0]
        slices = [TraceSlice(sp, dev, path), TraceSlice(sp, dev, path,
                                                         host=False)]
        for k, ts in enumerate(slices):
            with ts:
                for j in range(tr["trace_solves"]):
                    b = rhs.make(ctx.seed_of(1, 2 ** 33 + 2 ** 20 * k + j))
                    with sp("solve"):
                        res, _ = _one(repro_torch.solve, op, b, kw,
                                      SolveFailure)
                    iters[k] += res.iters
        card = slices[1].summary
        rec["trace"] = dict(slices[0].summary, iters=iters[0],
                            card_only=card and dict(card, iters=iters[1]))

    keep = C.Reservoir(tr["samples"], ctx.seed_of(2))
    rec["setup_s"] = ctx.setup_s_now()
    solves = []
    sp.times.pop("solve", None)
    C.sync(dev)
    t0 = time.perf_counter()
    i = 0
    while True:
        with sp("rhs"):
            b = rhs.make(ctx.seed_of(1, i))
        with sp("solve"):
            res, ok = _one(repro_torch.solve, op, b, kw, SolveFailure)
        solves.append({"ok": ok, "iters": res.iters,
                       "host_syncs": res.info.get("host_syncs")})
        if ok:
            keep.offer(i, (b, res.x))
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    C.sync(dev)
    window = time.perf_counter() - t0
    rec["memory_peak_bytes"] = C.peak(dev)
    kept = keep.items()

    a64 = R.csr_f64(indptr, indices, data, shape)
    resid = [R.rel_residual(a64, b.double().cpu().numpy(),
                            x.double().cpu().numpy()) for _, (b, x) in kept]
    ok_solves = [s for s in solves if s["ok"]]
    rec.update(
        window_s=window, attempted=len(solves),
        failed=len(solves) - len(ok_solves), solves=solves,
        iters=sum(s["iters"] for s in solves),
        spans={k: list(v) for k, v in sp.times.items()},
        compared={"residual": max(resid)} if resid else {},
        info={"picked": picked, "kernels": kernels,
              "n_rows": shape[0], "nnz": nnz, "checked_solves": len(kept),
              "solve_s_quartiles": statistics.quantiles(sp.times["solve"],
                                                        n=4),
              "spans_s": {k: sum(v) for k, v in sp.times.items()}})
    return rec
