"""Traffic kind ``spmv``: back-to-back products ``y = op @ x`` on
``core.operator.operator(m, format=...)``, a closed loop with no think
time, x taken in turn from a ring of vectors made from the seed; with
``transpose`` each product is followed by ``z = op.T @ y`` (the pair of
every LSQR / CGLS iteration).

Parameters: ``format`` (the operator's), ``ring``, ``transpose``,
``trace_calls`` (calls in the profiled slice), ``enqueue_calls``
(calls timed on the host after a synchronisation, for the operator's
enqueue time), ``samples`` (calls kept for the check, besides the
last).

The check: every kept y against the float64 product A x (``y_err``,
``max|y - y64| / max|y64|``), and every kept z against A^T y computed
in float64 from that y (``z_err``).
"""
from __future__ import annotations

import time

from bench_port.drivers import _common as C

__all__ = ["run"]


def run(ctx) -> dict:
    from repro_torch.core.formats import CSRMatrix
    from repro_torch.core.operator import operator

    from bench_port import reference as R
    from bench_port.tracing import Spans, TraceSlice

    dev, tr = ctx.device, ctx.traffic
    pair = bool(tr["transpose"])
    sp = Spans()
    with sp("start_card"):
        C.start(dev)
    with sp("generate"):
        indptr, indices, data, shape = ctx.generate()
    nnz = int(indptr[-1])
    kernels = C.build_kernels(dev)
    m = CSRMatrix(indptr, indices, data, shape)
    xs = C.ring(shape[1], tr["ring"], ctx.seed_of(1), dev)

    mem0 = C.allocated(dev)
    with sp("build"):
        op = operator(m, format=tr["format"], device=dev)
    opt = op.T
    for x in xs:
        y = op @ x
        if pair:
            z = opt @ y
    C.sync(dev)
    del y
    if pair:
        del z
    operand = None if mem0 is None else C.allocated(dev) - mem0
    rec = {"n_rows": shape[0], "n_cols": shape[1], "nnz": nnz,
           "operand_bytes": operand,
           "stored_slots": op.dev.storage_elements(),
           "device_kind": C.device_kind(dev),
           "products_per_call": 2 if pair else 1}

    def call(x, mark):
        if mark:
            with sp("spmv"):
                y = op @ x
            if pair:
                with sp("rmatvec"):
                    z = opt @ y
                return y, z
            return y, None
        y = op @ x
        return y, (opt @ y if pair else None)

    if ctx.trace:
        path = f"{ctx.tmpdir}/bench_port_trace.json"
        slices = [TraceSlice(sp, dev, path), TraceSlice(sp, dev, path,
                                                         host=False)]
        for k, ts in enumerate(slices):
            with ts:
                for j in range(tr["trace_calls"]):
                    call(xs[j % len(xs)], k == 0)
        rec["trace"] = dict(slices[0].summary, calls=tr["trace_calls"],
                            card_only=slices[1].summary)

    keep = C.Reservoir(tr["samples"], ctx.seed_of(2))
    rec["setup_s"] = ctx.setup_s_now()
    C.sync(dev)
    t0 = time.perf_counter()
    i = 0
    while True:
        y, z = call(xs[i % len(xs)], False)
        keep.offer(i, (y, z))
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    C.sync(dev)
    window = time.perf_counter() - t0
    kept = keep.items()
    del y, z
    rec["memory_peak_bytes"] = C.peak(dev)

    if ctx.trace:
        per = []
        for _ in range(5):
            C.sync(dev)
            t0 = time.perf_counter()
            for j in range(tr["enqueue_calls"]):
                op @ xs[j % len(xs)]
            per.append((time.perf_counter() - t0) / tr["enqueue_calls"])
            C.sync(dev)
        rec["enqueue_s"] = sorted(per)[len(per) // 2]

    a64 = R.csr_f64(indptr, indices, data, shape)
    y_err, z_err = [], []
    for k, (y, z) in kept:
        yk = y.double().cpu().numpy()
        y_err.append(R.rel_err(yk, a64 @ xs[k % len(xs)].double().cpu()
                               .numpy()))
        if pair:
            zk = z.double().cpu().numpy()
            z_err.append(R.rel_err(zk, a64.T @ yk))
    compared = {"y_err": max(y_err)}
    if pair:
        compared["z_err"] = max(z_err)
    rec.update(window_s=window, attempted=i, failed=0,
               products=i * rec["products_per_call"],
               spans={k: list(v) for k, v in sp.times.items()},
               compared=compared,
               info={"picked": {"format": op.fmt}, "kernels": kernels,
                     "n_rows": shape[0], "nnz": nnz,
                     "checked_calls": len(kept),
                     "spans_s": {k: sum(v) for k, v in sp.times.items()}})
    return rec
