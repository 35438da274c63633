"""Multi-tenant solve serving: registry + continuous-batching scheduler.

Three tenants admit their SPD systems into one ``OperatorRegistry``
(each resident operator keyed by structural fingerprint; a second
admit of the same structure with new coefficients swaps values without
reconverting).  A ``SolveScheduler`` coalesces everyone's right-hand
sides into certified block-CG groups, sheds requests whose deadline
expired in queue, and keeps per-request latency in its metrics ledger.

    PYTHONPATH=src python -m repro_torch.examples.serve_solver [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core import matrices as M
from repro_torch.kernels._backend import resolve_device
from repro_torch.serve import OperatorRegistry, SolveRequest, SolveScheduler


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    registry = OperatorRegistry(capacity=4, tune="off", device=dev)
    tenants = {
        "heat": registry.admit(M.poisson_2d(16, 16)),
        "mesh": registry.admit(M.samg(scale=0.0005)),
        "grid": registry.admit(M.poisson_2d(20, 20)),
    }
    sched = SolveScheduler(registry, slots=4, maxiter=2000, tol=1e-6)

    # a burst of traffic: four RHS per tenant, one with a deadline that
    # has no hope (shed at tick time, never dispatched)
    reqs = []
    for name, entry in tenants.items():
        for k in range(4):
            reqs.append(SolveRequest(
                rid=len(reqs),
                b=rng.standard_normal(entry.shape[0]).astype(np.float32),
                tenant=entry.key,
                deadline_s=0.0 if (name == "mesh" and k == 3) else None))
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained()

    for r in reqs:
        serve = r.diagnostics.get("serve", {})
        print(f"req {r.rid:2d} tenant={serve.get('tenant', '?')[:8]} "
              f"status={r.status:9s} batch_k={serve.get('batch_k', '-')}")

    # same structure, new coefficients: zero-reconversion value swap
    heat = M.poisson_2d(16, 16)
    heat2 = dataclasses.replace(
        heat, data=(heat.data * 2.0).astype(heat.data.dtype))
    entry = registry.admit(heat2)
    print(f"value swap on resident structure: swaps={entry.swaps} "
          f"version={entry.version} (no reconversion, no re-tune)")

    snap = sched.metrics.snapshot()
    print(f"batches={snap['counters']['batches']} "
          f"converged={snap['counters']['converged']} "
          f"shed={snap['counters']['shed']} "
          f"occupancy_mean={snap['occupancy']['mean_s']:.2f} "
          f"p50_total={snap['total_s']['p50_s'] * 1e3:.1f}ms")
    assert snap["counters"]["converged"] == len(reqs) - 1
    assert snap["counters"]["shed"] == 1
    return {"n_requests": len(reqs),
            "statuses": [r.status for r in reqs],
            "residuals": [float(r.residual) for r in reqs],
            "batch_k": [r.diagnostics.get("serve", {}).get("batch_k")
                        for r in reqs],
            "swaps": int(entry.swaps), "version": int(entry.version),
            "counters": dict(snap["counters"]),
            "p50_total_s": float(snap["total_s"]["p50_s"])}


if __name__ == "__main__":
    main()
