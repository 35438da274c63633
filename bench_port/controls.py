"""The controls of the correctness check: the cells' computations one
precision lower than the configurations state (bfloat16 for their
float32), which the limits in ``bench_port/limits/`` must fail.

    python3 bench_port/controls.py --workload <name> --seeds 11 12 13

prints one JSON line per seed with the numbers the cell compares.

* ``solve`` cells: the reference CG (``reference.cg_plain``) in
  bfloat16 on the card -- matrix, vectors and scalars' operands -- put in
  the program's place on the cell's own right-hand sides: its
  ``residual``.  (The program's own bfloat16 path is no control here:
  ``solve(..., dtype=torch.bfloat16)`` refines to float32 accuracy, and
  the Poisson matrix's values are exact in bfloat16.)
* ``spmv`` cells: the program's own bfloat16 path,
  ``operator(m, dtype=torch.bfloat16)``, on the cell's own x: ``y_err``
  and, with ``transpose``, ``z_err``.
* ``dist_spmv`` cells: the reference product in bfloat16
  (``reference.spmv_bf16``): ``y_err``.

Every number is computed at the cell's own size (``overrides`` shrink
it for the tests).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

__all__ = ["control", "main"]


def control(workload: str, seed: int, *, device=None, overrides=None,
            root: pathlib.Path = ROOT) -> dict:
    """The control's numbers for one seed of ``workload``."""
    from bench_port import harness as H
    from bench_port import reference as R
    manifest = H._read_json(root / "BENCHMARK.json")
    cell = H.find_cell(manifest, workload, root)
    H._setup_env(root)
    import torch
    dev = torch.device(device or "cuda")
    ctx = H.Ctx(workload=workload, seed=seed, seconds=0.0, trace=False,
                cell=cell, device=dev, age_at_top=0.0,
                t_top=time.perf_counter(), tmpdir="",
                overrides=dict(overrides or {}))
    indptr, indices, data, shape = ctx.generate()
    a64 = R.csr_f64(indptr, indices, data, shape)
    kind = ctx.traffic["kind"]
    out = {"workload": workload, "seed": seed, "kind": kind}
    if kind == "solve":
        from bench_port.drivers.solve import _Rhs
        rhs = _Rhs(indptr, indices, data, shape, dev)
        b = rhs.make(ctx.seed_of(1, 0))
        bf = torch.bfloat16
        vals, cols = rhs.vals.to(bf), rhs.cols
        t0 = time.perf_counter()
        x, k = R.cg_plain(lambda p: (vals * p[cols]).sum(dim=1), b.to(bf),
                          tol=ctx.config["rtol"],
                          maxiter=ctx.config["max_it"],
                          dot=lambda u, v: float((u * v).sum()))
        out.update(iters=k, seconds=time.perf_counter() - t0,
                   residual=R.rel_residual(a64, b.double().cpu().numpy(),
                                           x.double().cpu().numpy()))
        return out
    from bench_port.drivers import _common as C
    x = C.ring(shape[1], ctx.traffic["ring"], ctx.seed_of(1), dev)[0]
    x64 = x.double().cpu().numpy()
    if kind == "spmv":
        from repro_torch.core.formats import CSRMatrix
        from repro_torch.core.operator import operator
        op = operator(CSRMatrix(indptr, indices, data, shape),
                      format=ctx.traffic["format"], dtype=torch.bfloat16,
                      device=dev)
        y = op @ x
        yk = y.double().cpu().numpy()
        out["y_err"] = R.rel_err(yk, a64 @ x64)
        if ctx.traffic["transpose"]:
            z = (op.T @ y).double().cpu().numpy()
            out["z_err"] = R.rel_err(z, a64.T @ yk)
        return out
    y = R.spmv_bf16(indptr, indices, data, shape, x.cpu().numpy())
    out["y_err"] = R.rel_err(y, a64 @ x64)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    for s in a.seeds:
        print(json.dumps(control(a.workload, s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
