"""Lanczos eigensolver on a Holstein-Hubbard-like Hamiltonian (HMEp).

The paper's motivating workload: extremal eigenvalues of a sparse
quantum Hamiltonian, where spMVM dominates the runtime.  The Krylov
iteration runs against the operator protocol -- ``operator(h)`` picks
the storage format and keeps every permutation internal, so the solver
sees the original basis end to end.  The Ritz estimate is then
polished with shift-inverted inverse iteration, whose inner SPD solves
go through ``repro_torch.solve``.

    PYTHONPATH=src python -m repro_torch.examples.eigensolver [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core import formats as F, matrices as M, solvers as S
from repro_torch.core.operator import operator
from repro_torch.kernels._backend import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--scale", type=float, default=0.001)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    raw = M.hmep(scale=args.scale)
    # symmetrise (physical Hamiltonians are Hermitian)
    d = F.csr_to_dense(raw)
    h = F.csr_from_dense(((d + d.T) / 2).astype(np.float32))
    print(f"Hamiltonian: {h.shape}, nnz={h.nnz}, N_nzr={h.n_nzr:.1f}")

    reduction = F.data_reduction_vs_ellpack(h)
    print(f"pJDS vs ELLPACK reduction: {100 * reduction:.1f}%")
    op = operator(h, b_r=128, device=dev)
    print(f"operator chose format={op.fmt!r}")

    rng = np.random.default_rng(0)
    v0 = torch.from_numpy(
        rng.standard_normal(h.n_rows).astype(np.float32)).to(dev)
    # the operator hides the permuted basis -- no permute/unpermute dance
    al, be = S.lanczos(op, v0, m=100)
    ritz = S.tridiag_eigvals(al, be)
    print(f"Lanczos Ritz extremes: lam_min~{ritz.min():.4f} "
          f"lam_max~{ritz.max():.4f}")

    # polish the extremal Ritz value with inverse iteration: for a shift
    # sigma just above lam_max, (sigma*I - H) is SPD, so each inverse-
    # iteration step is a CG solve through the repro_torch.solve front door
    sigma = float(ritz.max()) + 0.02
    dh = F.csr_to_dense(h)
    shifted = operator(
        F.csr_from_dense(sigma * np.eye(h.n_rows, dtype=np.float32) - dh),
        device=dev)
    # warm start: shifted power steps bias v toward the lam_max eigenvector
    v = v0 / torch.linalg.vector_norm(v0)
    for _ in range(20):
        v = op @ v + 7.0 * v
        v = v / torch.linalg.vector_norm(v)
    # 1e-4: (sigma*I - H) is near-singular by design, so its f32
    # residual floor sits around 1e-5; inverse iteration only needs the
    # direction
    for _ in range(3):
        sol = repro_torch.solve(shifted, v, method="cg", tol=1e-4,
                                maxiter=4000)
        v = sol.x / torch.linalg.vector_norm(sol.x)
    lam = float(v @ (op @ v))            # Rayleigh quotient, original basis
    print(f"inverse-iteration polish:  lam_max~{lam:.6f} "
          f"(cg iters/step ~{int(sol.iters)})")

    ref = np.linalg.eigvalsh(dh)
    print(f"dense reference:       lam_min={ref.min():.4f} "
          f"lam_max={ref.max():.4f}")
    err_lanczos = float(abs(ritz.max() - ref.max()))
    err_polish = float(abs(lam - ref.max()))
    print(f"extremal eigenvalue error: Lanczos {err_lanczos:.2e}, "
          f"polished {err_polish:.2e}")
    return {"shape": tuple(h.shape), "nnz": int(h.nnz),
            "data_reduction": float(reduction), "format": op.fmt,
            "shifted_format": shifted.fmt,
            "ritz_min": float(ritz.min()), "ritz_max": float(ritz.max()),
            "lam_polished": lam, "ref_min": float(ref.min()),
            "ref_max": float(ref.max()),
            "err_lanczos_max": err_lanczos,
            "err_lanczos_min": float(abs(ritz.min() - ref.min())),
            "err_polished": err_polish,
            "solve_status": sol.status, "solve_iters": int(sol.iters),
            "solve_strategy": sol.info.get("strategy")}


if __name__ == "__main__":
    main()
