"""Quickstart: wrap a sparse matrix as a SparseOperator, run y = A x.

``operator(m) @ x`` picks a format from row-length statistics, converts
once, and computes in the original basis.  The same object gives the
transpose (``op.T``, the transpose kernel on the card) and gradients.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import formats as F, matrices as M, perf_model as PM
from repro_torch.core.operator import operator
from repro_torch.kernels._backend import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. A sparse matrix with strongly varying row lengths (sAMG analogue)
    m = M.samg(scale=0.002)
    print(f"matrix: {m.shape}, nnz={m.nnz}, N_nzr={m.n_nzr:.1f}")

    # 2. Storage: ELLPACK pads to the global max row length; pJDS sorts
    #    rows and pads per 128-row block (paper Fig. 1)
    ell = F.csr_to_ell(m, row_align=128)
    pjds = F.csr_to_pjds(m, b_r=128)
    reduction = F.data_reduction_vs_ellpack(m)
    print(f"ELLPACK stored elements: {F.storage_elements(ell):>10,}")
    print(f"pJDS    stored elements: {F.storage_elements(pjds):>10,}")
    print(f"data reduction: {100 * reduction:.1f}% "
          "(paper Table 1 measured 19-71% on its matrices)")

    # 3. The one-line API: format="auto" prices the candidates
    op = operator(m, device=dev)
    print(f"operator(m) chose format={op.fmt!r}, shape={op.shape}")

    rng = np.random.default_rng(0)
    x = rng.standard_normal(m.shape[0]).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    y = (op @ xt).cpu().numpy()                  # original basis, y = A x
    y_ref = np.array([x[m.indices[m.indptr[i]:m.indptr[i + 1]]]
                      @ m.data[m.indptr[i]:m.indptr[i + 1]]
                      for i in range(m.n_rows)])
    matvec_err = float(np.abs(y - y_ref).max())
    print(f"max |op @ x - y_ref| = {matvec_err:.2e}")

    # 4. The transpose view: A^T y over the same stored layout
    dense = F.csr_to_dense(m)
    yt = (op.T @ torch.from_numpy(y_ref.astype(np.float32)).to(dev)
          ).cpu().numpy()
    yt_ref = dense.T @ y_ref
    scale = max(np.abs(yt_ref).max(), 1.0)
    rmatvec_rel = float(np.abs(yt - yt_ref).max() / scale)
    print(f"rel max |op.T @ y - ref| = {rmatvec_rel:.2e}")

    # 5. And it is differentiable: d(w.Ax)/dx = A^T w
    w = rng.standard_normal(m.shape[0]).astype(np.float32)
    wt = torch.from_numpy(w).to(dev)
    xg = xt.clone().requires_grad_()
    (gx,) = torch.autograd.grad(torch.dot(wt, op @ xg), xg)
    grad_err = float(np.abs(gx.cpu().numpy() - dense.T @ w).max())
    print(f"grad wrt x == A^T w: max err = {grad_err:.2e}")

    # 6. What the paper's model says about this matrix on the H100 (the
    #    reference prices the TPU v5e's HBM and ICI link here)
    lo, _ = PM.alpha_range(m.n_nzr)
    thresh = PM.n_nzr_upper_for_link_penalty(PM.H100.hbm_bw,
                                             PM.H100.ici_bw, alpha=lo)
    linked = m.n_nzr < thresh
    print(f"Eq.3 threshold (H100: HBM3 over NVLink; the reference prints "
          f"the TPU v5e's) N_nzr <= {thresh:.0f}: this matrix "
          f"(N_nzr={m.n_nzr:.0f}) is "
          + ("LINK-DOMINATED -> keep it resident, avoid host traffic"
             if linked else "compute-worthy"))
    return {"shape": tuple(m.shape), "nnz": int(m.nnz),
            "n_nzr": float(m.n_nzr),
            "ell_elements": int(F.storage_elements(ell)),
            "pjds_elements": int(F.storage_elements(pjds)),
            "data_reduction": float(reduction), "format": op.fmt,
            "matvec_err": matvec_err,
            "y_ref_max": float(np.abs(y_ref).max()),
            "rmatvec_rel_err": rmatvec_rel,
            "grad_err": grad_err,
            "grad_ref_max": float(np.abs(dense.T @ w).max()),
            "eq3_threshold": float(thresh), "link_dominated": bool(linked)}


if __name__ == "__main__":
    main()
