#!/usr/bin/env python3
"""Drive the repro_torch port's main path on one CUDA card, at full size.

Builds the hand-written kernels (K1 pJDS spMV, K2 SELL-C-sigma spMV, K3
fused spMV + dots, K4 ELLPACK-R spMV, K5 multi-RHS pJDS, K6 CMRS spMV,
and the fused Krylov loop's scalar step and vector updates) from
``src/repro_torch/kernels/csrc``, runs the paper's pipeline on the sAMG
analogue at its published 3.4 M rows -- ``operator(m) @ x`` with the
format the dispatch picks or a named one, ``operator(m, format) @ X``
for a block of right-hand sides, and ``repro_torch.solve`` with fused
CG and BiCGStab (the loop on the card as CUDA graphs, one host read per
chunk), Jacobi-preconditioned CG over K6 and block CG -- fused and
composed BiCGStab on the 512 x 512 convection operator, the degradation
ladder on Poisson 128^2, and the paper's ELLPACK-R-vs-pJDS comparison,
and holds every kernel against its plain PyTorch version (the scalar
step bit for bit on a table of edge inputs) and every product and
solve against a float64 scipy reference.
K1, K2, K3, K5 and K6 walk only the slots their derived lengths cover;
the script checks that they repeat bit for bit and that walking every
stored slot gives the same bits, and times both walks (phase
``time:padding_skip``).  K3 is K2's window walk plus the dots: its y
must equal K2's bit for bit, and the two are timed in turns
(``time:k3_vs_k2:samg``).  Each kernel's bound counts the nnz slots the
function needs; K4's record adds the floor its unsorted layout sets
(``layout_bound_ms``) and its time on the Poisson operator, where K3 is
also timed as a CUDA graph.
The tuned front door runs last, each phase on a fresh tuning cache under
a temporary directory: ``operator(m, tune="force")`` on sAMG (the
measured rows, the winner held against scipy, then a cache hit that
measures nothing), ``repro_torch.solve(m, b)`` with no keywords on sAMG
and with the defaults on Poisson 512^2 (where the tuner must pick the
fused loop), bf16 solves refined against f32 residuals on both, and
``refine=True`` on an f32 operator whose CUDA graph is captured (the
graph must stay the f32 operand's own).
The distributed layer (paper §3) runs after it: ``dist:samg:p1`` is
``dist_operator(m, GroupComm())`` on an NCCL process group of one rank
(``op @ x`` against scipy and against the same body through the plain
versions, CG against the single-device composed CG, the rank's matvec
timed beside K1), ``dist:samg:p4`` four ranks of a 1-D partition as
threads of this process on the one card (``ThreadComm``): every mode x
halo flavour against P = 1 and scipy with K1's launches counted, a
4-rank CG, and each rank's local K1, remote K1 and index work timed
alone beside their nnz byte bounds and the perf model's prediction;
``dist:grid`` a 2 x 2 grid on a smaller sAMG (the partial-sum
reduction, ``op @ X`` through K5, ``op.T`` and block CG).
Each main-path phase sets every launch count to 0 before it and reads
the counts after it.  Each phase prints one JSON line; any failed check
raises, and the script then exits non-zero without its final line.

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
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
Y_TOL = 1e-5                     # max |kernel - plain| <= Y_TOL * max|y|
DOT_TOL = 1e-4                   # relative, per dot
SCIPY_TOL = 1e-5                 # max |kernel - f64| <= SCIPY_TOL * max|y|
BURST = 10                       # back-to-back calls per timing sample


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# The scalar step's table of edge inputs: K3's five dots, and the loop
# state they meet (csrc/krylov_step.cu; tests/test_torch_krylov.py holds
# the plain versions to numpy on the same kind of table).
STEP_DOTS = ([3.25, -1.5, 7.0, 2.0, 0.3], [0.0] * 5,
             [1e-40, 2e-41, 1e-39, 3e-40, -1e-41],
             [2.5, 1e-40, 1.0, 3e-40, 0.75], [-2.0, 1.0, 3.0, 5.0, 0.0],
             [float("nan"), 1.0, 1.0, 1.0, 0.0],
             [1.0, 1.0, float("inf"), float("inf"), 1.0],
             [1.0, 0.0, 0.0, 1e13, 0.0], [1e-31, 1e-20, 1e-36, 1e-32, 1e-31],
             [2.0, 1.0, 0.5, 1.0, -0.5])
STEP_STATES = ({}, dict(since=499, best=1e3), dict(since=499, best=1e-30),
               dict(since=500, best=1e-30), dict(since=999, best=1e-30),
               dict(since=1000, best=1e-30), dict(tol=0.0), dict(tol=-1.0),
               dict(k=99), dict(done=1), dict(flag=3))


def step_vs_plain(torch, np, R, KS, dev, require):
    """Every step kind on every (dots, state) pair of the table, the
    kernel on the card against the plain version on the CPU: the same
    bits (NaN on both sides counts as equal).  Returns (max |diff| over
    the finite values, cases)."""
    base = dict(tol=1e-5, b2=1.0, rs=4.0, best=1.0, alpha=0.5, beta=0.25,
                omega=0.75, rho=1.5, rhat_v=2.0, k=3, maxiter=100, flag=0,
                since=7, done=0, skip=0)
    fslot = dict(tol=R.FS_TOL, b2=R.FS_B2, rs=R.FS_RS, best=R.FS_BEST,
                 alpha=R.FS_ALPHA, beta=R.FS_BETA, omega=R.FS_OMEGA,
                 rho=R.FS_RHO, rhat_v=R.FS_RHAT_V)
    islot = dict(k=R.IS_K, maxiter=R.IS_MAXITER, flag=R.IS_FLAG,
                 since=R.IS_SINCE, done=R.IS_DONE, skip=R.IS_SKIP)

    def state(over, device):
        st = dict(base, **over)
        fs, is_ = KS.new_state(device)
        for k, i in fslot.items():
            fs[i] = st[k]
        for k, i in islot.items():
            is_[i] = st[k]
        return fs, is_

    def compare(fs_k, is_k, fs_p, is_p, what):
        a, b = fs_k.cpu().numpy(), fs_p.numpy()
        same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                         & np.isnan(b))
        require(bool(same.all()) and torch.equal(is_k.cpu(), is_p),
                f"krylov_step {what}: kernel {a.tolist()} "
                f"{is_k.tolist()} vs plain {b.tolist()} {is_p.tolist()}")
        fin = np.isfinite(a) & np.isfinite(b)
        return float(np.abs(a[fin].astype(np.float64)
                            - b[fin].astype(np.float64)).max(initial=0.0))

    err, n = 0.0, 0
    for over in STEP_STATES:
        for dots in STEP_DOTS:
            d = torch.tensor(dots, dtype=torch.float32)
            for kinds in ((R.STEP_CG,), (R.STEP_BICG1, R.STEP_BICG2)):
                fs_k, is_k = state(over, dev)
                fs_p, is_p = state(over, "cpu")
                for kind in kinds:
                    KS.step_kernel_call(kind, fs_k, is_k, d.to(dev))
                    R.krylov_step_ref(kind, fs_p, is_p, d)
                    err = max(err, compare(fs_k, is_k, fs_p, is_p,
                                           f"kind {kind} {dots} {over}"))
                    n += 1
    for start in ([4.0, 16.0], [0.0, 0.0], [1e-40, 1e-39],
                  [float("nan"), 1.0], [1.0, float("inf")], [-0.0, 2.0]):
        for tol, maxiter in ((1e-5, 100), (0.0, 100), (1e-5, 0)):
            fs_k, is_k = state(dict(since=400, k=17, flag=2, done=1), dev)
            fs_p, is_p = state(dict(since=400, k=17, flag=2, done=1), "cpu")
            d = torch.tensor(start, dtype=torch.float32)
            KS.step_kernel_call(R.STEP_INIT, fs_k, is_k, d.to(dev), tol=tol,
                                maxiter=maxiter)
            R.krylov_step_ref(R.STEP_INIT, fs_p, is_p, d, tol=tol,
                              maxiter=maxiter)
            err = max(err, compare(fs_k, is_k, fs_p, is_p, f"init {start}"))
            n += 1
    return err, n


def dist_phases(h) -> dict:
    """The distributed layer (paper §3) on the card: ``dist:samg:p1`` (an
    NCCL process group of one rank), ``dist:samg:p4`` (four ranks as
    threads of this process, one stream each, on the one card) and
    ``dist:grid`` (a 2 x 2 grid on a smaller sAMG).  ``h`` carries the
    card, the sAMG matrix with its scipy copy and right-hand sides, the
    single-device composed CG's iterations and ``main``'s helpers.
    Returns K1's and K5's launches on these phases and the largest
    kernel-vs-plain errors seen."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as tdist

    import repro_torch
    from repro_torch.core import dist_spmv as TD
    from repro_torch.core import formats as TF
    from repro_torch.core import matrices as TM
    from repro_torch.core import perf_model as TPM
    from repro_torch.core.dist_comm import GroupComm, ThreadComm, run_ranks
    from repro_torch.core.operator import DistOperator
    from repro_torch.kernels import ref as R

    dev, m, n, require, emit = h.dev, h.m, h.m.n_rows, h.require, h.emit
    launches = {"pjds_spmv": 0, "pjds_spmm": 0}
    worst = {"pjds_spmv": 0.0, "pjds_spmm": 0.0}

    def counted(phase):
        launched, plain_calls = h.counts()
        h.plain_free(plain_calls, phase)
        for k in launches:
            launches[k] += launched[k]
        return launched

    def plain_k1(a, v):
        return R.pjds_matvec_ref(a.val, a.col_idx, a.row_block, v,
                                 a.n_blocks)

    def vs_plain(a, v, what):
        """K1 on operand ``a`` against its plain version (relative)."""
        _, rel = h.rel_err(h.k1(a, v), plain_k1(a, v))
        require(rel <= h.Y_TOL, f"{what}: K1 vs plain {rel}")
        worst["pjds_spmv"] = max(worst["pjds_spmv"], rel)
        return rel

    def nnz_bound_ms(a, n_x):
        """Bytes the product needs: each stored non-zero (value + index)
        once, x and y once, the walk lengths and offsets once."""
        nnz = int((a.val != 0).sum())
        b = (nnz * (a.val.element_size() + a.col_idx.element_size())
             + 4 * (n_x + a.n_rows_pad + a.warp_len.numel()
                    + a.block_start.numel()))
        return 1e3 * b / h.HBM, nnz

    y64 = h.y64
    scale = float(np.abs(y64).max())

    def per_call(plan, mode, halo):
        """K1 (K5) launches of one rank's spMV: the local operand, then
        the remote one or one per pipeline stage (none without a halo)."""
        no_halo = (sum(plan.halo_lens) == 0 if halo == "gathered"
                   else plan.halo_w == 0)
        if no_halo:
            return 1
        return 1 + (len(plan.stage_dists) if mode == "pipeline" else 1)

    def err_vs(y_glob, ref):
        return float(np.abs(np.asarray(y_glob, np.float64)[:n] - ref).max()
                     / scale)

    # ---- dist:samg:p1 -- one rank of an NCCL process group -------------
    store = tempfile.TemporaryDirectory(prefix="chip_smoke_dist_")
    torch.cuda.set_device(dev)
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(os.path.join(store.name, "s"), 1),
        rank=0, world_size=1)
    try:
        comm = GroupComm()
        t0 = time.perf_counter()
        op1 = repro_torch.dist_operator(m, comm, transpose=None)
        t_part1 = time.perf_counter() - t0
        x1 = op1.shard_vector(h.x_np)
        h.reset_counts()
        y1 = op1 @ x1
        launched = counted("dist:samg:p1")
        require(launched["pjds_spmv"] == 1,
                f"dist:samg:p1: K1 launched {launched['pjds_spmv']}")
        sh = op1.shard
        y1_plain = plain_k1(sh.loc, x1).index_select(0, sh.seg_pos[0])
        _, e_plain = h.rel_err(y1, y1_plain)
        e_sci = err_vs(y1.cpu(), y64)
        require(e_plain <= h.Y_TOL, f"dist:samg:p1 vs plain body {e_plain}")
        require(e_sci <= h.SCIPY_TOL, f"dist:samg:p1 vs scipy {e_sci}")
        require(bool(torch.isfinite(y1).all()) and tuple(y1.shape) ==
                (op1.n_loc,), "dist:samg:p1: bad output")
        worst["pjds_spmv"] = max(worst["pjds_spmv"], e_plain)
        b1 = op1.shard_vector(h.b_np)
        h.reset_counts()
        t0 = time.perf_counter()
        rd = repro_torch.solve(op1, b1)
        t_solve1 = time.perf_counter() - t0
        launched_cg = counted("dist:samg:p1 cg")
        sci_cg = h.scipy_residual(h.a64, h.b_np, rd.x[:n])
        require(rd.status == "converged" and sci_cg <= 1e-5,
                f"dist:samg:p1 cg: {rd.status} {sci_cg}")
        require(abs(rd.iters - h.composed_iters) <= 1,
                f"dist:samg:p1 cg: {rd.iters} iterations, single-device "
                f"composed CG {h.composed_iters}")
        t_mv = h.time_ms(lambda: op1 @ x1)
        t_k1 = h.time_ms(lambda: h.k1(sh.loc, x1))
        bound1, nnz1 = nnz_bound_ms(sh.loc, op1.n_loc)
        emit("dist:samg:p1", comm="GroupComm(nccl), world size 1",
             partition_s=t_part1, n_global_pad=op1.shape[0],
             halo_w=op1.dist.halo_w, launches=launched,
             max_rel_err_vs_plain_body=e_plain,
             max_rel_err_vs_scipy_f64=e_sci,
             cg={"status": rd.status, "iters": rd.iters,
                 "single_device_composed_iters": h.composed_iters,
                 "host_syncs": rd.info["host_syncs"],
                 "strategy": rd.info["strategy"], "seconds": t_solve1,
                 "scipy_f64_residual": sci_cg,
                 "launches": launched_cg},
             matvec_ms=t_mv[0], matvec_ms_q25_q75=list(t_mv[1:]),
             k1_local_ms=t_k1[0], k1_local_ms_q25_q75=list(t_k1[1:]),
             matvec_over_k1=t_mv[0] / t_k1[0], k1_nnz_bound_ms=bound1,
             local_nnz=nnz1,
             model_ms={"h100": 1e3 * TPM.predicted_dist_spmv_seconds(
                 op1.dist, calibration=None)},
             p2p_messages=0, note="world size 1, halo_w 0: no message; "
             "only all_reduce runs")
        y1_glob = y1.cpu().numpy()
        del op1, rd, x1, b1, y1_plain
    finally:
        tdist.destroy_process_group()
        store.cleanup()

    # ---- dist:samg:p4 -- four ranks as threads, one card ---------------
    t0 = time.perf_counter()
    plan = TD.partition_csr(m, 4)
    t_part4 = time.perf_counter() - t0
    comms = ThreadComm.create(4, dev)
    t0 = time.perf_counter()
    ops4 = run_ranks(comms, lambda c: DistOperator(plan, c, device=dev))
    t_shard = time.perf_counter() - t0
    xs = [op.shard_vector(h.x_np) for op in ops4]
    bs = [op.shard_vector(h.b_np) for op in ops4]
    torch.cuda.synchronize()

    runs4 = {}
    for mode in TD.MODES:
        for halo in TD.HALOS:
            def body(c, mode=mode, halo=halo):
                op = copy.copy(ops4[c.rank])
                op.mode, op.halo = mode, halo
                return op @ xs[c.rank]

            h.reset_counts()
            ys = run_ranks(comms, body)
            launched = counted(f"dist:samg:p4 {mode} {halo}")
            want = 4 * per_call(plan, mode, halo)
            require(launched["pjds_spmv"] == want,
                    f"dist:samg:p4 {mode} {halo}: K1 launched "
                    f"{launched['pjds_spmv']}, expected {want}")
            yg = torch.cat(ys).cpu().numpy()
            e_p1 = float(np.abs(yg[:n].astype(np.float64)
                                - y1_glob[:n]).max() / scale)
            e_sci = err_vs(yg, y64)
            require(e_p1 <= h.SCIPY_TOL and e_sci <= h.SCIPY_TOL,
                    f"dist:samg:p4 {mode} {halo}: vs P=1 {e_p1}, "
                    f"vs scipy {e_sci}")
            runs4[f"{mode}:{halo}"] = {
                "k1_launches": launched["pjds_spmv"],
                "max_rel_err_vs_p1": e_p1, "max_rel_err_vs_scipy_f64": e_sci,
                "model_ms_h100": 1e3 * TPM.predicted_dist_spmv_seconds(
                    plan, halo, mode, calibration=None)}

    h.reset_counts()
    t0 = time.perf_counter()
    cg4 = run_ranks(comms, lambda c: repro_torch.solve(ops4[c.rank],
                                                       bs[c.rank]))
    t_cg4 = time.perf_counter() - t0
    launched_cg4 = counted("dist:samg:p4 cg")
    require(len({(r.status, r.iters) for r in cg4}) == 1,
            "dist:samg:p4 cg: the ranks disagree")
    x_cg = torch.cat([r.x for r in cg4])[:n]
    sci4 = h.scipy_residual(h.a64, h.b_np, x_cg)
    require(cg4[0].status == "converged" and sci4 <= 1e-5
            and abs(cg4[0].iters - h.composed_iters) <= 2,
            f"dist:samg:p4 cg: {cg4[0].status} {cg4[0].iters} {sci4}")

    # one rank at a time, no message in flight: its local K1, its remote
    # K1 on the ext buffer the exchange would fill, and the gathers,
    # scatters and unpermute of a gathered exchange
    gr, gc = plan.grid_eff
    w = plan.halo_w
    ranks = []
    for r, op in enumerate(ops4):
        sh = op.shard
        i, j = divmod(r, gc)
        ext = torch.cat([xs[((i + d) % gr) * gc + j] for d in range(-w, w + 1)])
        e_loc = vs_plain(sh.loc, xs[r], f"p4 rank {r} local")
        e_rem = vs_plain(sh.rem, ext, f"p4 rank {r} remote")
        y_loc = h.k1(sh.loc, xs[r])
        recv = {k: torch.zeros(ln.recv_idx.numel(), device=dev)
                for k, ln in enumerate(sh.links) if ln.recv_idx.numel()}

        def index_work(sh=sh, x=xs[r], recv=recv, y_loc=y_loc):
            for ln in sh.links:
                if ln.send_idx.numel():
                    x.index_select(0, ln.send_idx)
            TD._ext_of(sh, x, recv, "gathered")
            y_loc.index_select(0, sh.seg_pos[0])

        n_send = sum(ln.send_idx.numel() for ln in sh.links)
        n_recv = sum(ln.recv_idx.numel() for ln in sh.links)
        # gathers: index + value read, value written; scatter: index +
        # value read, the ext buffer written; unpermute: index, y read,
        # y slice written
        idx_bytes = (4 * (3 * n_send + 2 * n_recv + plan.ext_len)
                     + 4 * (2 * plan.n_loc + sh.loc.n_rows_pad))
        t_loc = h.time_ms(lambda: h.k1(sh.loc, xs[r]))
        t_rem = h.time_ms(lambda sh=sh, ext=ext: h.k1(sh.rem, ext))
        t_idx = h.time_ms(index_work)
        # the same as CUDA graphs: device time, without the host's
        # launch overhead that a burst of short launches can expose
        g_loc = h.time_ms(lambda: h.k1(sh.loc, xs[r]), graph=True)
        g_rem = h.time_ms(lambda sh=sh, ext=ext: h.k1(sh.rem, ext),
                          graph=True)
        g_idx = h.time_ms(index_work, graph=True)
        b_loc, nnz_loc = nnz_bound_ms(sh.loc, plan.n_loc)
        b_rem, nnz_rem = nnz_bound_ms(sh.rem, ext.numel())
        ranks.append({
            "rank": r, "local_nnz": nnz_loc, "remote_nnz": nnz_rem,
            "remote_share": nnz_rem / max(nnz_loc + nnz_rem, 1),
            "local_diagonals": int(sh.loc.val.shape[0]),
            "remote_diagonals": int(sh.rem.val.shape[0]),
            "k1_local_ms": t_loc[0], "k1_local_bound_ms": b_loc,
            "k1_remote_ms": t_rem[0], "k1_remote_bound_ms": b_rem,
            "index_ops_ms": t_idx[0],
            "index_ops_bound_ms": 1e3 * idx_bytes / h.HBM,
            "graph_ms": {"k1_local": g_loc[0], "k1_remote": g_rem[0],
                         "index_ops": g_idx[0]},
            "sent": n_send, "received": n_recv,
            "k1_local_rel_err_vs_plain": e_loc,
            "k1_remote_rel_err_vs_plain": e_rem})
    emit("dist:samg:p4", comm="ThreadComm, 4 ranks on one card",
         partition_s=t_part4, shard_s=t_shard, grid=list(plan.grid_eff),
         halo_w=plan.halo_w, halo_lens=list(plan.halo_lens),
         stage_dists=list(plan.stage_dists),
         comm_bytes_per_device={hl: plan.comm_bytes_per_device(4, halo=hl)
                                for hl in TD.HALOS},
         comm_msgs_per_device={hl: plan.comm_msgs_per_device(hl)
                               for hl in TD.HALOS},
         modes=runs4, ranks=ranks,
         cg={"status": cg4[0].status, "iters": cg4[0].iters,
             "host_syncs": cg4[0].info["host_syncs"], "seconds": t_cg4,
             "scipy_f64_residual": sci4, "launches": launched_cg4},
         model="perf_model.predicted_dist_spmv_seconds, H100 spec: a "
         "prediction of the link term, not a measurement")
    del ops4, xs, bs, cg4, plan

    # ---- dist:grid -- a 2 x 2 grid: the y reduction, K5, block CG ------
    ms = TM.samg(scale=0.05)
    a_s = h.csr64(ms)
    t0 = time.perf_counter()
    pg = TD.partition_csr(ms, 4, grid=(2, 2))
    pt = TD.partition_csr(TF.csr_transpose(ms), 4, grid=(2, 2))
    t_part = time.perf_counter() - t0
    require(pg.red_w >= 1, "dist:grid: no partial-sum reduction")
    dg = np.zeros(pg.n_global_pad, np.float64)
    dg[:ms.n_rows] = TF.csr_diagonal(ms)
    comms = ThreadComm.create(4, dev)
    opsg = run_ranks(comms, lambda c: DistOperator(pg, c, t_dist=pt,
                                                   diag=dg, device=dev))
    rng = np.random.default_rng(h.seed + 7)
    xg = rng.standard_normal(ms.n_rows).astype(np.float32)
    Xg = rng.standard_normal((ms.n_rows, 4)).astype(np.float32)
    xl = [op.shard_vector(xg) for op in opsg]
    Xl = [op.shard_vector(Xg) for op in opsg]
    torch.cuda.synchronize()
    h.reset_counts()
    outs = run_ranks(comms, lambda c: (opsg[c.rank] @ xl[c.rank],
                                       opsg[c.rank] @ Xl[c.rank],
                                       opsg[c.rank].rmatvec(xl[c.rank])))
    launched = counted("dist:grid")
    # per rank: A x and A^T x on K1, A X on K5
    fwd = per_call(pg, opsg[0].mode, opsg[0].halo)
    want = {"pjds_spmv": 4 * (fwd + per_call(pt, opsg[0].mode,
                                             opsg[0].halo)),
            "pjds_spmm": 4 * fwd}
    require(all(launched[k] == v for k, v in want.items()),
            f"dist:grid: launches {launched}, expected {want}")
    ns = ms.n_rows
    cat = lambda k: torch.cat([o[k] for o in outs]).cpu().double().numpy()[:ns]  # noqa: E731

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    e_y = rel(cat(0), a_s @ xg.astype(np.float64))
    e_Y = rel(cat(1), a_s @ Xg.astype(np.float64))
    e_T = rel(cat(2), a_s.T @ xg.astype(np.float64))
    require(max(e_y, e_Y, e_T) <= h.SCIPY_TOL,
            f"dist:grid vs scipy: y {e_y}, Y {e_Y}, A^T x {e_T}")
    # K5 on a rank's local operand against its plain version
    a0 = opsg[0].shard.loc
    _, e5 = h.rel_err(h.k5(a0, Xl[0]), R.pjds_matmat_ref(
        a0.val, a0.col_idx, a0.row_block, Xl[0], a0.n_blocks))
    require(e5 <= h.Y_TOL, f"dist:grid: K5 vs plain {e5}")
    worst["pjds_spmm"] = max(worst["pjds_spmm"], e5)
    vs_plain(a0, xl[0], "grid rank 0 local")
    Bg = rng.standard_normal((ms.n_rows, 4)).astype(np.float32)
    Bl = [op.shard_vector(Bg) for op in opsg]
    torch.cuda.synchronize()
    h.reset_counts()
    t0 = time.perf_counter()
    bcg = run_ranks(comms, lambda c: repro_torch.solve(
        opsg[c.rank], Bl[c.rank], method="block_cg"))
    t_bcg = time.perf_counter() - t0
    launched_b = counted("dist:grid block_cg")
    require(len({(r.status, r.iters) for r in bcg}) == 1,
            "dist:grid block CG: the ranks disagree")
    xb = torch.cat([r.x for r in bcg]).cpu().double().numpy()[:ns]
    res_b = float(np.max(np.linalg.norm(Bg - a_s @ xb, axis=0)
                         / np.linalg.norm(Bg, axis=0)))
    # per rank: the initial residual, one A P per iteration and the
    # certifying residual, each a local and a remote K5
    want_b = 4 * fwd * (bcg[0].iters + 2)
    require(bcg[0].status == "converged" and res_b <= 1e-5
            and launched_b["pjds_spmm"] == want_b
            and launched_b["pjds_spmv"] == 0,
            f"dist:grid block CG: {bcg[0].status} {res_b} {launched_b}, "
            f"expected {want_b} K5 launches")
    emit("dist:grid", comm="ThreadComm, 4 ranks on one card", grid=[2, 2],
         n_rows=ms.n_rows, nnz=ms.nnz, partition_s=t_part,
         halo_w=pg.halo_w, halo_lens=list(pg.halo_lens), red_w=pg.red_w,
         red_lens=list(pg.red_lens), launches=launched,
         max_rel_err_vs_scipy_f64={"y": e_y, "Y_k4": e_Y, "ATx": e_T},
         k5_rel_err_vs_plain=e5,
         block_cg={"status": bcg[0].status, "iters": bcg[0].iters,
                   "scipy_f64_residual": res_b, "seconds": t_bcg,
                   "host_syncs": bcg[0].info["host_syncs"],
                   "launches": launched_b})
    return {"launches": launches, "worst_rel_err_vs_plain": worst}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    t_start = time.perf_counter()
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
    from repro_torch.core import formats as TF
    from repro_torch.core import solvers as S
    from repro_torch.api import SolveFailure, _fused_dots_of
    from repro_torch.core.operator import _device_diagonal
    from repro_torch.kernels import _build
    from repro_torch.kernels import krylov_step as KS
    from repro_torch.kernels import ops as TO
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.cmrs_spmv import cmrs_matvec_kernel_call
    from repro_torch.kernels.ellr_spmv import ell_matvec_kernel_call
    from repro_torch.kernels.fused_iter import (fused_matvec_dots,
                                                fused_spmv_dots_kernel_call)
    from repro_torch.kernels.pjds_spmm import pjds_matmat_kernel_call
    from repro_torch.kernels.pjds_spmv import pjds_matvec_kernel_call
    from repro_torch.kernels.sell_spmv import (sell_matvec_kernel_call,
                                               slab_fits, window_blocks)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = {"pjds_spmv": pjds_matvec_kernel_call,
               "sell_spmv": sell_matvec_kernel_call,
               "fused_iter": fused_spmv_dots_kernel_call,
               "ellr_spmv": ell_matvec_kernel_call,
               "pjds_spmm": pjds_matmat_kernel_call,
               "cmrs_spmv": cmrs_matvec_kernel_call,
               "krylov_step": KS.step_kernel_call,
               "krylov_update": KS.update_kernel_call}
    plains = R._COUNTED

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

    def k1_with(d, lengths, v):
        """K1 on pJDS operand ``d`` walking ``lengths`` (per warp)."""
        return pjds_matvec_kernel_call(d.val, d.col_idx, d.block_start,
                                       lengths, v, n_blocks=d.n_blocks,
                                       max_col=d.max_col)

    def k2_with(d, lengths, v):
        """K2 on SELL operand ``d`` walking ``lengths`` (per warp)."""
        return sell_matvec_kernel_call(d.val, d.col_idx, d.block_start,
                                       d.inv_perm, lengths, v,
                                       n_blocks=d.n_blocks, sigma=d.sigma,
                                       max_col=d.max_col)

    def k3_with(d, lengths, v, w1, w2):
        """K3 on SELL operand ``d`` walking ``lengths``: (y, dots)."""
        return fused_spmv_dots_kernel_call(d.val, d.col_idx, d.block_start,
                                           d.inv_perm, lengths, v, w1, w2,
                                           n_blocks=d.n_blocks, sigma=d.sigma,
                                           max_col=d.max_col)

    def k5_with(d, lengths, xk, rows=None, n_out=0):
        """K5 on blocked operand ``d`` walking ``lengths``, with the row
        map ``rows`` onto ``n_out`` rows if given."""
        return pjds_matmat_kernel_call(d.val, d.col_idx, d.block_start,
                                       lengths, xk, n_blocks=d.n_blocks,
                                       max_col=d.max_col, out_row=rows,
                                       n_out=n_out)

    def k6_with(d, lengths, v):
        """K6 on CMRS operand ``d`` walking ``lengths`` (per strip)."""
        return cmrs_matvec_kernel_call(d.val, d.col_idx, d.row_in_strip,
                                       d.strip_start, lengths, v,
                                       n_strips=d.n_strips,
                                       max_col=d.max_col)

    def walk_lengths(d):
        """(derived, every stored slot) walk lengths of operand ``d``:
        per strip for CMRS, per warp for the pJDS layout."""
        if hasattr(d, "strip_nnz"):
            return d.strip_nnz, TO.stored_strip_nnz(d.strip_start, d.b_r)
        return d.warp_len, TO.stored_warp_len(d.block_start, d.b_r)

    def equal(a, b):
        if isinstance(a, tuple):                 # K3: (y, dots)
            return all(torch.equal(u, v) for u, v in zip(a, b))
        return torch.equal(a, b)

    def same_bits(y, run, d, what):
        """``run(lengths)`` -- K1, K2, K3, K5 or K6 on operand ``d`` --
        repeats ``y`` bit for bit with the derived lengths, and walking
        every stored slot changes no bit of it (K3: nor of its dots)."""
        derived, full = walk_lengths(d)
        require(equal(y, run(derived)), f"{what}: not bit-repeatable")
        require(equal(y, run(full)),
                f"{what}: full-length walk differs from the derived one")

    def time_ms(fn, reps=30, warm=5, burst=BURST, graph=False):
        """(median, 25th, 75th percentile) ms per call of ``fn`` by CUDA
        events, after ``warm`` calls.  Each of ``reps`` samples times
        ``burst`` calls back to back, so the card stays busy and the
        host's launch overhead hides behind the call before, as in a
        solver loop; ``burst=1`` times one call from an idle card, the
        host's launch overhead included.  ``graph`` replays the burst as
        one CUDA graph: device time for a kernel shorter than the host's
        launch overhead."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        run = lambda: [fn() for _ in range(burst)]
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                run()
            run = g.replay
            run()
        out = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1) / burst)
        return tuple(float(v) for v in np.percentile(out, [50, 25, 75]))

    # ---- 1. kernel build ------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, compiled=built,
         dir=str(_build.build_dir().relative_to(ROOT)),
         ptxas={n: _build.ptxas_usage(_build.build_log(n))
                for n in _build.SOURCES})

    def plain_free(plain_calls, what):
        require(not any(plain_calls.values()),
                f"{what}: plain version ran on the main path: {plain_calls}")

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
        plain_free(plain_calls, f"matvec:{name}")
        d = op.dev.dev
        if name == "pjds_spmv":
            y_k = k1_with(d, d.warp_len, x)
            y_r = R.pjds_matvec_ref(d.val, d.col_idx, d.row_block, x,
                                    d.n_blocks)
        else:
            y_k = k2_with(d, d.warp_len, x)
            y_r = R.sell_matvec_ref(d.val, d.col_idx, d.row_block,
                                    d.inv_perm, x, d.n_blocks)
        kern = k1_with if name == "pjds_spmv" else k2_with
        same_bits(y_k, lambda ln: kern(d, ln, x), d, name)
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

    # ---- 3b. the format the dispatch picks: K6 on sAMG; K4 named ------
    t0 = time.perf_counter()
    op_c = repro_torch.operator(m)                 # format="auto"
    t_cmrs = time.perf_counter() - t0
    require(op_c.fmt == "cmrs", f"auto picked {op_c.fmt} on sAMG, not cmrs")
    t0 = time.perf_counter()
    op_e = repro_torch.operator(m, format="ellpack_r")
    t_ell = time.perf_counter() - t0
    d_c, d_e = op_c.dev.dev, op_e.dev.dev
    for phase, name, op in (("matvec:auto:samg", "cmrs_spmv", op_c),
                            ("matvec:ellpack_r:samg", "ellr_spmv", op_e)):
        reset_counts()
        y = op @ x
        launched, plain_calls = counts()
        require(launched[name] >= 1, f"{phase}: {name} was not launched")
        plain_free(plain_calls, phase)
        d = op.dev.dev
        if name == "cmrs_spmv":
            y_k = k6_with(d, d.strip_nnz, x)
            y_r = R.cmrs_matvec_ref(d.val, d.col_idx, d.row_in_strip,
                                    d.strip_map, x, d.n_strips)
            same_bits(y_k, lambda ln: k6_with(d, ln, x), d, name)
        else:
            y_k = ell_matvec_kernel_call(d.val, d.col_idx, d.rowlen, x,
                                         max_col=d.max_col)
            y_r = R.ell_matvec_ref(d.val, d.col_idx, d.rowlen, x)
        e_abs, e_rel = rel_err(y_k, y_r)
        s_abs, s_rel = rel_err(y, y64_t)
        require(e_rel <= Y_TOL, f"{name} vs plain: {e_rel}")
        require(s_rel <= SCIPY_TOL, f"{phase} vs scipy f64: {s_rel}")
        require(tuple(y.shape) == (n,) and bool(torch.isfinite(y).all()),
                f"{phase}: bad output")
        errs[name] = (e_abs, e_rel)
        if name == "cmrs_spmv":
            main_launches[name] = launched[name]
        emit(phase, format=op.fmt, launches=launched, plain_calls=plain_calls,
             build_s=t_cmrs if name == "cmrs_spmv" else t_ell,
             stored_elements=op.dev.storage_elements(),
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
    # K3 is K2's window walk plus the dots: the same y, bit for bit
    require(torch.equal(y_k, k2_with(d_s, d_s.warp_len, xp)),
            "fused_iter: y differs from K2's on the same x")
    same_bits((y_k, dots_k), lambda ln: k3_with(d_s, ln, xp, w1, w2), d_s,
              "fused_iter")
    e_abs, e_rel = rel_err(y_k, y_r)
    dk, dr = dots_k.double().cpu(), dots_r.double().cpu()
    dot_rel = ((dk - dr).abs() / dr.abs().clamp(min=1e-30)).tolist()
    require(e_rel <= Y_TOL, f"fused_iter y vs plain: {e_rel}")
    require(max(dot_rel) <= DOT_TOL, f"fused_iter dots vs plain: {dot_rel}")
    errs["fused_iter"] = (e_abs, e_rel)
    # the fused loop's done latch: clear, K3 writes the bits of a launch
    # without it; set, it writes nothing
    done = torch.zeros(1, dtype=torch.int32, device=dev)
    y_d, dots_d = torch.empty_like(y_k), torch.empty_like(dots_k)
    fused_matvec_dots(d_s, xp, w1, w2, y=y_d, dots=dots_d, done=done)
    require(torch.equal(y_d, y_k) and torch.equal(dots_d, dots_k),
            "fused_iter: a clear done latch changed y or the dots")
    done.fill_(1)
    y_d.fill_(7.0)
    dots_d.fill_(7.0)
    fused_matvec_dots(d_s, xp, w1, w2, y=y_d, dots=dots_d, done=done)
    require(bool((y_d == 7).all()) and bool((dots_d == 7).all()),
            "fused_iter: wrote with the done latch set")
    del y_d, dots_d
    emit("fused:fused_iter", max_abs_err_vs_plain=e_abs,
         max_rel_err_vs_plain=e_rel, dots=dk.tolist(),
         dots_rel_err_vs_plain=dot_rel, y_equal_to_k2=True,
         derived_equal_to_full_walk=True, done_clear_same_bits=True,
         done_set_writes_nothing=True)

    # ---- 4b. the fused loop's scalar step and vector updates against
    #          their plain versions -------------------------------------
    step_err, n_cases = step_vs_plain(torch, np, R, KS, dev, require)
    n_pad = d_s.n_rows_pad
    upd = {}
    for kind, (nu, nv) in ((R.UPDATE_CG, (3, 1)), (R.UPDATE_BICG_P, (1, 2)),
                           (R.UPDATE_BICG_S, (1, 2)),
                           (R.UPDATE_BICG_XR, (2, 3))):
        for flag in (0, 1):
            g = torch.Generator(device=dev).manual_seed(SEED + kind)
            vecs = [torch.randn(n_pad, device=dev, generator=g)
                    for _ in range(nu + nv)]
            fs_u, _ = KS.new_state(dev)
            fs_u[R.FS_ALPHA], fs_u[R.FS_BETA] = -0.375, 1.25
            fs_u[R.FS_OMEGA] = 0.625
            f_u = torch.tensor([flag], dtype=torch.int32, device=dev)
            us_k = [v.clone() for v in vecs[:nu]]
            us_p = [v.cpu() for v in vecs[:nu]]
            KS.update_kernel_call(kind, f_u, fs_u, us_k, vecs[nu:])
            R.krylov_update_ref(kind, f_u.cpu(), fs_u.cpu(), us_p,
                                [v.cpu() for v in vecs[nu:]])
            for a, b_ in zip(us_k, us_p):
                require(torch.equal(a.cpu(), b_),
                        f"krylov_update kind {kind} flag {flag} differs "
                        f"from its plain version")
            upd[f"kind{kind}_flag{flag}"] = True
    del vecs, us_k, us_p
    errs["krylov_step"] = (step_err, step_err)
    errs["krylov_update"] = (0.0, 0.0)
    emit("step:vs_plain", step_cases=n_cases, step_max_abs_err=step_err,
         step_same_bits=True, update_n=n_pad, update_same_bits=upd)

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
    require(launched["krylov_step"] >= res.iters + 1
            and launched["krylov_update"] >= res.iters,
            "the fused loop's step and update kernels were not launched")
    plain_free(plain_calls, "solve:samg:fused")
    for k in ("fused_iter", "krylov_step", "krylov_update"):
        main_launches[k] = launched[k]

    def scipy_residual(a, bv, xv):
        r = bv.astype(np.float64) - a @ xv.double().cpu().numpy()
        return float(np.linalg.norm(r) / np.linalg.norm(bv))

    # ---- 5b. fused BiCGStab on sAMG: two K3 passes per iteration ------
    reset_counts()
    t0 = time.perf_counter()
    resb = repro_torch.solve(m, b_np, method="bicgstab", tune="off")
    launched, plain_calls = counts()
    sci_b = scipy_residual(a64, b_np, resb.x)
    emit("solve:samg:bicgstab", status=resb.status,
         strategy=resb.info["strategy"], iters=resb.iters,
         true_residual=resb.diagnostics["true_residual"],
         scipy_f64_residual=sci_b, host_syncs=resb.info["host_syncs"],
         chunk=resb.info["chunk"],
         graph_capture_s=resb.info["graph_capture_s"],
         ladder=resb.info["ladder"], launches=launched,
         plain_calls=plain_calls, seconds=time.perf_counter() - t0)
    require(resb.status == "converged", f"fused BiCGStab: {resb.status}")
    require(resb.info["strategy"] == "fused", "BiCGStab strategy not fused")
    require(sci_b <= 1e-5, f"BiCGStab scipy residual {sci_b}")
    require(launched["fused_iter"] >= 2 * resb.iters + 1, "K3 launches")
    plain_free(plain_calls, "solve:samg:bicgstab")

    # ---- 5c. Jacobi-preconditioned CG over K6, the format="auto" pick --
    diag = op_c.diagonal()
    require(np.array_equal(diag.cpu().numpy(),
                           a64.diagonal().astype(np.float32)),
            "diagonal() differs from scipy's A.diagonal() in float32")
    require(torch.equal(diag, _device_diagonal(op_c.dev)),
            "diagonal() does not repeat bit for bit")
    reset_counts()
    t0 = time.perf_counter()
    resj = repro_torch.solve(m, b_np, precond="jacobi", tune="off")
    launched, plain_calls = counts()
    sci_j = scipy_residual(a64, b_np, resj.x)
    emit("solve:samg:pcg_jacobi", status=resj.status,
         strategy=resj.info["strategy"], iters=resj.iters,
         true_residual=resj.diagnostics["true_residual"],
         scipy_f64_residual=sci_j, host_syncs=resj.info["host_syncs"],
         diagonal_equal_to_scipy=True, diagonal_repeats=True,
         launches=launched, plain_calls=plain_calls,
         seconds=time.perf_counter() - t0)
    require(resj.status == "converged", f"PCG: {resj.status}")
    require(resj.info["strategy"] == "composed", "PCG strategy")
    require(sci_j <= 1e-5, f"PCG scipy residual {sci_j}")
    require(launched["cmrs_spmv"] >= resj.iters + 1,
            "PCG did not run K6 (the format='auto' pick)")
    plain_free(plain_calls, "solve:samg:pcg_jacobi")

    # ---- 6. 2-D Poisson 512 x 512: the dispatch picks ELLPACK-R (K4), and
    #         a long fused-CG loop ------------------------------------------
    mp = TM.poisson_2d(512, 512)
    bp = np.random.default_rng(SEED).standard_normal(mp.n_rows).astype(
        np.float32)
    op_pe = repro_torch.operator(mp)               # format="auto"
    require(op_pe.fmt == "ellpack_r",
            f"auto picked {op_pe.fmt} on Poisson 512^2, not ellpack_r")
    xpo = torch.from_numpy(bp).to(dev)
    reset_counts()
    ype = op_pe @ xpo
    launched, plain_calls = counts()
    require(launched["ellr_spmv"] >= 1, "poisson512: K4 was not launched")
    plain_free(plain_calls, "matvec:auto:poisson512")
    ap64 = sp.csr_matrix((mp.data, mp.indices, mp.indptr), shape=mp.shape)
    s_abs, s_rel = rel_err(ype, torch.from_numpy(ap64 @ bp.astype(
        np.float64)))
    require(s_rel <= SCIPY_TOL, f"poisson512 K4 vs scipy f64: {s_rel}")
    main_launches["ellr_spmv"] = launched["ellr_spmv"]
    emit("matvec:auto:poisson512", format=op_pe.fmt, launches=launched,
         plain_calls=plain_calls, max_abs_err_vs_scipy_f64=s_abs,
         max_rel_err_vs_scipy_f64=s_rel)
    # The first fused solve on this operand captures the chunk's CUDA
    # graph; the second reuses it and is the one timed.
    t0 = time.perf_counter()
    resp0 = repro_torch.solve(mp, bp, tol=1e-5, maxiter=5000, tune="off",
                              fallback="off")
    t_first = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    resp = repro_torch.solve(mp, bp, tol=1e-5, maxiter=5000, tune="off",
                             fallback="off")
    launched, plain_calls = counts()
    t_p = time.perf_counter() - t0
    ms_iter = 1e3 * resp.info["phase_s"]["solve"] / max(resp.iters, 1)
    op_ps = repro_torch.operator(mp, format="sell")
    dp = op_ps.dev.dev
    vp = [torch.ones(dp.n_rows_pad, device=dev) for _ in range(3)]
    k3p = lambda: k3_with(dp, dp.warp_len, *vp)
    k3_ms = time_ms(k3p)[0]
    # one launch's host overhead outlasts K3 here, so the burst time is
    # the host's; a CUDA graph of the burst gives the device time
    k3_graph = time_ms(k3p, graph=True)
    # the drive at chunk 1 against the default chunk: the same x bit for
    # bit and the same iterations; then ms per iteration against chunk
    # (each chunk's first solve captures its graph, the second is timed)
    mvd = _fused_dots_of(op_ps)
    bpp = torch.zeros(dp.n_rows_pad, device=dev)
    bpp[: mp.n_rows] = torch.from_numpy(bp).to(dev)
    r_def = S.fused_cg(mvd, bpp, tol=1e-5, maxiter=5000)
    r_one = S.fused_cg(mvd, bpp, tol=1e-5, maxiter=5000, chunk=1)
    require(r_one.iters == r_def.iters and torch.equal(r_one.x, r_def.x),
            "the fused drive at chunk 1 differs from the default chunk")
    require(torch.equal(r_def.x[: mp.n_rows], resp.x),
            "solve() and fused_cg differ on the same operand")
    sweep = {}
    for c in (1, 4, 8, 16, 32, 64, 128):
        first = S.fused_cg(mvd, bpp, tol=1e-5, maxiter=5000, chunk=c)
        t0 = time.perf_counter()
        rc = S.fused_cg(mvd, bpp, tol=1e-5, maxiter=5000, chunk=c)
        dt = time.perf_counter() - t0
        sweep[c] = {"ms_per_iter": 1e3 * dt / rc.iters, "iters": rc.iters,
                    "host_syncs": rc.info["host_syncs"],
                    "graph_capture_s": first.info["graph_capture_s"]}
    emit("solve:poisson512:fused", status=resp.status, iters=resp.iters,
         true_residual=resp.diagnostics["true_residual"],
         restarts=resp.diagnostics["restarts"],
         host_syncs=resp.info["host_syncs"], chunk=resp.info["chunk"],
         graph_capture_s=resp0.info["graph_capture_s"],
         first_solve_seconds=t_first, launches=launched,
         plain_calls=plain_calls, seconds=t_p, ms_per_iter=ms_iter,
         ms_per_iter_pr15_host_loop=0.1799,
         chunk_1_same_x_and_iters=True, chunk_sweep=sweep,
         k3_ms_at_this_size=k3_ms, k3_share_of_iteration=k3_ms / ms_iter,
         k3_graph_ms=k3_graph[0], k3_graph_ms_q25_q75=list(k3_graph[1:]),
         k3_share_of_iteration_graph=k3_graph[0] / ms_iter,
         k3_slots_read=32 * int(dp.warp_len.long().sum()), nnz=mp.nnz)
    require(resp.status == "converged", f"poisson solve: {resp.status}")
    require(resp.info["graph_capture_s"] == 0.0, "the graph was captured "
            "again for a second solve on the same operand")
    runs = resp.diagnostics["restarts"] + 1
    require(resp.info["host_syncs"] <= -(-resp.iters // resp.info["chunk"])
            + 3 * runs, f"host syncs {resp.info['host_syncs']}")
    plain_free(plain_calls, "solve:poisson512:fused")

    # ---- 6b. BiCGStab on the 512 x 512 convection operator, fused and
    #          composed over K1 --------------------------------------------
    mcv = TM.convection_poisson(512, 512, beta=0.4)
    bcv = np.random.default_rng(SEED).standard_normal(mcv.n_rows).astype(
        np.float32)
    acv64 = sp.csr_matrix((mcv.data.astype(np.float64), mcv.indices,
                           mcv.indptr), shape=mcv.shape)
    conv = {}
    for label, fmt, kern, ref_iters in (("fused", "auto", "fused_iter", 670),
                                        ("composed", "pjds", "pjds_spmv",
                                         656)):
        reset_counts()
        t0 = time.perf_counter()
        rcv = repro_torch.solve(mcv, bcv, method="bicgstab", tol=1e-5,
                                maxiter=5000, format=fmt, tune="off",
                                fallback="off")
        launched, plain_calls = counts()
        sci_cv = scipy_residual(acv64, bcv, rcv.x)
        conv[label] = {"status": rcv.status,
                       "strategy": rcv.info["strategy"], "iters": rcv.iters,
                       "reference_iters_cpu": ref_iters,
                       "true_residual": rcv.diagnostics["true_residual"],
                       "scipy_f64_residual": sci_cv,
                       "host_syncs": rcv.info["host_syncs"],
                       "seconds": time.perf_counter() - t0,
                       "ms_per_iter": 1e3 * rcv.info["phase_s"]["solve"]
                       / max(rcv.iters, 1),
                       "launches": launched}
        require(rcv.status == "converged",
                f"convection512 {label} BiCGStab: {rcv.status}")
        require(rcv.info["strategy"] == label, f"{label} strategy")
        require(sci_cv <= 1e-5 * 1.05,
                f"convection512 {label} scipy residual {sci_cv}")
        require(launched[kern] >= rcv.iters + 1, f"{kern} launches")
        plain_free(plain_calls, f"solve:convection512:bicgstab:{label}")
    emit("solve:convection512:bicgstab", n_rows=mcv.n_rows, nnz=mcv.nnz,
         **conv)

    # ---- 6c. the degradation ladder on Poisson 128^2 ---------------------
    ml = TM.poisson_2d(128, 128)
    bl = np.ones(ml.n_rows, np.float32)
    want = [("primary", "diverged"), ("fused->composed", "diverged"),
            ("escalate:fresh-x0+jacobi", "diverged")]
    reset_counts()
    ladder = None
    try:
        repro_torch.solve(ml, bl, tol=1e-5, tune="off")
    except SolveFailure as e:
        ladder = e.ladder
    require(ladder is not None, "ladder:poisson128: no SolveFailure")
    got = [(e["rung"], e["status"]) for e in ladder]
    require(got == want, f"ladder:poisson128: {got}")
    rl = repro_torch.solve(ml, bl, tol=1e-4, tune="off")
    launched, plain_calls = counts()
    require(rl.status == "converged"
            and [e["rung"] for e in rl.info["ladder"]] == ["primary"],
            f"ladder:poisson128 at 1e-4: {rl.status} {rl.info['ladder']}")
    plain_free(plain_calls, "ladder:poisson128")
    emit("ladder:poisson128", ladder_1e5=ladder, ladder_1e4=rl.info["ladder"],
         iters_1e4=rl.iters, launches=launched, plain_calls=plain_calls)

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
    plain_free(plain_calls, "solve:samg:composed")

    # ---- 7b. a block of right-hand sides: K5 through matmat, block CG ---
    k_rhs = 8
    X = torch.from_numpy(rng.standard_normal((n, k_rhs)).astype(
        np.float32)).to(dev)
    Y64 = torch.from_numpy(a64 @ X.double().cpu().numpy())
    for fmt, op in (("sell", op_s), ("pjds", op_p)):
        reset_counts()
        Y = op @ X
        launched, plain_calls = counts()
        require(launched["pjds_spmm"] >= 1, f"matmat {fmt}: K5 not launched")
        plain_free(plain_calls, f"matmat:samg:{fmt}")
        s_abs, s_rel = rel_err(Y, Y64)
        require(tuple(Y.shape) == (n, k_rhs)
                and bool(torch.isfinite(Y).all()), f"matmat {fmt}: bad Y")
        require(s_rel <= SCIPY_TOL, f"matmat {fmt} vs scipy f64: {s_rel}")
        emit(f"matmat:samg:{fmt}", k=k_rhs, launches=launched,
             plain_calls=plain_calls, max_abs_err_vs_scipy_f64=s_abs,
             max_rel_err_vs_scipy_f64=s_rel)
    # K5 as the operator launches it (row map: rows stored in the
    # original order) and in the permuted basis, each against its plain
    # version on the same inputs
    unperm_s, rows_s = op_s.dev.stored_rows(), op_s.dev.row_map()
    Y_k = k5_with(d_s, d_s.warp_len, X)
    same_bits(Y_k, lambda ln: k5_with(d_s, ln, X), d_s, "pjds_spmm")
    Y_r = R.pjds_matmat_ref(d_s.val, d_s.col_idx, d_s.row_block, X,
                            d_s.n_blocks)
    e_perm = rel_err(Y_k, Y_r)
    Y_k = k5_with(d_s, d_s.warp_len, X, rows_s, n)
    same_bits(Y_k, lambda ln: k5_with(d_s, ln, X, rows_s, n), d_s,
              "pjds_spmm row map")
    errs["pjds_spmm"] = rel_err(Y_k, Y_r.index_select(0, unperm_s))
    require(max(e_perm[1], errs["pjds_spmm"][1]) <= Y_TOL,
            f"pjds_spmm vs plain: {e_perm}, row map {errs['pjds_spmm']}")
    emit("matmat:samg:k5_vs_plain", k=k_rhs,
         max_abs_err_vs_plain=errs["pjds_spmm"][0],
         max_rel_err_vs_plain=errs["pjds_spmm"][1],
         permuted_basis_max_rel_err_vs_plain=e_perm[1],
         derived_equal_to_full_walk=True)
    del Y_k, Y_r

    B_np = rng.standard_normal((n, 4)).astype(np.float32)
    # The first solve pays the process's one-time set-up of cuBLAS and
    # cuSOLVER (the Gram products and the k x k solves); the second is
    # the one counted and timed.
    t0 = time.perf_counter()
    repro_torch.solve(m, B_np, method="block_cg", format="sell", tune="off",
                      fallback="off")
    t_cold = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    resb = repro_torch.solve(m, B_np, method="block_cg", format="sell",
                             tune="off", fallback="off")
    launched, plain_calls = counts()
    t_b = time.perf_counter() - t0
    rb64 = B_np - a64 @ resb.x.double().cpu().numpy()
    col_res = (np.linalg.norm(rb64, axis=0)
               / np.linalg.norm(B_np, axis=0)).tolist()
    emit("solve:samg:block_cg", status=resb.status, k=4, iters=resb.iters,
         residual_per_column=[float(v) for v in resb.residual],
         true_residual=resb.diagnostics["true_residual"],
         scipy_f64_residual_per_column=col_res,
         host_syncs=resb.info["host_syncs"], launches=launched,
         plain_calls=plain_calls, seconds=t_b, first_solve_seconds=t_cold,
         ms_per_iter=1e3 * resb.info["phase_s"]["solve"]
         / max(resb.iters, 1))
    require(resb.status == "converged", f"block CG: {resb.status}")
    require(max(col_res) <= 1e-5, f"block CG scipy residuals {col_res}")
    require(launched["pjds_spmm"] >= resb.iters + 1, "K5 launches")
    plain_free(plain_calls, "solve:samg:block_cg")
    main_launches["pjds_spmm"] = launched["pjds_spmm"]

    # ---- 7c. the paper's comparison: pJDS (K1) against ELLPACK-R (K4) ---
    for label, chunk_l in (("default chunk_l=16", 16),
                           ("paper chunk_l=1 diag_align=1", 1)):
        e_h = TF.csr_to_ell(m, row_align=128, diag_align=chunk_l)
        p_h = TF.csr_to_pjds(m, b_r=128, diag_align=chunk_l,
                             permuted_cols=False)
        de = TO.to_device_ell(e_h, device=dev)
        dpp = TO.to_device_pjds(p_h, chunk_l=chunk_l, device=dev)
        y4 = ell_matvec_kernel_call(de.val, de.col_idx, de.rowlen, x,
                                    max_col=de.max_col)
        y1 = k1_with(dpp, dpp.warp_len, x)
        inv = torch.from_numpy(p_h.inv_perm[:n].astype(np.int64)).to(dev)
        require(rel_err(y1[inv], y4[:n])[1] <= Y_TOL, "K1 and K4 disagree")
        t4 = time_ms(lambda: ell_matvec_kernel_call(
            de.val, de.col_idx, de.rowlen, x, max_col=de.max_col))
        t1 = time_ms(lambda: k1_with(dpp, dpp.warp_len, x))
        ell_b, pj_b = TF.format_nbytes(e_h), TF.format_nbytes(p_h)
        ell_e, pj_e = TF.storage_elements(e_h), TF.storage_elements(p_h)
        emit("paper:samg", build=label, index_dtype=str(de.col_idx.dtype),
             ell_nbytes=ell_b, pjds_nbytes=pj_b, ell_elements=ell_e,
             pjds_elements=pj_e, data_reduction_elements=1.0 - pj_e / ell_e,
             data_reduction_bytes=1.0 - pj_b / ell_b, k4_ms=list(t4),
             k1_ms=list(t1), k1_speed_share_of_k4=t4[0] / t1[0],
             k1_slots_read=32 * int(dpp.warp_len.long().sum()))
        del de, dpp, e_h, p_h, y1, y4

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
        y1 = k1_with(p, p.warp_len, xs)
        e1 = rel_err(y1, R.pjds_matvec_ref(p.val, p.col_idx, p.row_block,
                                           xs, p.n_blocks))[1]
        same_bits(y1, lambda ln: k1_with(p, ln, xs), p,
                  f"small:{label} pjds_spmv")
        y2 = k2_with(s, s.warp_len, xs)
        e2 = rel_err(y2, R.sell_matvec_ref(s.val, s.col_idx, s.row_block,
                                           s.inv_perm, xs, s.n_blocks))[1]
        same_bits(y2, lambda ln: k2_with(s, ln, xs), s,
                  f"small:{label} sell_spmv")
        npd = s.n_rows_pad
        v = [torch.zeros(npd, device=dev) for _ in range(3)]
        for t in v:
            t[: ms.n_rows] = xs
        v[1].mul_(0.5)
        v[2].neg_()
        yk, dk = k3_with(s, s.warp_len, *v)
        require(torch.equal(yk, k2_with(s, s.warp_len, v[0])),
                f"small:{label} fused_iter: y differs from K2's")
        same_bits((yk, dk), lambda ln: k3_with(s, ln, *v), s,
                  f"small:{label} fused_iter")
        yr, dr = R.fused_matvec_dots_ref(s.val, s.col_idx, s.row_block,
                                         s.inv_perm, v[0], v[1], v[2],
                                         s.n_blocks)
        e3 = rel_err(yk, yr)[1]
        d3 = float(((dk.double() - dr.double()).abs()
                    / dr.double().abs().clamp(min=1e-30)).max())
        slab = slab_fits(window_blocks(s.sigma, s.b_r, s.n_blocks), s.b_r)
        # K5 on the SELL layout as the operator launches it (row map)
        xk = torch.stack([xs * (j + 1) for j in range(k_rhs)], dim=1)
        rows = ops_.dev.row_map()
        y5 = k5_with(s, s.warp_len, xk, rows, ms.n_rows)
        same_bits(y5, lambda ln: k5_with(s, ln, xk, rows, ms.n_rows), s,
                  f"small:{label} pjds_spmm row map")
        more = {"pjds_spmm_row_map_rel_err": rel_err(
            y5, R.pjds_matmat_ref(s.val, s.col_idx, s.row_block, xk,
                                  s.n_blocks).index_select(
                0, ops_.dev.stored_rows()))[1]}
        if sigma is None:              # K4, K5 and K6 at this policy
            e = repro_torch.operator(ms, format="ellpack_r", **kw).dev.dev
            c = repro_torch.operator(ms, format="cmrs", **kw).dev.dev
            more["ellr_rel_err"] = rel_err(
                ell_matvec_kernel_call(e.val, e.col_idx, e.rowlen, xs,
                                       max_col=e.max_col),
                R.ell_matvec_ref(e.val, e.col_idx, e.rowlen, xs))[1]
            y6 = k6_with(c, c.strip_nnz, xs)
            more["cmrs_rel_err"] = rel_err(
                y6, R.cmrs_matvec_ref(c.val, c.col_idx, c.row_in_strip,
                                      c.strip_map, xs, c.n_strips))[1]
            same_bits(y6, lambda ln: k6_with(c, ln, xs), c,
                      f"small:{label} cmrs_spmv")
            for k in (1, 3, 8):
                xk = torch.stack([xs * (j + 1) for j in range(k)], dim=1)
                y5 = k5_with(p, p.warp_len, xk)
                same_bits(y5, lambda ln: k5_with(p, ln, xk), p,
                          f"small:{label} pjds_spmm k={k}")
                more[f"pjds_spmm_k{k}_rel_err"] = rel_err(
                    y5, R.pjds_matmat_ref(p.val, p.col_idx, p.row_block, xk,
                                          p.n_blocks))[1]
        emit(f"small:{label}", n_rows=ms.n_rows, value_dtype=str(s.val.dtype),
             index_dtype=str(s.col_idx.dtype), sigma=s.sigma,
             sell_path="shared-memory slab" if slab else "device memory",
             pjds_rel_err=e1, sell_rel_err=e2, fused_y_rel_err=e3,
             fused_dots_rel_err=d3, **more)
        require(max(e1, e2, e3, *more.values()) <= Y_TOL and d3 <= DOT_TOL,
                f"small build {label} disagrees with the plain version")
        require(str(s.col_idx.dtype) == ("torch." + kw["index_dtype"]),
                "index dtype not kept")
        require(slab == (sigma is None), "wrong unpermute path exercised")

    # ---- 9. timings at full size (CUDA events, 30 samples of BURST calls) -
    # Bytes each call must move: every input read once, every output
    # written once, and of the matrix the nnz slots the function needs --
    # value + index width, plus CMRS's int8 row stream -- whatever padding
    # the layout stores.  The stored-slot bytes are printed beside as
    # ``stored_bytes``; ``slots_read`` is what the length-aware walks
    # touch (K1, K2, K3, K5: 32 lanes x warp_len per warp; K6: strip_nnz
    # rounded up to the 4 slots a lane loads at once).  K5 is timed as
    # the operator launches it, with its row map.
    vb = d_s.val.element_size()
    ib = d_s.col_idx.element_size()
    slot = vb + ib
    stored = d_s.val.numel()
    n_blocks = d_s.n_blocks
    w_b = window_blocks(d_s.sigma, d_s.b_r, n_blocks)
    n_part = -(-n_blocks // w_b)
    c_slot = d_c.val.element_size() + d_c.col_idx.element_size() + 1
    e_pad = d_e.n_rows_pad
    wl_s = d_s.warp_len.numel() * 4
    vec = {"pjds_spmv": n * 4 + d_p.n_rows_pad * 4 + (d_p.n_blocks + 1) * 4
           + d_p.warp_len.numel() * 4,
           "sell_spmv": n * 4 + 2 * n_pad * 4 + (n_blocks + 1) * 4 + wl_s,
           "fused_iter": n * 4 + 4 * n_pad * 4 + (n_blocks + 1) * 4 + wl_s
           + 2 * n_part * 5 * 4 + 5 * 4,
           "ellr_spmv": n * 4 + 2 * e_pad * 4,
           "pjds_spmm": (n_blocks + 1) * 4 + wl_s + n_pad * 4
           + 2 * n * k_rhs * 4,
           "cmrs_spmv": n * 4 + d_c.n_rows_pad * 4
           + (2 * d_c.n_strips + 1) * 4}
    stored_slots = {"pjds_spmv": d_p.val.numel() * slot,
                    "sell_spmv": stored * slot, "fused_iter": stored * slot,
                    "ellr_spmv": d_e.val.numel() * slot,
                    "pjds_spmm": stored * slot,
                    "cmrs_spmv": d_c.val.numel() * c_slot}
    bytes_ = {nm: float(m.nnz * (c_slot if nm == "cmrs_spmv" else slot)
                        + vec[nm]) for nm in vec}
    stored_bytes = {nm: float(stored_slots[nm] + vec[nm]) for nm in vec}
    sell_slots = 32 * int(d_s.warp_len.long().sum())
    slots_read = {
        "pjds_spmv": 32 * int(d_p.warp_len.long().sum()),
        "sell_spmv": sell_slots, "fused_iter": sell_slots,
        "pjds_spmm": sell_slots,
        "cmrs_spmv": 4 * int(((d_c.strip_nnz.long() + 3) // 4).sum())}
    flops = {"pjds_spmv": 2.0 * m.nnz, "sell_spmv": 2.0 * m.nnz,
             "fused_iter": 2.0 * m.nnz + 2.0 * 5 * n_pad,
             "ellr_spmv": 2.0 * m.nnz, "pjds_spmm": 2.0 * m.nnz * k_rhs,
             "cmrs_spmv": 2.0 * m.nnz}

    def library_ms(fn, what):
        try:      # a yardstick only: the port never calls cuSPARSE
            return time_ms(fn)[0]
        except RuntimeError as e:
            emit("library", call=what, error=f"{type(e).__name__}: {e}")
            return None

    # K4's layout floor: rows stay unsorted, so a 32-byte sector of val
    # or col spans 32 / width rows and is fetched while any of them runs.
    # Counted from the device arrays: the sectors that hold at least one
    # slot below rowlen, plus rowlen, x and y once.
    def ell_layout_bytes(e, n_x):
        j = torch.arange(e.val.shape[0], device=dev)[:, None]
        flat = (j < e.rowlen.long()[None, :]).flatten().nonzero().squeeze(1)
        sectors = sum(
            int(torch.unique_consecutive(flat * t.element_size() // 32)
                .numel()) for t in (e.val, e.col_idx))
        return float(32 * sectors + n_x * 4 + 2 * e.n_rows_pad * 4)

    def csr_of(mat):
        return torch.sparse_csr_tensor(
            torch.from_numpy(mat.indptr.astype(np.int64)),
            torch.from_numpy(mat.indices.astype(np.int64)),
            torch.from_numpy(mat.data.astype(np.float32)),
            size=mat.shape).to(dev)

    a_csr = csr_of(m)
    lib_mv = library_ms(lambda: torch.mv(a_csr, x), "torch.mv(csr, x)")
    lib_mm = library_ms(lambda: a_csr @ X, "csr @ X")
    library = {"pjds_spmv": lib_mv, "sell_spmv": lib_mv, "fused_iter": lib_mv,
               "ellr_spmv": lib_mv, "pjds_spmm": lib_mm, "cmrs_spmv": lib_mv}

    runs = {
        "pjds_spmv": (
            lambda: k1_with(d_p, d_p.warp_len, x),
            lambda: R.pjds_matvec_ref(d_p.val, d_p.col_idx, d_p.row_block,
                                      x, d_p.n_blocks)),
        "sell_spmv": (
            lambda: k2_with(d_s, d_s.warp_len, x),
            lambda: R.sell_matvec_ref(d_s.val, d_s.col_idx, d_s.row_block,
                                      d_s.inv_perm, x, n_blocks)),
        "fused_iter": (
            lambda: k3_with(d_s, d_s.warp_len, xp, w1, w2),
            lambda: R.fused_matvec_dots_ref(d_s.val, d_s.col_idx,
                                            d_s.row_block, d_s.inv_perm, xp,
                                            w1, w2, n_blocks)),
        "ellr_spmv": (
            lambda: ell_matvec_kernel_call(d_e.val, d_e.col_idx, d_e.rowlen,
                                           x, max_col=d_e.max_col),
            lambda: R.ell_matvec_ref(d_e.val, d_e.col_idx, d_e.rowlen, x)),
        "pjds_spmm": (
            lambda: k5_with(d_s, d_s.warp_len, X, rows_s, n),
            lambda: R.pjds_matmat_ref(d_s.val, d_s.col_idx, d_s.row_block,
                                      X, n_blocks).index_select(0, unperm_s)),
        "cmrs_spmv": (
            lambda: k6_with(d_c, d_c.strip_nnz, x),
            lambda: R.cmrs_matvec_ref(d_c.val, d_c.col_idx, d_c.row_in_strip,
                                      d_c.strip_map, x, d_c.n_strips)),
    }
    sources = {"pjds_spmv": "src/repro/kernels/pjds_spmv.py:150",
               "sell_spmv": "src/repro/kernels/sell_spmv.py:180",
               "fused_iter": "src/repro/kernels/fused_iter.py:199",
               "ellr_spmv": "src/repro/kernels/ellr_spmv.py:96",
               "pjds_spmm": "src/repro/kernels/pjds_spmm.py:108",
               "cmrs_spmv": "src/repro/kernels/cmrs_spmv.py:126"}

    def k4_poisson():
        """K4 on the Poisson 512^2 operator the dispatch built, beside its
        bounds and cuSPARSE on the same matrix.  One launch's host
        overhead outlasts this kernel, so the burst time is the host's;
        ``graph_ms`` replays the burst as a CUDA graph."""
        d = op_pe.dev.dev
        k4 = lambda: ell_matvec_kernel_call(d.val, d.col_idx, d.rowlen,
                                            xpo, max_col=d.max_col)
        t = time_ms(k4)
        tg = time_ms(k4, graph=True)
        a_p = csr_of(mp)
        nb = float(mp.nnz * (d.val.element_size() + d.col_idx.element_size())
                   + mp.n_rows * 4 + 2 * d.n_rows_pad * 4)
        lb = ell_layout_bytes(d, mp.n_rows)
        return {"n_rows": mp.n_rows, "nnz": mp.nnz, "ms": t[0],
                "ms_q25_q75": [t[1], t[2]], "graph_ms": tg[0],
                "graph_ms_q25_q75": [tg[1], tg[2]],
                "bound_ms": 1e3 * nb / HBM_BYTES_PER_S,
                "layout_bound_ms": 1e3 * lb / HBM_BYTES_PER_S,
                "library_ms": library_ms(lambda: torch.mv(a_p, xpo),
                                         "torch.mv(csr, x) poisson512")}

    # The fused loop's kernels (no Pallas kernel: XLA fused this work into
    # the reference's lax.while_loop body, solvers.py:587 for CG, :632
    # for BiCGStab).  The scalar step, CG kind, on a state that never
    # exits (tol 0): one thread, 88 bytes of dots and state; timed as a
    # CUDA graph, beside a step that returns at once (done set): the
    # launch floor.  The CG update at sAMG's padded length: x, r, p read
    # and written, Ap read.
    def step_state(done_):
        fs_, is_ = KS.new_state(dev)
        fs_[R.FS_B2], fs_[R.FS_BEST], fs_[R.FS_RS] = 1.0, 1.0, 4.0
        is_[R.IS_MAXITER], is_[R.IS_DONE] = 2 ** 30, done_
        return fs_, is_

    fs_t, is_t = step_state(0)
    fs_m, is_m = step_state(1)
    dots_t = torch.tensor([3.25, -1.5, 7.0, 2.0, 0.3], device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    xu, ru, pu, apu = (torch.randn(n_pad, device=dev, generator=g)
                       for _ in range(4))
    fs_u, _ = KS.new_state(dev)
    fs_u[R.FS_ALPHA], fs_u[R.FS_BETA] = 1e-3, 0.5
    f0 = torch.zeros(1, dtype=torch.int32, device=dev)
    runs["krylov_step"] = (
        lambda: KS.step_kernel_call(R.STEP_CG, fs_t, is_t, dots_t),
        lambda: R.krylov_step_ref(R.STEP_CG, fs_t, is_t, dots_t))
    runs["krylov_update"] = (
        lambda: KS.update_kernel_call(R.UPDATE_CG, f0, fs_u, (xu, ru, pu),
                                      (apu,)),
        lambda: R.krylov_update_ref(R.UPDATE_CG, f0, fs_u, (xu, ru, pu),
                                    (apu,)))
    bytes_["krylov_step"] = 88.0
    bytes_["krylov_update"] = 7.0 * 4 * n_pad
    flops["krylov_step"] = 20.0
    flops["krylov_update"] = 6.0 * n_pad
    library["krylov_step"] = library["krylov_update"] = None
    sources["krylov_step"] = sources["krylov_update"] = \
        "src/repro/core/solvers.py:587"
    graph_timed = {"krylov_step"}

    record = []
    for name, (kern, plain) in runs.items():
        k_ms, k_q25, k_q75 = time_ms(kern, graph=name in graph_timed)
        p_ms = time_ms(plain, reps=20, warm=2, burst=1)[0]
        t_bytes = bytes_[name] / HBM_BYTES_PER_S
        t_ops = flops[name] / F32_FLOPS
        src = "krylov_step" if name.startswith("krylov") else name
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}.cu",
               "replaces": sources[name],
               "launches": main_launches[name],
               "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
               "ms": k_ms, "ms_q25_q75": [k_q25, k_q75], "samples": 30,
               "launch_ms": time_ms(kern, burst=1)[0],
               "plain_ms": p_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library[name], "bytes": bytes_[name],
               "gbps": bytes_[name] / (k_ms * 1e-3) / 1e9}
        if name in stored_bytes:
            rec["stored_bytes"] = stored_bytes[name]
        if name == "krylov_step":
            lf = time_ms(lambda: KS.step_kernel_call(R.STEP_CG, fs_m, is_m,
                                                     dots_t), graph=True)
            rec["timing"] = "cuda graph"
            rec["launch_floor_ms"] = lf[0]
        if name in slots_read:
            rec["slots_read"] = slots_read[name]
            rec["slots_read_over_nnz"] = slots_read[name] / m.nnz
        if name == "ellr_spmv":
            lb = ell_layout_bytes(d_e, n)
            rec["layout_sector_bytes"] = lb
            rec["layout_bound_ms"] = 1e3 * lb / HBM_BYTES_PER_S
            rec["layout_share"] = rec["layout_bound_ms"] / k_ms
            rec["poisson512"] = k4_poisson()
        record.append(rec)
        emit(f"time:{name}", **rec)

    # The dispatch's decision under test: CMRS (K6) against SELL (K2) on
    # sAMG, interleaved in one call (K2, K6, K6, K2).
    pair = [time_ms(runs[nm][0]) for nm in ("sell_spmv", "cmrs_spmv",
                                            "cmrs_spmv", "sell_spmv")]
    k2_ms = float(np.median([pair[0][0], pair[3][0]]))
    k6_ms = float(np.median([pair[1][0], pair[2][0]]))
    emit("time:cmrs_vs_sell:samg", picked="cmrs", k2_sell_ms=k2_ms,
         k6_cmrs_ms=k6_ms, k6_over_k2=k6_ms / k2_ms,
         samples=[list(t) for t in pair],
         sell_stored_elements=stored,
         cmrs_stored_elements=d_c.val.numel())

    # K3 is K2 plus the dots: both timed in turns (K2, K3, K3, K2) on
    # the same x, so the ratio is the epilogue's cost on this card.
    pair = [time_ms(f) for f in (
        lambda: k2_with(d_s, d_s.warp_len, xp), runs["fused_iter"][0],
        runs["fused_iter"][0], lambda: k2_with(d_s, d_s.warp_len, xp))]
    k2_ms = float(np.median([pair[0][0], pair[3][0]]))
    k3_ms = float(np.median([pair[1][0], pair[2][0]]))
    emit("time:k3_vs_k2:samg", k2_sell_ms=k2_ms, k3_fused_ms=k3_ms,
         k3_over_k2=k3_ms / k2_ms, samples=[list(v) for v in pair])

    # The padding skip alone: K1, K2, K3, K5 (k = 8, row map) and K6
    # with their derived lengths and with every stored slot walked,
    # interleaved (derived, full, full, derived) in this call.
    skip = {}
    for nm, run, d in (
            ("pjds_spmv", lambda ln: k1_with(d_p, ln, x), d_p),
            ("sell_spmv", lambda ln: k2_with(d_s, ln, x), d_s),
            ("fused_iter", lambda ln: k3_with(d_s, ln, xp, w1, w2), d_s),
            ("pjds_spmm", lambda ln: k5_with(d_s, ln, X, rows_s, n), d_s),
            ("cmrs_spmv", lambda ln: k6_with(d_c, ln, x), d_c)):
        derived, full = walk_lengths(d)
        t = [time_ms(lambda ln=ln: run(ln))
             for ln in (derived, full, full, derived)]
        der = float(np.median([t[0][0], t[3][0]]))
        ful = float(np.median([t[1][0], t[2][0]]))
        skip[nm] = {"derived_ms": der, "full_ms": ful,
                    "full_over_derived": ful / der,
                    "slots_read": slots_read[nm],
                    "stored_slots": d.val.numel(),
                    "samples_derived_full_full_derived": [list(v) for v in t]}
    emit("time:padding_skip", **skip)

    # The operator layer around the kernels: each product through the
    # operator (dispatch, unpermute, slicing) beside its kernel alone, and
    # the pieces of one block-CG iteration at k = 4 beside K5 there.  The
    # (n, k) unpermute that K5's row map replaces is timed alone, with
    # K5 in the permuted basis that it would follow.
    kern_ms = {r["name"]: r["ms"] for r in record}
    X4 = X[:, :4].contiguous()
    g4 = X4.T @ X4
    def k5(xk, rows=None):
        return lambda: k5_with(d_s, d_s.warp_len, xk, rows, n)

    Y_p = k5(X)()
    unperm64 = unperm_s.long()
    emit("time:operator",
         operator_ms={"pjds_spmv": time_ms(lambda: op_p @ x)[0],
                      "sell_spmv": time_ms(lambda: op_s @ x)[0],
                      "ellr_spmv": time_ms(lambda: op_e @ x)[0],
                      "cmrs_spmv": time_ms(lambda: op_c @ x)[0],
                      "pjds_spmm": time_ms(lambda: op_s @ X)[0]},
         kernel_ms={nm: kern_ms[nm] for nm in ("pjds_spmv", "sell_spmv",
                                                "ellr_spmv", "cmrs_spmv",
                                                "pjds_spmm")},
         k5_row_map_k8={
             "k5_row_map_ms": time_ms(k5(X, rows_s))[0],
             "k5_permuted_basis_ms": time_ms(k5(X))[0],
             "index_select_2d_ms": time_ms(
                 lambda: Y_p.index_select(0, unperm_s))[0],
             "index_select_2d_int64_ms": time_ms(
                 lambda: Y_p.index_select(0, unperm64))[0],
             "advanced_index_2d_ms": time_ms(lambda: Y_p[unperm64])[0]},
         block_cg_k4={
             "operator_matmat_ms": time_ms(lambda: op_s @ X4)[0],
             "k5_ms": time_ms(k5(X4, rows_s))[0],
             "gram_ms": time_ms(lambda: X4.T @ X4)[0],
             "block_update_ms": time_ms(lambda: X4 @ g4)[0],
             "ridge_solve_ms": time_ms(lambda: S._ridge_solve(g4, g4))[0]})
    del Y_p
    emit("memory", max_allocated_gib=torch.cuda.max_memory_allocated()
         / 2 ** 30)

    # ---- 10. the tuned front door and mixed-precision refinement --------
    # Each phase tunes into a fresh cache file, and drops the conversions
    # an earlier phase left in the conversion cache.  Where the tuning
    # time goes: ``Spent`` wraps the fingerprint, the conversions (every
    # untuned ``as_device``; a conversion-cache hit adds microseconds)
    # and the measurement calls (their conversions subtracted).
    from repro_torch import tune as T
    from repro_torch.tune import measure as TME

    tune_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_tune_")
    n_caches = [0]

    def fresh_cache():
        n_caches[0] += 1
        os.environ["REPRO_TORCH_TUNE_CACHE"] = str(
            pathlib.Path(tune_dir.name) / f"tune_{n_caches[0]}.json")
        TO.clear_device_cache()

    class Spent:
        """Seconds and calls in the tuner's pieces while a call runs."""

        def __init__(self):
            self.s = {"fingerprint": 0.0, "convert": 0.0, "measure": 0.0,
                      "ab_compare": 0.0}
            self.n = dict.fromkeys(self.s, 0)
            self.undo = []
            for key, mod, attr in (
                    ("fingerprint", TF, "structural_fingerprint"),
                    ("convert", TO, "as_device"),
                    ("measure", TME, "measure_candidate"),
                    ("measure", TME, "measure_solver_candidate"),
                    ("ab_compare", TME, "ab_compare")):
                self.wrap(key, mod, attr)

        def wrap(self, key, mod, attr):
            orig = getattr(mod, attr)

            def fn(*a, **kw):
                if key == "convert" and kw.get("tune", "off") != "off":
                    return orig(*a, **kw)      # the tuned call itself
                t0 = time.perf_counter()
                conv0 = self.s["convert"]
                try:
                    return orig(*a, **kw)
                finally:
                    dt = time.perf_counter() - t0
                    if key != "convert":       # conversions inside
                        dt -= self.s["convert"] - conv0
                    self.s[key] += dt
                    self.n[key] += 1
            setattr(mod, attr, fn)
            self.undo.append((mod, attr, orig))

        def close(self, total):
            for mod, attr, orig in reversed(self.undo):
                setattr(mod, attr, orig)
            out = {f"{k}_s": v for k, v in self.s.items()}
            out.update({f"{k}_calls": v for k, v in self.n.items()})
            out["rest_s"] = total - sum(self.s.values())
            return out

    def tuned_solve(phase, mat, a_mat, bv, **kw):
        """A tuned solve twice on one fresh cache: cold (measured) and
        warm (a hit); returns (cold result, its record)."""
        fresh_cache()
        spent = Spent()
        reset_counts()
        t0 = time.perf_counter()
        r1 = repro_torch.solve(mat, bv, **kw)
        t1 = time.perf_counter() - t0
        launched, plain_calls = counts()
        where = spent.close(t1)
        plain_free(plain_calls, phase)
        st = T.tune_solver(mat, device=dev)
        require(st.cached and st.strategy == r1.info["tune"]["strategy"],
                f"{phase}: the tuner's record does not match the solve")
        t0 = time.perf_counter()
        r2 = repro_torch.solve(mat, bv, **kw)
        t2 = time.perf_counter() - t0
        require(r2.info["tune"]["cached"], f"{phase}: second call not cached")
        sci = scipy_residual(a_mat, bv, r1.x)
        rec = {"status": r1.status, "strategy": r1.info["strategy"],
               "tune": r1.info["tune"], "iters": r1.iters,
               "true_residual": r1.diagnostics["true_residual"],
               "scipy_f64_residual": sci, "seconds": t1,
               "phase_s": r1.info["phase_s"], "tuning_breakdown": where,
               "host_syncs": r1.info["host_syncs"],
               "solver_rows": [{k: r[k] for k in ("label",
                                                  "seconds_per_iter")}
                               for r in st.rows],
               "cached_call": {"tune": r2.info["tune"], "seconds": t2,
                               "phase_s": r2.info["phase_s"],
                               "status": r2.status, "iters": r2.iters},
               "launches": launched, "plain_calls": plain_calls}
        if "refine" in r1.info:
            rec["refine"] = r1.info["refine"]
        require(r1.status == "converged" and r2.status == "converged",
                f"{phase}: {r1.status} / {r2.status}")
        require(sci <= 1e-5, f"{phase}: scipy residual {sci}")
        emit(phase, **rec)
        return r1, rec

    # Poisson 512^2 (tol 1e-5 as above: the default maxiter 500 is short
    # of its 1116 iterations): the tuner must pick the fused loop.
    rpd, _ = tuned_solve("solve:poisson512:default", mp, ap64, bp, tol=1e-5,
                         maxiter=5000)
    require(rpd.info["tune"]["strategy"] == "fused"
            and rpd.info["strategy"] == "fused",
            f"poisson512 tuned {rpd.info['tune']}, not fused")
    rpb, rec = tuned_solve("solve:poisson512:bf16", mp, ap64, bp, tol=1e-5,
                           maxiter=5000, dtype=torch.bfloat16)
    require(rpb.info["strategy"].endswith("+refined")
            and rec["launches"]["fused_iter"] >= 1,
            f"poisson512 bf16: {rpb.info['strategy']}")

    # refine=True on the f32 Poisson operator whose graphs phase 6
    # captured: the bf16 clone gets its own fused loop, and the f32
    # operand's loops, graphs and results stay as they were.
    mvd_p = _fused_dots_of(op_ps)
    fused_before = dict(op_ps.dev.fused)
    loops_before = {k: (lp, lp.graph, lp.per_replay)
                    for k, lp in mvd_p.loops.items()}
    require(all(g is not None for _, g, _ in loops_before.values()),
            "refine:cast: the f32 operand has no captured graph")
    reset_counts()
    t0 = time.perf_counter()
    rcast = repro_torch.solve(op_ps, bp, tol=1e-5, maxiter=5000, refine=True)
    t_cast = time.perf_counter() - t0
    launched, plain_calls = counts()
    plain_free(plain_calls, "refine:cast")
    same = (op_ps.dev.fused.keys() == fused_before.keys()
            and all(op_ps.dev.fused[k] is v for k, v in fused_before.items())
            and mvd_p.loops.keys() == loops_before.keys()
            and all(mvd_p.loops[k] is lp and lp.graph is g
                    and lp.per_replay == pr
                    for k, (lp, g, pr) in loops_before.items()))
    require(same, "refine:cast: the f32 operand's fused loops changed")
    r_after = S.fused_cg(mvd_p, bpp, tol=1e-5, maxiter=5000)
    require(torch.equal(r_after.x, r_def.x)
            and r_after.info["graph_capture_s"] == 0.0,
            "refine:cast: the f32 fused solve changed after refinement")
    sci_cast = scipy_residual(ap64, bp, rcast.x)
    emit("refine:cast", status=rcast.status, strategy=rcast.info["strategy"],
         iters=rcast.iters, refine=rcast.info["refine"],
         true_residual=rcast.diagnostics["true_residual"],
         scipy_f64_residual=sci_cast, seconds=t_cast,
         host_syncs=rcast.info["host_syncs"], f32_loops_untouched=True,
         f32_solve_same_bits_after=True, launches=launched,
         plain_calls=plain_calls)
    require(rcast.status == "converged"
            and rcast.info["strategy"] == "fused+refined",
            f"refine:cast: {rcast.status} {rcast.info['strategy']}")
    require(sci_cast <= 1e-5, f"refine:cast: scipy residual {sci_cast}")
    require(launched["fused_iter"] >= 1 and launched["sell_spmv"] >= 1,
            "refine:cast: K3 (inner) or K2 (f32 residual) not launched")

    # sAMG: operator(m, tune="force") measures the kernel-static space;
    # a second, tune="auto", call must be a hit that measures nothing.
    fresh_cache()
    t0 = time.perf_counter()
    TF.structural_fingerprint(m)
    t_fp = time.perf_counter() - t0
    spent = Spent()
    reset_counts()
    t0 = time.perf_counter()
    op_t = repro_torch.operator(m, tune="force")
    t_cold = time.perf_counter() - t0
    launched_t, plain_t = counts()
    where = spent.close(t_cold)
    plain_free(plain_t, "tune:samg:autotune")
    spent = Spent()
    reset_counts()
    t0 = time.perf_counter()
    op_h = repro_torch.operator(m, tune="auto")
    t_hit = time.perf_counter() - t0
    launched_h, _ = counts()
    where_hit = spent.close(t_hit)
    require(where_hit["measure_calls"] == 0 and where_hit["ab_compare_calls"]
            == 0 and not any(launched_h.values()),
            f"tune:samg: the tune='auto' call measured: {where_hit}")
    tr = T.autotune(m, device=dev)
    require(tr.cached and op_h.fmt == op_t.fmt == tr.best.fmt,
            "tune:samg: the cached pick differs from the forced one")
    reset_counts()
    y_t = op_t @ x
    launched, plain_calls = counts()
    plain_free(plain_calls, "tune:samg:autotune winner")
    require(sum(launched.values()) >= 1, "tune:samg: no kernel launched")
    s_abs, s_rel = rel_err(y_t, y64_t)
    require(tuple(y_t.shape) == (n,) and bool(torch.isfinite(y_t).all()),
            "tune:samg: bad output")
    require(s_rel <= SCIPY_TOL, f"tune:samg winner vs scipy f64: {s_rel}")
    emit("tune:samg:autotune", winner=tr.best.label(),
         heuristic=tr.heuristic_row["label"],
         winner_is_heuristic=tr.best.label() == tr.heuristic_row["label"],
         rows=[{k: r[k] for k in ("label", "heuristic", "model_s",
                                  "measured_s")} for r in tr.rows],
         device_kind=tr.key.split("/")[1], seconds_cold=t_cold,
         tuning_breakdown=where, seconds_hit=t_hit, hit_breakdown=where_hit,
         fingerprint_s=t_fp, nnz=m.nnz, launches_tuning=launched_t,
         launches_product=launched, max_abs_err_vs_scipy_f64=s_abs,
         max_rel_err_vs_scipy_f64=s_rel)
    del op_t, op_h, y_t

    # repro_torch.solve(m, b) with no keywords, then bf16 with refinement
    tuned_solve("solve:samg:default", m, a64, b_np)
    rsb, _ = tuned_solve("solve:samg:bf16", m, a64, b_np,
                         dtype=torch.bfloat16)
    require(rsb.info["strategy"].endswith("+refined"),
            f"samg bf16: {rsb.info['strategy']}")
    TO.clear_device_cache()
    tune_dir.cleanup()
    emit("memory:tuned", max_allocated_gib=torch.cuda.max_memory_allocated()
         / 2 ** 30, seconds_since_start=time.perf_counter() - t_start)

    # ---- 10b. the distributed layer --------------------------------------
    import types
    dist_out = dist_phases(types.SimpleNamespace(
        dev=dev, m=m, a64=a64, x_np=x_np, b_np=b_np, y64=y64, seed=SEED,
        composed_iters=resc.iters, require=require, emit=emit,
        counts=counts, reset_counts=reset_counts, plain_free=plain_free,
        rel_err=rel_err, time_ms=time_ms, scipy_residual=scipy_residual,
        csr64=lambda mm: sp.csr_matrix((mm.data, mm.indices, mm.indptr),
                                       shape=mm.shape),
        k1=lambda a, v: k1_with(a, a.warp_len, v),
        k5=lambda a, v: k5_with(a, a.warp_len, v),
        Y_TOL=Y_TOL, SCIPY_TOL=SCIPY_TOL, HBM=HBM_BYTES_PER_S))
    for rec in record:
        if rec["name"] in dist_out["launches"]:
            rec["launches_dist"] = dist_out["launches"][rec["name"]]
            rec["max_rel_err_dist"] = \
                dist_out["worst_rel_err_vs_plain"][rec["name"]]
            require(rec["launches_dist"] >= 1,
                    f"{rec['name']} not launched on the dist phases")
    emit("memory:dist", max_allocated_gib=torch.cuda.max_memory_allocated()
         / 2 ** 30, seconds_since_start=time.perf_counter() - t_start)

    # ---- 11. the record, the card, the verdict ---------------------------
    print(json.dumps({"kernels": record}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
