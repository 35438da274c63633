#!/usr/bin/env python3
"""Drive the repro_torch port's main path on one CUDA card, at full size.

Builds the hand-written kernels (K1 pJDS spMV, K2 SELL-C-sigma spMV, K3
fused spMV + dots, K4 ELLPACK-R spMV, K5 multi-RHS pJDS, K6 CMRS spMV,
K7 the transpose product, and the fused Krylov loop's scalar step and
vector updates) from
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
The sixth slice runs next (``slice6_phases``): ``transpose:samg`` is
``op.T @ y`` and ``op.T @ Y`` through K7 for pJDS, SELL, ELLPACK-R and
CMRS on sAMG (against the plain version, scipy's float64 A^T y and the
host's plain version bit for bit; beside the forward kernel on
``transpose="device"``'s operand and cuSPARSE on a CSR of A^T; with
K7's mode, index bytes and build times, ``op.T @ y`` less K7 and k = 4
against k = 1), ``grad:samg`` gradients and tangents through the CMRS
operator (a training step's ``with_values`` timed with its K7 index
shared; the x-gradient's backward split into K7, the copy of y, the
``w * g`` pass and an unattributed remainder, beside a
``torch.profiler`` trace of it) and the x-gradient of four
``ThreadComm`` ranks, ``reorder:poisson_shuffled`` RCM on a shuffled
512 x 512 Poisson operator (one device, and four ranks with
``reorder="auto"``), and ``eigen:hmep`` Lanczos, power iteration and
block Lanczos on the symmetrised HMEp analogue at a quarter of its
published 6.2 M rows (1.55 M, so the script ends well inside its
limit).  The seventh (``slice7_phases``) tunes the distributed layer and
serves solves; the eighth (``slice8_phases``) runs last: LM serving at
qwen2.5-14b's full width and depth (``lm:serve:qwen2.5-14b``, the
continuous-batching engine on random bf16 weights) and the sparse FFN on
that model's layer-0 weights (``lm:sparse_ffn:qwen2.5-14b``, K5 on its
split walk held to its plain version, float64 and the dense pruned FFN,
beside its bound, cuBLAS and cuSPARSE; every K5 launch before it took
the lane walk); the ninth (``slice9_phases``) runs last: the other LM
families at their published widths, cut in depth (``GROUP_DEPTH``: 3,
4, 5, 2 + 2 and 4 layers), each freed before the
next -- ``lm:serve:deepseek-moe-16b`` (the engine on a mixture of
experts: a repeated run gives the same tokens, and on a recorded decode
batch the sorted dispatch equals the one-hot one and a float64 loop),
``lm:serve:falcon-mamba-7b`` and ``lm:serve:recurrentgemma-2b`` (Mamba
and RG-LRU: batched equals alone, the chunked-scan prefill equals
streamed decode in float32), ``lm:cross:seamless-m4t-medium`` and
``lm:cross:llava-next-mistral-7b`` (frames through the encoder and
cross-attention, patches prepended: prefill, greedy decode steps,
prefill plus a step against a longer prefill); the tenth
(``slice10_phases``) runs last: LM training through the launcher
``repro_torch.launch.train.main`` -- ``train:minicpm-2b`` (the main
path: published width and depth, bf16, batch 8 x 256, WSD, 8 steps,
a committed checkpoint at the last), then ``train:granite-moe-3b-a800m``
(4 layers), ``train:recurrentgemma-2b`` (one period and its suffix, 5
layers) and ``train:seamless-m4t-medium`` (2 + 2 layers; 8 steps
each, the depth through the launcher's ``--n-layers`` /
``--enc-layers``), each with losses falling, ms a step, MFU / HFU, the step's bound,
the forward+backward / optimizer split and a profiler trace --
``train:resume`` (a 2-layer cut of minicpm-2b resumed from its step-2
checkpoint in fresh objects, bit for bit) and ``train:parity`` (one
train step of three f32 smoke configs, card against CPU); the eleventh
(``slice11_phases``) runs last: the model across cards on one card --
``mesh:one:minicpm-2b`` (the config's train step, published width cut
to 8 layers, on a one-rank NCCL (1, 1) mesh, DTensor params and ZeRO-1 placements,
against the unsharded step: losses within 1e-6 and whether bit for
bit, ms a step of each), ``mesh:one:decode:minicpm-2b`` (its sharded
prefill and 16 decode steps on the same one-rank mesh against the
unsharded ones: logits within 1e-6 and whether bit for bit) and
``lm:parallel_block:llava-next-mistral-7b``
(the parallel residual block at full width: prefill plus 8 decode
steps against a longer prefill, the sequential block's logits apart);
the twelfth (``slice12_phases``) runs last: ``examples:<name>`` (each
of the reference's six examples, ported as ``repro_torch.examples``,
through its ``main`` at the reference's sizes, cg_solver's Poisson
at side 48 (the reference's 96 took 90-107 s), with its own checks: the
products at f32 round-off, Ritz values against ``eigvalsh``, every
solve converged and every request served, a falling loss; K1, K5 and K7
must launch) and ``dryrun:peak`` (the dry run's ``StepRecorder`` on one
real train step of minicpm-2b cut to 4 layers: its peak against
``torch.cuda.max_memory_allocated()``, the ratio within 0.5-1.5; the
dry run's depth plan, the same step at 1, 2 and 3 layers, carried to
4 layers: flops and bytes equal, the peak within 1 % of the
recorder's); last, ``attn_impl_phases``: ``attn:qloop:minicpm-2b``
(the reference's attention switch at published width and depth: a
prefill and two train steps under ``use_attn_impl("pairs")`` and
``"qloop"``, 1024 tokens in chunks of 256; logits, cache and losses
equal bit for bit, ms and peak of each).
``GROUP_SIZES`` and ``GROUP_DEPTH`` hold what ``main`` passes each
group; every cut is in depth, never in width or checks.
Each main-path phase sets every launch count to 0 before it and reads
the counts after it.  Each phase prints one JSON line; any failed check
raises, and the script then exits non-zero without its final line.

    python3 chip_smoke.py

Needs one CUDA card of compute capability >= 9.0, ``nvcc`` and scipy.
It exits non-zero at once when CUDA is absent, and when run from a
directory that does not hold the repository's ``src/repro_torch``.
Every phase line carries ``at_s``, the seconds since the script
started.  The last line is ``{"ok": true, "device": {...}}``; the line
before it is the budget, ``{"budget": {"groups_s": {...}, "total_s",
"limit_s": 1200, "free_s"}}`` (each group's seconds: a new card phase
must fit in ``free_s``, or cut an earlier phase's depth first), before
that ``nvidia-smi``'s name and power limit, and before that the
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
BF16_FLOPS = 989e12              # H100 SXM, bf16 dense on the tensor cores
Y_TOL = 1e-5                     # max |kernel - plain| <= Y_TOL * max|y|
DOT_TOL = 1e-4                   # relative, per dot
SCIPY_TOL = 1e-5                 # max |kernel - f64| <= SCIPY_TOL * max|y|
BURST = 10                       # back-to-back calls per timing sample
# prefill's last logits against the same prompt streamed through decode
# steps, in bf16 at full depth: ||d||_2 <= PREFILL_TOL * ||logits||_2.  The
# two paths round differently in every product and at each of 96 residual
# adds (bf16 keeps 8 bits); a wrong position, mask or cache entry moves
# the logits by the order of their norm.
PREFILL_TOL = 0.1
FFN_TOL = 1e-4                   # sparse FFN (f32) vs dense pruned (f64)
# an MoE layer's sorted dispatch on one recorded 4-slot decode batch, in
# relative L2: against moe_dispatch="onehot" (the same bf16 expert
# products, combined in another order) and against float64 over the same
# kept assignments (bf16 products and intermediates)
MOE_ONEHOT_TOL = 1e-2
MOE_F64_TOL = 3e-2
# the same comparison as PREFILL_TOL's on the recurrent models, made in
# float32 at full width and depth: in bf16 the two paths round apart in
# every one of falcon-mamba's 64 layers and its logits part by ~0.19,
# while float32 keeps them to ~1e-4 (H100 80GB HBM3).
PREFILL_F32_TOL = 1e-3


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """Print one phase's JSON line; ``at_s`` is the seconds since the
    script started, so a phase's cost is the step from the line before."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T_START}), flush=True)


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


def x_backward_trace(step, n=10, top=12) -> dict:
    """``torch.profiler``'s host and device times of ``n`` calls of
    ``step`` (forward plus backward), per call: the operators with the
    most host time, and the totals.  The profiler's own cost inflates
    the host times; their shares are what this reads."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    row = lambda e: {"name": e.key, "count": e.count / n,
                     "host_ms": e.self_cpu_time_total / 1e3 / n,
                     "device_ms": dev_us(e) / 1e3 / n}
    by_host = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)
    # device time once: the kernels' own rows (an operator's row repeats
    # the time of the kernels it launched)
    kernels = [e for e in ev if e.self_cpu_time_total == 0 and dev_us(e)]
    by_dev = sorted(kernels, key=dev_us, reverse=True)
    return {"calls": n,
            "host_ms": sum(e.self_cpu_time_total for e in ev) / 1e3 / n,
            "device_ms": sum(dev_us(e) for e in kernels) / 1e3 / n,
            "kernels_per_call": sum(e.count for e in kernels) / n,
            "top_by_host": [row(e) for e in by_host[:top]],
            "top_by_device": [row(e) for e in by_dev[:top // 2]]}


def slice6_phases(h) -> dict:
    """Transposes, gradients, RCM preprocessing and the eigensolvers on
    the card: ``transpose:samg`` (``op.T @ y`` through K7 for pJDS,
    SELL, ELLPACK-R and CMRS on sAMG, beside the forward kernel on
    ``transpose="device"``'s operand and cuSPARSE on a CSR of A^T),
    ``grad:samg`` (``torch.autograd.grad`` and ``torch.func.jvp``
    through the CMRS operator, and the distributed x-gradient on four
    ranks as threads), ``reorder:poisson_shuffled`` (RCM on a
    symmetrically shuffled ``poisson_2d(side, side)``: single device and
    four ranks) and ``eigen:hmep`` (Lanczos, power iteration and block
    Lanczos on the symmetrised HMEp analogue).  ``h`` carries the card,
    the sAMG matrix with its operands and scipy copy, ``main``'s
    helpers and the sizes (``h.poisson_side``, ``h.hmep_scale``,
    ``h.power_iters``).  Returns K7's record and the launches of the
    other kernels these phases drove."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import repro_torch
    from repro_torch.core import formats as TF
    from repro_torch.core import matrices as TM
    from repro_torch.core import reorder as TRO
    from repro_torch.core import solvers as S
    from repro_torch.core.dist_comm import ThreadComm, run_ranks
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import transpose_spmv as K7
    from repro_torch.kernels.transpose_spmv import \
        transpose_matvec_kernel_call as k7

    dev, m, n = h.dev, h.m, h.m.n_rows
    require, emit, time_ms = h.require, h.emit, h.time_ms
    rng = np.random.default_rng(h.seed + 6)
    kernel_of = {"pjds": "pjds_spmv", "sell": "sell_spmv",
                 "cmrs": "cmrs_spmv", "ellpack_r": "ellr_spmv"}
    k7_launches = 0
    other = {}

    def counted(phase):
        launched, plain_calls = h.counts()
        h.plain_free(plain_calls, phase)
        for k, v in launched.items():
            other[k] = other.get(k, 0) + v
        return launched

    def exact(launched, want, phase):
        """Every kernel launched exactly as ``want`` says, no other."""
        got = {k: v for k, v in launched.items() if v}
        require(got == want, f"{phase}: launched {got}, expected {want}")

    # ---- transpose:samg -- K7 on every blocked format at full size ------
    y_np = rng.standard_normal(n).astype(np.float32)
    y = torch.from_numpy(y_np).to(dev)
    z64 = torch.from_numpy(h.a64.T @ y_np.astype(np.float64))
    Y4 = torch.from_numpy(rng.standard_normal((n, 4)).astype(
        np.float32)).to(dev)
    Z64 = torch.from_numpy(h.a64.T @ Y4.double().cpu().numpy())
    a_t = TF.csr_transpose(m)
    at_csr = h.csr_of(a_t)
    lib_ms = h.library_ms(lambda: torch.mv(at_csr, y),
                          "torch.mv(csr of A^T, y)")
    del at_csr

    def stored(sd):
        """(y in the stored rows' basis -- padded, or scattered to the
        sorted rows -- for the plain version, the plain version on
        tensors ``(val, col, ..., y)``, and the layout metadata bytes of
        the first K7's bound) of operand ``sd``."""
        d = sd.dev
        if sd.fmt in ("sell", "pjds"):
            return (sd._scatter_to_storage(y, d.n_rows_pad),
                    lambda t, v: R.blocked_rmatvec_ref(
                        t["val"], t["col_idx"], t["row_block"], v, n),
                    d.row_block.numel() * 4)
        yp = sd._pad_rows(y, d.n_rows_pad)
        if sd.fmt == "ellpack_r":
            return (yp, lambda t, v: R.ell_rmatvec_ref(
                        t["val"], t["col_idx"], t["rowlen"], v, n), 0)
        return (yp, lambda t, v: R.cmrs_rmatvec_ref(
                    t["val"], t["col_idx"], t["row_in_strip"],
                    t["strip_map"], v, n),
                d.strip_map.numel() * 4 + int(sd.slot_index()[0].numel()))

    def timed_build(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def nbytes(*ts):
        return sum(t.untyped_storage().nbytes() for t in ts if t is not None)

    per_fmt, worst = {}, (0.0, 0.0)
    for fmt, op in (("pjds", h.op_p), ("sell", h.op_s),
                    ("ellpack_r", h.op_e), ("cmrs", h.op_c)):
        sd, d = op.dev, op.dev.dev
        (slot, colptr), t_index = timed_build(sd.slot_index)
        rows, t_rows = timed_build(sd.slot_rows)
        plan1, t_plan1 = timed_build(lambda: sd.tile_plan(1))
        plan4, t_plan4 = timed_build(lambda: sd.tile_plan(4))
        mode = {k: "staged" if K7.staged(k) else "walked" for k in (1, 4)}
        width = d.n_rows_pad if fmt == "ellpack_r" else d.b_r
        h.reset_counts()
        z = op.T @ y
        exact(counted(f"transpose:samg:{fmt}"), {"transpose_spmv": 1},
              f"transpose:samg:{fmt}")
        k7_launches += 1
        require(torch.equal(z, op.T @ y),
                f"transpose:samg:{fmt}: K7 does not repeat bit for bit")
        ys, plain, meta = stored(sd)
        tens = {f: getattr(d, f) for f in ("val", "col_idx", "row_block",
                                           "rowlen", "row_in_strip",
                                           "strip_map") if hasattr(d, f)}
        run_k7 = lambda v: k7(d.val, slot, colptr, v, n_rows=n, width=width,
                              rows=rows, plan=plan1 if v.dim() == 1
                              else plan4, longest=sd.longest_column())
        z_k = run_k7(y)
        require(torch.equal(z_k, z), f"transpose:samg:{fmt}: op.T @ y is "
                f"not K7's z")
        e_abs, e_rel = h.rel_err(z_k, plain(tens, ys))
        s_abs, s_rel = h.rel_err(z, z64)
        require(e_rel <= h.Y_TOL, f"transpose:samg:{fmt} K7 vs plain: "
                f"{e_rel}")
        require(s_rel <= h.SCIPY_TOL, f"transpose:samg:{fmt} vs scipy f64: "
                f"{s_rel}")
        require(tuple(z.shape) == (n,) and bool(torch.isfinite(z).all()),
                f"transpose:samg:{fmt}: bad output")
        if e_rel > worst[1]:
            worst = (e_abs, e_rel)
        # the plain version on the host adds in the slot order XLA's CPU
        # segment_sum adds in: K7 must give its bits
        z_cpu = plain({f: t.cpu() for f, t in tens.items()}, ys.cpu())
        require(torch.equal(z_k.cpu(), z_cpu), f"transpose:samg:{fmt}: K7 "
                f"is not the host plain version bit for bit")
        # a block of right-hand sides, k = 4
        h.reset_counts()
        Z = op.T @ Y4
        exact(counted(f"transpose:samg:{fmt} k=4"), {"transpose_spmv": 1},
              f"transpose:samg:{fmt} k=4")
        k7_launches += 1
        _, sk_rel = h.rel_err(Z, Z64)
        require(sk_rel <= h.SCIPY_TOL, f"transpose:samg:{fmt} k=4 vs scipy "
                f"f64: {sk_rel}")
        require(torch.equal(Z, op.T @ Y4), f"transpose:samg:{fmt} k=4: K7 "
                f"does not repeat bit for bit")
        # transpose="device": A^T's operand through the forward kernel
        t0 = time.perf_counter()
        op_td = repro_torch.operator(m, fmt, transpose="device", device=dev)
        t_tdev = time.perf_counter() - t0
        h.reset_counts()
        z_td = op_td.T @ y
        exact(counted(f"transpose:samg:{fmt} transpose=device"),
              {kernel_of[fmt]: 1}, f"transpose:samg:{fmt} transpose=device")
        _, td_rel = h.rel_err(z_td, z64)
        require(td_rel <= h.SCIPY_TOL, f"transpose:samg:{fmt} "
                f"transpose=device vs scipy f64: {td_rel}")
        td_ms = time_ms(lambda: op_td.T @ y)[0]
        t_vals = op_td.t_dev.values
        td_bytes = sum(t.numel() * t.element_size()
                       for t in vars(op_td.t_dev.dev).values()
                       if isinstance(t, torch.Tensor))
        del op_td, z_td, t_vals
        k_ms = time_ms(lambda: run_k7(y))
        k4_kernel_ms = time_ms(lambda: run_k7(Y4))
        single_ms = time_ms(lambda: run_k7(y), burst=1)[0]
        p_ms = time_ms(lambda: plain(tens, ys), reps=20, warm=2, burst=1)[0]
        op_ms = time_ms(lambda: op.T @ y)[0]
        k4_ms = time_ms(lambda: op.T @ Y4)[0]
        nnz = slot.numel()
        # the first K7's bound: the slot index, values, column pointer, y
        # at the stored row count, z and the layout's metadata; the
        # stored rows and the plan are reported beside it, not folded in
        nbytes_ = float(nnz * (4 + d.val.element_size()) + 4 * (n + 1)
                        + 4 * d.n_rows_pad + 4 * n + meta)
        extra = float(0 if rows is None else 4 * nnz)
        index_bytes = nbytes(slot, colptr)
        fwd_bytes = sum(t.numel() * t.element_size()
                        for t in vars(d).values()
                        if isinstance(t, torch.Tensor))
        per_fmt[fmt] = {
            "k7_ms": k_ms[0], "k7_ms_q25_q75": list(k_ms[1:]),
            "k7_launch_ms": single_ms,
            "k7_k4_ms": k4_kernel_ms[0],
            "k7_k4_ms_q25_q75": list(k4_kernel_ms[1:]),
            "k4_over_k1": k4_kernel_ms[0] / k_ms[0],
            "operator_T_ms": op_ms, "operator_T_k4_ms": k4_ms,
            "operator_T_minus_k7_ms": op_ms - k_ms[0],
            "operator_T_k4_minus_k7_ms": k4_ms - k4_kernel_ms[0],
            "plain_ms": p_ms, "bytes": nbytes_,
            "bound_ms": 1e3 * nbytes_ / h.HBM,
            "share_of_bound": 1e3 * nbytes_ / h.HBM / k_ms[0],
            "stored_rows_bytes": extra,
            "bound_with_stored_rows_ms": 1e3 * (nbytes_ + extra) / h.HBM,
            "max_abs_err_vs_plain": e_abs, "max_rel_err_vs_plain": e_rel,
            "max_rel_err_vs_scipy_f64": s_rel, "k4_rel_err_vs_scipy_f64":
            sk_rel, "bit_equal_to_cpu_plain": True,
            "slot_index_build_s": t_index, "slot_index_bytes": index_bytes,
            "slot_index_bytes_per_nnz": index_bytes / nnz,
            "slot_rows_build_s": t_rows,
            "slot_rows_bytes": nbytes(rows),
            "slot_rows_bytes_per_nnz": nbytes(rows) / nnz,
            "mode": {f"k={k}": v for k, v in mode.items()},
            "tile_slots": {f"k={k}": K7.tile_slots(k) for k in mode},
            "buffer_slots": {f"k={k}": K7.buffer_slots(
                k, sd.longest_column()) for k in mode},
            "longest_column": sd.longest_column(),
            "tile_plan_build_s": {"k=1": t_plan1, "k=4": t_plan4},
            "tile_plan_bytes": {"k=1": nbytes(plan1), "k=4": nbytes(plan4)},
            "tiles": {"k=1": plan1.numel() - 1, "k=4": plan4.numel() - 1},
            "index_bytes_per_nnz_total": nbytes(
                slot, colptr, rows, *{id(q): q for q in (plan1, plan4)}
                .values()) / nnz,
            "operand_bytes": fwd_bytes,
            "transpose_device_build_s": t_tdev,
            "transpose_device_ms": td_ms,
            "transpose_device_bytes": td_bytes,
            "transpose_device_rel_err_vs_scipy_f64": td_rel}
    emit("transpose:samg", n_rows=n, nnz=m.nnz, library_ms=lib_ms,
         library_call="torch.mv(csr of A^T, y)",
         tile_bytes=K7.TILE_BYTES, stage_cols=K7.STAGE_COLS,
         long_slots=K7.LONG_SLOTS, tile_cols=K7.TILE_COLS,
         per_format=per_fmt)
    k7_rec = {"name": "transpose_spmv", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/transpose_spmv.cu",
              "replaces": "src/repro/kernels/ref.py:108",
              "max_abs_err": worst[0], "max_rel_err": worst[1],
              "ms": per_fmt["cmrs"]["k7_ms"],
              "ms_q25_q75": per_fmt["cmrs"]["k7_ms_q25_q75"],
              "samples": 30, "launch_ms": per_fmt["cmrs"]["k7_launch_ms"],
              "plain_ms": per_fmt["cmrs"]["plain_ms"],
              "bound_ms": per_fmt["cmrs"]["bound_ms"], "bound_by": "bytes",
              "library_ms": lib_ms, "bytes": per_fmt["cmrs"]["bytes"],
              "operand": "cmrs (the format operator(m) picks on sAMG)"}

    # ---- grad:samg -- autograd and jvp through the CMRS operator ------
    op = h.op_c
    x = torch.from_numpy(h.x_np).to(dev)
    w = y
    v = op.values.clone().requires_grad_()
    xg = x.clone().requires_grad_()
    h.reset_counts()
    gv, gx = torch.autograd.grad((w * (op.with_values(v) @ xg)).sum(),
                                 (v, xg))
    kern_c = kernel_of[op.fmt]
    exact(counted("grad:samg"), {kern_c: 1, "transpose_spmv": 1},
          "grad:samg")
    k7_launches += 1
    require(torch.equal(gx, op.T @ w),
            "grad:samg: the x-gradient is not K7's A^T w bit for bit")
    # the value gradient's plain version, in float64: w at each slot's
    # row (0 for a padded row) times x at its column
    d = op.dev.dev
    if op.fmt == "cmrs":
        rows = d.strip_map.long()[:, None] * d.b_r + d.row_in_strip.long()
    else:
        lane = torch.arange(d.b_r, device=dev)[None, :]
        rows = op.dev.row_map().long()[d.row_block.long()[:, None] * d.b_r
                                       + lane]
        rows = torch.where(rows < 0, n, rows)
    w_ext = torch.cat([w.double(), w.new_zeros(1, dtype=torch.float64)])
    gv_plain = w_ext[rows.clamp(max=n)] * x.double()[d.col_idx.long()]
    gv_abs, gv_rel = h.rel_err(gv, gv_plain)
    require(gv_rel <= h.Y_TOL, f"grad:samg: value gradient vs plain "
            f"{gv_rel}")
    g = torch.Generator(device=dev).manual_seed(h.seed)
    dv = torch.randn(tuple(op.values.shape), device=dev, generator=g)
    dx = torch.randn(n, device=dev, generator=g)
    h.reset_counts()
    yj, tj = torch.func.jvp(lambda vv, xx: op.with_values(vv) @ xx,
                            (op.values, x), (dv, dx))
    exact(counted("grad:samg jvp"), {kern_c: 3}, "grad:samg jvp")
    require(torch.equal(tj, op.with_values(dv) @ x + op @ dx),
            "grad:samg: the tangent is not A(v') x + A x'")
    _, yj_rel = h.rel_err(yj, torch.from_numpy(h.y64))
    require(yj_rel <= h.SCIPY_TOL, f"grad:samg jvp primal vs scipy {yj_rel}")
    # times: the product alone, recorded for autograd, and forward plus
    # backward (both gradients; the x-gradient alone)
    op_v = op.with_values(v)
    require(op_v.dev.slot_index() is op.dev.slot_index(),
            "grad:samg: new values on the same non-zeros rebuilt K7's index")
    fwd = time_ms(lambda: op @ x)
    fwd_b = time_ms(lambda: op_v @ xg, reps=20)
    fb = time_ms(lambda: torch.autograd.grad((w * (op_v @ xg)).sum(),
                                             (v, xg)), reps=20)
    # a training step's with_values: a new operand each step, which
    # compares its padding mask with the base's and shares K7's arrays
    fb_step = time_ms(lambda: torch.autograd.grad(
        (w * (op.with_values(v) @ xg)).sum(), (v, xg)), reps=20)
    with_values_ms = time_ms(lambda: op.with_values(v), reps=20)
    with_values_index_ms = time_ms(
        lambda: op.with_values(v).dev.slot_index(), reps=20)
    fbx = time_ms(lambda: torch.autograd.grad((w * (op @ xg)).sum(), xg),
                  reps=20)
    del op_v
    # the x-gradient's backward in pieces, each timed with CUDA events in
    # this call: its recorded forward, K7 alone, op.T @ w (K7 plus what
    # the operator does around it: before this slice, a copy of y), the
    # w * g pass of the product's backward; what is left is a remainder
    # of medians timed apart, attributed by no measurement (the host
    # trace below lists the operators the backward runs)
    fwd_x = time_ms(lambda: (w * (op @ xg)).sum(), reps=20)
    ones = torch.ones_like(w)
    mul_ms = time_ms(lambda: w * ones)[0]
    k7_c, op_t_c = per_fmt[op.fmt]["k7_ms"], per_fmt[op.fmt]["operator_T_ms"]
    bwd_x = fbx[0] - fwd_x[0]
    x_split = {"forward_recorded_ms": fwd_x[0], "backward_ms": bwd_x,
               "k7_ms": k7_c, "copy_and_dispatch_ms": op_t_c - k7_c,
               "w_times_g_ms": mul_ms,
               "unattributed_ms": bwd_x - op_t_c - mul_ms}
    x_trace = x_backward_trace(
        lambda: torch.autograd.grad((w * (op @ xg)).sum(), xg))
    # four ranks as threads: the x-gradient through the transpose
    # partition, against the single-device one
    comms = ThreadComm.create(4, dev)
    t0 = time.perf_counter()
    ops4 = run_ranks(comms, lambda c: repro_torch.dist_operator(
        m, c, device=dev))
    t_part = time.perf_counter() - t0

    def dist_grad(c):
        opd = ops4[c.rank]
        xl = opd.shard_vector(h.x_np).requires_grad_()
        wl = opd.shard_vector(y_np)
        (gl,) = torch.autograd.grad((wl * (opd @ xl)).sum(), xl)
        require(torch.equal(gl, opd.rmatvec(wl)),
                "grad:samg dist: the x-gradient is not A^T w")
        return opd.gather_vector(gl)

    h.reset_counts()
    gd = run_ranks(comms, dist_grad)
    launched_d = counted("grad:samg dist")
    require(launched_d["pjds_spmv"] >= 4 * 3,
            f"grad:samg dist: K1 launched {launched_d['pjds_spmv']}")
    require(all(torch.equal(t, gd[0]) for t in gd),
            "grad:samg dist: the ranks disagree")
    _, gd_rel = h.rel_err(gd[0][:n], gx)
    require(gd_rel <= h.Y_TOL, f"grad:samg dist vs single device {gd_rel}")
    del ops4, gd
    emit("grad:samg", operand=op.fmt, launches={
             kern_c: 1, "transpose_spmv": 1},
         x_grad_equal_to_k7=True, value_grad_rel_err_vs_plain=gv_rel,
         value_grad_abs_err_vs_plain=gv_abs, jvp_tangent_exact=True,
         forward_ms=fwd[0], forward_ms_q25_q75=list(fwd[1:]),
         forward_recorded_ms=fwd_b[0], forward_backward_ms=fb[0],
         forward_backward_ms_q25_q75=list(fb[1:]),
         forward_backward_x_only_ms=fbx[0],
         forward_backward_x_only_ms_q25_q75=list(fbx[1:]),
         forward_backward_with_values_each_step_ms=fb_step[0],
         forward_backward_with_values_each_step_ms_q25_q75=list(
             fb_step[1:]),
         with_values_ms=with_values_ms[0],
         with_values_and_shared_index_ms=with_values_index_ms[0],
         x_only_split=x_split, x_only_host_trace=x_trace,
         backward_over_forward=(fb[0] - fwd_b[0]) / fwd[0],
         dist={"ranks": 4, "comm": "ThreadComm on one card",
               "partition_s": t_part, "rel_err_vs_single_device": gd_rel,
               "launches": launched_d})

    # ---- reorder:poisson_shuffled -- RCM, single device and 4 ranks ----
    side = h.poisson_side
    t0 = time.perf_counter()
    mp = TM.poisson_2d(side, side)
    np_ = mp.n_rows
    ms = TRO.permute_symmetric(mp, np.random.default_rng(h.seed).permutation(
        np_))
    t_gen = time.perf_counter() - t0
    del mp
    # operator(ms, reorder="rcm") runs preprocess(reorder="rcm"), which
    # runs the RCM search: both are timed (and the outcome kept) while
    # the operator is built
    spent = {}
    rcm, pre = TRO.rcm_permutation, TRO.preprocess

    def timed(key, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            spent[key] = (time.perf_counter() - t, out)
            return out
        return call

    TRO.rcm_permutation = timed("rcm", rcm)
    TRO.preprocess = timed("preprocess", pre)
    try:
        t0 = time.perf_counter()
        op_r = repro_torch.operator(ms, reorder="rcm", device=dev)
        t_build_r = time.perf_counter() - t0
    finally:
        TRO.rcm_permutation, TRO.preprocess = rcm, pre
    t_pre, pp = spent["preprocess"]
    t0 = time.perf_counter()
    op_0 = repro_torch.operator(ms, device=dev)
    t_build_0 = time.perf_counter() - t0
    require(op_r.dev.pre_perm is not None and op_0.dev.pre_perm is None,
            "reorder:poisson_shuffled: the permutation is not recorded")
    xi_np = rng.integers(-3, 4, size=np_).astype(np.float32)
    xi = torch.from_numpy(xi_np).to(dev)
    h.reset_counts()
    y_r = op_r @ xi
    exact(counted("reorder:poisson_shuffled"), {kernel_of[op_r.fmt]: 1},
          "reorder:poisson_shuffled")
    y_0 = op_0 @ xi
    require(torch.equal(y_r, y_0), "reorder:poisson_shuffled: y differs "
            "from the unreordered operator's")
    a_s = sp.csr_matrix((ms.data, ms.indices, ms.indptr), shape=ms.shape)
    require(np.array_equal(y_r.cpu().numpy(), (a_s @ xi_np.astype(
        np.float64)).astype(np.float32)),
        "reorder:poisson_shuffled: y differs from scipy's (integer data)")
    sd_r = op_r.dev
    xs = sd_r._into_stored(xi)
    ys_r = sd_r._matvec_stored(xs, "auto")
    t_r = time_ms(lambda: op_r @ xi)
    t_0 = time_ms(lambda: op_0 @ xi)
    t_st = time_ms(lambda: sd_r._matvec_stored(xs, "auto"))
    t_sw = time_ms(lambda: (sd_r._into_stored(xi),
                            sd_r._out_of_stored(ys_r)))
    del ys_r, xs
    # four ranks as threads: reorder="auto" must apply RCM and cut the
    # halo; the gathered y equals the unreordered partition's bit for bit
    comms = ThreadComm.create(4, dev)
    t0 = time.perf_counter()
    ops_a = run_ranks(comms, lambda c: repro_torch.dist_operator(
        ms, c, reorder="auto", transpose=None, device=dev))
    t_part_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops_0 = run_ranks(comms, lambda c: repro_torch.dist_operator(
        ms, c, transpose=None, device=dev))
    t_part_0 = time.perf_counter() - t0
    h.reset_counts()
    ya = run_ranks(comms, lambda c: ops_a[c.rank].gather_vector(
        ops_a[c.rank] @ ops_a[c.rank].shard_vector(xi_np)))
    launched_a = counted("reorder:poisson_shuffled dist")
    y0 = run_ranks(comms, lambda c: ops_0[c.rank].gather_vector(
        ops_0[c.rank] @ ops_0[c.rank].shard_vector(xi_np)))
    on = ops_a[0].dist.comm_bytes_per_device(value_bytes=4)
    off = ops_0[0].dist.comm_bytes_per_device(value_bytes=4)
    require(ops_a[0].pre_perm is not None,
            "reorder:poisson_shuffled dist: reorder='auto' did not apply")
    require(on * 10 <= off, f"reorder:poisson_shuffled dist: "
            f"comm bytes {on} against {off}")
    require(all(torch.equal(a, b) for a, b in zip(ya, y0))
            and torch.equal(ya[0][:np_], y_0),
            "reorder:poisson_shuffled dist: gathered y differs")
    emit("reorder:poisson_shuffled", n_rows=np_, nnz=ms.nnz,
         generate_and_shuffle_s=t_gen, preprocess_s=t_pre,
         rcm_s=spent["rcm"][0], bandwidth_before=pp.bandwidth_before,
         bandwidth_after=pp.bandwidth_after, reason=pp.reason,
         build_reordered_s=t_build_r, build_plain_s=t_build_0,
         applied=pp.applied,
         format=op_r.fmt, y_equal=True, y_equal_to_scipy=True,
         reordered_ms=t_r[0], reordered_ms_q25_q75=list(t_r[1:]),
         plain_ms=t_0[0], plain_ms_q25_q75=list(t_0[1:]),
         stored_product_ms=t_st[0], sandwich_ms=t_sw[0],
         dist={"ranks": 4, "reorder": "auto", "applied": True,
               "partition_auto_s": t_part_a, "partition_plain_s": t_part_0,
               "comm_bytes_per_device": on,
               "comm_bytes_per_device_plain": off,
               "halo_w": ops_a[0].dist.halo_w,
               "halo_w_plain": ops_0[0].dist.halo_w,
               "gathered_y_equal": True, "launches": launched_a})
    del ops_a, ops_0, op_r, op_0, ms, a_s, ya, y0

    # ---- eigen:hmep -- the paper's motivating workload -----------------
    t0 = time.perf_counter()
    raw = TM.hmep(scale=h.hmep_scale)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    a_r = sp.csr_matrix((raw.data, raw.indices, raw.indptr), shape=raw.shape)
    del raw
    hs = ((a_r + a_r.T) * 0.5).tocsr()
    del a_r
    hs.sort_indices()
    hm = TF.CSRMatrix(hs.indptr.astype(np.int64), hs.indices.astype(
        np.int32), hs.data.astype(np.float32), hs.shape)
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    op_h = repro_torch.operator(hm, device=dev)
    t_build = time.perf_counter() - t0
    nh = hm.n_rows
    kern = kernel_of[op_h.fmt]
    v0 = torch.from_numpy(rng.standard_normal(nh).astype(np.float32)).to(dev)
    S.lanczos(op_h, v0, m=2)                       # warm-up (cuBLAS)
    h.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lz = S.lanczos(op_h, v0, m=100)
    t_lz = time.perf_counter() - t0
    exact(counted("eigen:hmep lanczos"), {kern: 100}, "eigen:hmep lanczos")
    ritz = S.tridiag_eigvals(*lz)
    require(lz.info["host_syncs"] == 1 and bool(np.isfinite(ritz).all()),
            f"eigen:hmep lanczos: {lz.info}")
    # the plain versions on the same card operand: the first 20 alphas
    sd, dh = op_h.dev, op_h.dev.dev
    if op_h.fmt == "sell":
        plain = lambda u: R.sell_matvec_ref(
            dh.val, dh.col_idx, dh.row_block, dh.inv_perm, u,
            dh.n_blocks)[:nh]
    elif op_h.fmt == "pjds":
        plain = lambda u: R.pjds_matvec_ref(
            dh.val, dh.col_idx, dh.row_block, u, dh.n_blocks).index_select(
            0, sd.inv_perm)
    elif op_h.fmt == "cmrs":
        plain = lambda u: R.cmrs_matvec_ref(
            dh.val, dh.col_idx, dh.row_in_strip, dh.strip_map, u,
            dh.n_strips)[:nh]
    else:
        plain = lambda u: R.ell_matvec_ref(dh.val, dh.col_idx, dh.rowlen,
                                           u)[:nh]
    lp = S.lanczos(plain, v0, m=20)
    al_err = float((lz[0][:20] - lp[0]).abs().max() / lp[0].abs().max())
    be_err = float((lz[1][:20] - lp[1]).abs().max() / lp[1].abs().max())
    require(al_err <= 1e-4, f"eigen:hmep: alphas vs plain {al_err}")
    # power iteration on A - sigma I (sigma the smallest Ritz value): A's
    # two extremes are close in magnitude, so the shift makes the
    # largest one dominant
    sigma = float(ritz.min())
    h.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pw = S.power_iteration(lambda u: op_h @ u - sigma * u, v0,
                           iters=h.power_iters)
    t_pw = time.perf_counter() - t0
    exact(counted("eigen:hmep power"), {kern: h.power_iters},
          "eigen:hmep power")
    lam = float(pw[1]) + sigma
    lam_err = abs(lam - float(ritz.max())) / abs(float(ritz.max()))
    require(lam_err <= 1e-3, f"eigen:hmep: power iteration {lam} against "
            f"the largest Ritz value {ritz.max()}")
    V0 = torch.from_numpy(rng.standard_normal((nh, 4)).astype(
        np.float32)).to(dev)
    S.block_lanczos(op_h, V0, m=2)                 # warm-up (cuSOLVER)
    h.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bl = S.block_lanczos(op_h, V0, m=25)
    t_bl = time.perf_counter() - t0
    want_b = ({"pjds_spmm": 25} if op_h.fmt in ("sell", "pjds")
              else {kern: 100})
    exact(counted("eigen:hmep block_lanczos"), want_b,
          "eigen:hmep block_lanczos")
    bev = S.block_tridiag_eigvals(*bl)
    require(bl.info["host_syncs"] == 1 and bool(np.isfinite(bev).all()),
            f"eigen:hmep block_lanczos: {bl.info}")
    emit("eigen:hmep", n_rows=nh, nnz_raw=int(hs.nnz), nnz=hm.nnz,
         n_nzr=hm.n_nzr, format=op_h.fmt, stored_elements=int(
             sd.storage_elements()), operand_bytes=sum(
             t.numel() * t.element_size() for t in vars(dh).values()
             if isinstance(t, torch.Tensor)),
         generate_s=t_gen, symmetrise_s=t_sym, build_s=t_build,
         lanczos={"m": 100, "seconds": t_lz, "ms_per_step": 1e3 * t_lz / 100,
                  "host_syncs": lz.info["host_syncs"],
                  "launches": {kern: 100},
                  "ritz_min": float(ritz.min()), "ritz_max": float(ritz.max()),
                  "alphas_rel_err_vs_plain_20": al_err,
                  "betas_rel_err_vs_plain_20": be_err},
         power_iteration={"iters": h.power_iters, "shift": sigma,
                          "seconds": t_pw,
                          "ms_per_step": 1e3 * t_pw / h.power_iters,
                          "host_syncs": pw.info["host_syncs"], "lambda": lam,
                          "rel_err_vs_ritz_max": lam_err},
         block_lanczos={"k": 4, "m": 25, "seconds": t_bl,
                        "ms_per_step": 1e3 * t_bl / 25,
                        "host_syncs": bl.info["host_syncs"],
                        "launches": want_b, "ritz_min": float(bev.min()),
                        "ritz_max": float(bev.max())})
    del op_h, hm, hs
    k7_rec["launches"] = k7_launches
    return {"k7": k7_rec, "launches": other}


def slice7_phases(h) -> dict:
    """The distributed tuner and solve serving on the card.

    ``dist:tune:samg``: ``tune_partition(m, 4)`` on the sAMG matrix
    without a communicator (the chunk sweep of the straggler's local
    and remote operands, K1), then again: a cache hit with no launch.
    ``dist:tune:sweep``: four ``ThreadComm`` ranks on the one card run
    ``dist_operator(m, comm, tune="auto", grid="auto", halo="auto",
    mode="auto")`` on ``samg(h.sweep_scale)`` -- the chunk sweeps of A
    and A^T and the communication sweep over every candidate -- with
    one pick on every rank and y against scipy; the link model is fit
    to the sweep's rows, which on one card time the threads' hand-over,
    not a link.  ``serve:samg``: an ``OperatorRegistry(tune="auto")``
    with two tenants (sAMG and ``poisson_2d(h.poisson_side, ...)``),
    seeded requests through ``SolveScheduler(slots=4)`` and again
    through ``slots=1`` (one of them non-finite: rejected; one with an
    expired deadline: shed; every other converged and checked against
    scipy in float64), a warm admit in a second registry that measures
    nothing, a value swap of the Poisson tenant through the value map,
    and the block product ``op @ X`` (k = 4) of sAMG's tuned layout
    beside a SELL admit of the same matrix (K5).  Returns the launches
    these phases made."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch import tune as T
    from repro_torch.core import matrices as TM
    from repro_torch.core import perf_model as TPM
    from repro_torch.core.dist_comm import ThreadComm, run_ranks
    from repro_torch.core.operator import dist_operator
    from repro_torch.serve import (OperatorRegistry, SolveRequest,
                                   SolveScheduler)
    from repro_torch.tune import measure as TME

    dev, m, n, a64 = h.dev, h.m, h.m.n_rows, h.a64
    require, emit, time_ms = h.require, h.emit, h.time_ms
    launches = {}
    tdir = tempfile.TemporaryDirectory(prefix="chip_smoke_slice7_")
    tpath = pathlib.Path(tdir.name)

    def counted(phase):
        launched, plain_calls = h.counts()
        h.plain_free(plain_calls, phase)
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
        return {k: v for k, v in launched.items() if v}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def row_ms(r):
        return {**{k: r[k] for k in r if k not in ("measured_s", "rank_s",
                                                    "group")},
                "ms": 1e3 * r["measured_s"],
                **({"rank_ms": [1e3 * v for v in r["rank_s"]]}
                   if "rank_s" in r else {})}

    # ---- dist:tune:samg -- the chunk sweep at the paper's size --------
    cache = T.TuneCache(tpath / "partition.json")
    h.reset_counts()
    t0 = time.perf_counter()
    tp = T.tune_partition(m, 4, cache=cache, device=dev)
    t_cold = time.perf_counter() - t0
    launched_cold = counted("dist:tune:samg")
    require(launched_cold.get("pjds_spmv", 0) >= 6 and not tp.cached,
            f"dist:tune:samg: K1 not launched per candidate: "
            f"{launched_cold}")
    h.reset_counts()
    t0 = time.perf_counter()
    tp_hit = T.tune_partition(m, 4, cache=cache, device=dev)
    t_hit = time.perf_counter() - t0
    launched_hit = counted("dist:tune:samg hit")
    require(tp_hit.cached and not launched_hit
            and (tp_hit.chunk_l, tp_hit.rem_chunk_l)
            == (tp.chunk_l, tp.rem_chunk_l),
            f"dist:tune:samg: the second call measured: {launched_hit}")
    emit("dist:tune:samg", n_rows=n, nnz=m.nnz, n_dev=4,
         rows=[row_ms(r) for r in tp.rows],
         picks={"chunk_l": tp.chunk_l, "rem_chunk_l": tp.rem_chunk_l},
         seconds_cold=t_cold, host_s=tp.phase_s,
         host_s_rest=t_cold - sum(tp.phase_s.values()),
         seconds_hit=t_hit, launches_cold=launched_cold,
         launches_hit=launched_hit)

    # ---- dist:tune:sweep -- four ranks on the card, collective picks --
    ms = TM.samg(scale=h.sweep_scale)
    a_ms = sp.csr_matrix((ms.data, ms.indices, ms.indptr), shape=ms.shape)
    rng = np.random.default_rng(h.seed + 7)
    x_ms = rng.standard_normal(ms.n_rows).astype(np.float32)
    y64 = a_ms @ x_ms.astype(np.float64)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(tpath / "sweep.json")
    comms = ThreadComm.create(4, dev)

    def tuned(c):
        t0 = time.perf_counter()
        op = dist_operator(ms, c, tune="auto", grid="auto", halo="auto",
                           mode="auto", device=dev)
        t_op = time.perf_counter() - t0
        y = op.gather_vector(op.matvec(op.shard_vector(x_ms)))
        return op, t_op, y.cpu()

    h.reset_counts()
    out = run_ranks(comms, tuned)
    launched_sweep = counted("dist:tune:sweep")
    picks = [(o.mode, o.halo, o.dist.grid, o.dist.chunk_l,
              o.dist.rem_chunk_l_eff, o.t_dist.chunk_l,
              o.t_dist.rem_chunk_l_eff) for o, _, _ in out]
    require(len(set(picks)) == 1, f"dist:tune:sweep: ranks differ {picks}")
    require(all(o.dist is out[0][0].dist for o, _, _ in out),
            "dist:tune:sweep: the ranks built different partitions")
    err = float(np.abs(out[0][2].double().numpy()[:ms.n_rows] - y64).max()
                / np.abs(y64).max())
    require(err <= h.SCIPY_TOL, f"dist:tune:sweep: y vs scipy {err}")
    require(launched_sweep.get("pjds_spmv", 0) >= 1,
            f"dist:tune:sweep: K1 not launched: {launched_sweep}")
    h.reset_counts()
    recs = run_ranks(comms, lambda c: T.tune_partition(ms, 4, comm=c,
                                                       device=dev))
    launched_rec = counted("dist:tune:sweep record")
    require(all(r.cached for r in recs) and not launched_rec,
            f"dist:tune:sweep: the record's read measured: {launched_rec}")
    comm_rows = [r for r in recs[0].rows if r["operand"] == "comm"]
    require(len(comm_rows) == len(T.dist_candidates(4)),
            "dist:tune:sweep: a candidate has no row")
    win = min(comm_rows, key=lambda r: r["measured_s"])
    op0 = out[0][0]
    require((win["halo"], win["mode"],
             tuple(win["grid"]) if win["grid"] else None)
            == (op0.halo, op0.mode, op0.dist.grid),
            "dist:tune:sweep: the operator does not run the measured pick")
    cal = T.fit_link_calibration(comm_rows, source="one card, ThreadComm")
    emit("dist:tune:sweep", n_rows=ms.n_rows, nnz=ms.nnz, ranks=4,
         note="ThreadComm: four ranks as threads on one card, so no "
              "message crosses a link; the fit times the hand-over "
              "between threads, not a link",
         pick={"mode": op0.mode, "halo": op0.halo, "grid": op0.dist.grid,
               "chunk_l": op0.dist.chunk_l,
               "rem_chunk_l": op0.dist.rem_chunk_l_eff,
               "transpose_chunk_l": op0.t_dist.chunk_l,
               "transpose_rem_chunk_l": op0.t_dist.rem_chunk_l_eff},
         same_pick_all_ranks=True,
         rows=[row_ms(r) for r in recs[0].rows],
         dist_operator_s=[t for _, t, _ in out],
         max_rel_err_vs_scipy_f64=err,
         link_fit_one_card={
             "msg_overhead_s": cal.msg_overhead_s,
             "link_bw_scale": cal.link_bw_scale,
             "link_model_error_before": T.link_model_error(comm_rows),
             "link_model_error_after": T.link_model_error(comm_rows, cal)},
         choose_halo_uncalibrated=TPM.choose_halo(
             op0.dist, mode=op0.mode, calibration=None),
         launches=launched_sweep)
    del out, recs, comms

    # ---- serve:samg -- two tenants, tuned admission, batched groups ----
    spent = {"measure": 0, "ab_compare": 0}
    undo = []
    for attr, key in (("measure_candidate", "measure"),
                      ("ab_compare", "ab_compare")):
        orig = getattr(TME, attr)

        def wrapped(*a, _orig=orig, _key=key, **kw):
            spent[_key] += 1
            return _orig(*a, **kw)
        setattr(TME, attr, wrapped)
        undo.append((attr, orig))
    try:
        mp = TM.poisson_2d(h.poisson_side, h.poisson_side)
        a_p = sp.csr_matrix((mp.data, mp.indices, mp.indptr), shape=mp.shape)
        scache = tpath / "serve.json"
        reg = OperatorRegistry(tune="auto", cache=T.TuneCache(scache),
                               device=dev)
        admit_s, ents = {}, {}
        h.reset_counts()
        for name, mat in (("samg", m), ("poisson", mp)):
            t0 = time.perf_counter()
            ents[name] = reg.admit(mat)
            sync()
            admit_s[name] = time.perf_counter() - t0
        counted("serve:samg admit")
        cold_measure = dict(spent)
        e_s, e_p = ents["samg"], ents["poisson"]
        require(cold_measure["measure"] > 0
                and not e_s.tune_info["cached"]
                and not e_p.tune_info["cached"],
                "serve:samg: the cold admit measured nothing")

        tol, slack = h.serve_tol, 10.0
        brng = np.random.default_rng(h.seed + 8)
        plan = [("samg", e_s)] * (h.n_requests // 2) + \
            [("poisson", e_p)] * (h.n_requests - h.n_requests // 2)
        rhs = [brng.standard_normal(e.shape[0]).astype(np.float32)
               for _, e in plan]
        bad = brng.standard_normal(n).astype(np.float32)
        bad[7] = np.nan

        def serve(slots):
            sched = SolveScheduler(reg, slots=slots, maxiter=h.maxiter,
                                   tol=tol, cert_slack=slack)
            reqs = [SolveRequest(rid=i, b=b, tenant=e.key)
                    for i, ((_, e), b) in enumerate(zip(plan, rhs))]
            rej = SolveRequest(rid=len(reqs), b=bad, tenant=e_s.key)
            shed = SolveRequest(rid=len(reqs) + 1, b=rhs[0].copy(),
                                tenant=e_s.key, deadline_s=0.0)
            h.reset_counts()
            t0 = time.perf_counter()
            for r in reqs + [rej, shed]:
                sched.submit(r)
            ticks = sched.run_until_drained()
            sync()
            wall = time.perf_counter() - t0
            launched = counted(f"serve:samg slots={slots}")
            require(rej.status == "rejected",
                    f"serve:samg: the non-finite request is {rej.status}")
            require(shed.status == "shed",
                    f"serve:samg: the expired request is {shed.status}")
            sci = []
            for (name, _), r in zip(plan, reqs):
                require(r.status == "converged",
                        f"serve:samg: request {r.rid} ({name}) is "
                        f"{r.status}: {r.diagnostics.get('error')}")
                a = a64 if name == "samg" else a_p
                res = float(np.linalg.norm(a @ r.x.astype(np.float64)
                                           - r.b.astype(np.float64))
                            / np.linalg.norm(r.b.astype(np.float64)))
                require(res <= tol * slack,
                        f"serve:samg: request {r.rid} scipy residual {res}")
                sci.append(res)
            groups = {}
            for (name, _), r in zip(plan, reqs):
                d = r.diagnostics["serve"]
                groups.setdefault((name, d["solve_s"]), (d["batch_k"],
                                                         r.iters))
            snap = sched.metrics.snapshot()
            require(snap["counters"].get("error", 0) == 0,
                    f"serve:samg: typed errors {snap['counters']}")
            return reqs, {
                "slots": slots, "requests": len(reqs), "ticks": ticks,
                "wall_s": wall, "requests_per_s": len(reqs) / wall,
                "groups": [{"tenant": k[0], "ms": 1e3 * k[1],
                            "batch_k": v[0], "iters": v[1]}
                           for k, v in groups.items()],
                "p50_ms": 1e3 * snap["total_s"]["p50_s"],
                "p99_ms": 1e3 * snap["total_s"]["p99_s"],
                "solve_p50_ms": 1e3 * snap["solve_s"]["p50_s"],
                "counters": snap["counters"],
                "occupancy": snap["occupancy"],
                "max_scipy_f64_residual": max(sci),
                "launches": launched}

        reqs4, batched = serve(4)
        _, sequential = serve(1)

        # where a group's time goes: the group solver's dispatch (staging
        # the right-hand sides, the block-CG solve, the certification's
        # product and norms on the host) beside the solve alone on
        # right-hand sides already on the card
        import repro_torch
        split = {}
        for name, e in (("samg", e_s), ("poisson", e_p)):
            bs = [b for (nm, _), b in zip(plan, rhs) if nm == name]
            for k in (1, 4):
                solver = SolveScheduler(reg, slots=k, maxiter=h.maxiter,
                                        tol=tol).solver_for(e)
                batch = [SolveRequest(rid=i, b=b) for i, b in
                         enumerate(bs[:k])]
                B = torch.from_numpy(np.stack(bs[:k], 1)).to(dev)
                h.reset_counts()
                for _ in range(2):                  # the second is timed
                    sync()
                    t0 = time.perf_counter()
                    solver.dispatch_impl(batch)
                    t_disp = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    res = repro_torch.solve(e.op, B, method="block_cg",
                                            maxiter=h.maxiter, tol=tol,
                                            fallback="off")
                    sync()
                    t_solve = time.perf_counter() - t0
                counted(f"serve:samg split {name} k={k}")
                split[f"{name}:k={k}"] = {
                    "dispatch_ms": 1e3 * t_disp, "solve_ms": 1e3 * t_solve,
                    "host_staging_and_certify_ms": 1e3 * (t_disp - t_solve),
                    "iters": res.iters, "host_syncs": res.info["host_syncs"],
                    "solve_ms_per_iter": 1e3 * t_solve / max(res.iters, 1)}

        # a warm admit: a second registry over the same cache file
        before = dict(spent)
        reg2 = OperatorRegistry(tune="auto", cache=T.TuneCache(scache),
                                device=dev)
        t0 = time.perf_counter()
        w_s = reg2.admit(m)
        w_p = reg2.admit(mp)
        sync()
        t_warm = time.perf_counter() - t0
        warm_measure = {k: spent[k] - before[k] for k in spent}
        require(not any(warm_measure.values())
                and w_s.tune_info["cached"] and w_p.tune_info["cached"],
                f"serve:samg: the warm admit measured {warm_measure}")
        del reg2, w_s, w_p
    finally:
        for attr, orig in undo:
            setattr(TME, attr, orig)

    # a value swap of the Poisson tenant (under the exact-map limit)
    mp2 = dataclasses.replace(mp, data=mp.data * 2.0)
    h.reset_counts()
    t0 = time.perf_counter()
    reg.admit(mp2)
    sync()
    t_swap_first = time.perf_counter() - t0
    mp3 = dataclasses.replace(mp, data=mp.data * 4.0)
    t0 = time.perf_counter()
    reg.admit(mp3)
    sync()
    t_swap = time.perf_counter() - t0
    counted("serve:samg swap")
    require(e_p.swaps == 2 and e_p._val_map is not None,
            "serve:samg: the Poisson swap reconverted")
    sched = SolveScheduler(reg, slots=4, maxiter=h.maxiter, tol=tol,
                           cert_slack=slack)
    old = [r for (name, _), r in zip(plan, reqs4) if name == "poisson"][:4]
    new = [SolveRequest(rid=i, b=r.b, tenant=e_p.key)
           for i, r in enumerate(old)]
    for r in new:
        sched.submit(r)
    sched.run_until_drained()
    a_p3 = sp.csr_matrix((mp3.data, mp3.indices, mp3.indptr),
                         shape=mp3.shape)
    swap_res, swap_ratio = [], []
    for r, o in zip(new, old):
        require(r.status == "converged",
                f"serve:samg: swapped request {r.status}: "
                f"{r.diagnostics.get('error')}")
        res = float(np.linalg.norm(a_p3 @ r.x.astype(np.float64) - r.b)
                    / np.linalg.norm(r.b))
        require(res <= tol * slack, f"serve:samg: swapped residual {res}")
        swap_res.append(res)
        swap_ratio.append(float(np.abs(r.x * 4.0 - o.x).max()
                                / np.abs(o.x).max()))
    counted("serve:samg swapped solves")

    # the block product of sAMG's tuned layout against a SELL admit (K5)
    X4 = torch.from_numpy(np.random.default_rng(h.seed + 9).standard_normal(
        (n, 4)).astype(np.float32)).to(dev)
    Y64 = a64 @ X4.double().cpu().numpy()
    reg_sell = OperatorRegistry(tune="off", device=dev)
    e_sell = reg_sell.admit(m, format="sell")
    block = {}
    for name, op in (("tuned", e_s.op), ("sell", e_sell.op)):
        h.reset_counts()
        Y = op @ X4
        launched = counted(f"serve:samg block {name}")
        e_abs, e_rel = h.rel_err(Y, torch.from_numpy(Y64))
        require(e_rel <= h.SCIPY_TOL,
                f"serve:samg: block product ({name}) vs scipy {e_rel}")
        t = time_ms(lambda op=op: op @ X4)
        block[name] = {"format": op.fmt, "ms": t[0],
                       "ms_q25_q75": [t[1], t[2]],
                       "launches_per_call": launched,
                       "max_rel_err_vs_scipy_f64": e_rel}
    x1 = X4[:, 0].contiguous()
    block["tuned"]["k1_ms"] = time_ms(lambda: e_s.op @ x1)[0]
    block["tuned_over_sell"] = block["tuned"]["ms"] / block["sell"]["ms"]
    emit("serve:samg", tenants={
             "samg": {"n_rows": n, "nnz": m.nnz, "format": e_s.op.fmt,
                      "tuned": e_s.tune_info, "admit_s": admit_s["samg"]},
             "poisson": {"n_rows": mp.n_rows, "nnz": mp.nnz,
                         "format": e_p.op.fmt, "tuned": e_p.tune_info,
                         "admit_s": admit_s["poisson"]}},
         tol=tol, cert_slack=slack, cold_admit_measurements=cold_measure,
         batched=batched, sequential=sequential,
         batched_over_sequential_rps=batched["requests_per_s"]
         / sequential["requests_per_s"], group_time_split=split,
         warm_admit={"seconds": t_warm, "measurements": warm_measure},
         swap={"first_ms": 1e3 * t_swap_first, "ms": 1e3 * t_swap,
               "map_entries": int(e_p._val_map.size),
               "max_scipy_f64_residual": max(swap_res),
               "max_rel_diff_x_times_4_vs_before": max(swap_ratio)},
         block_rhs_k4=block)
    tdir.cleanup()
    return {"launches": launches}


def slice8_phases(h) -> dict:
    """The sparse FFN on K5, and LM serving at the full width and depth of
    ``h.lm_cfg`` (qwen2.5-14b: 48 layers, d_model 5120, bf16).

    ``lm:serve:<name>``: the model built on the card with random weights
    from ``torch.Generator(device).manual_seed(h.seed)``, then
    ``Engine(batch_slots=4, max_len=h.max_len)`` on ``h.n_requests``
    requests with ``launch/serve.py``'s prompts (4 + i % 13 tokens) and
    ``h.max_new`` new tokens each: every request done with its tokens in
    the vocab, no non-finite logits, requests ``h.solo_ids`` equal to
    themselves served alone (an engine of the same slot count, so every
    product keeps its shape and its rounding), and ``prefill`` against
    the prompt streamed through ``decode_step`` within ``PREFILL_TOL``.
    Times: ms per engine step (host clock; each step ends in the host's
    argmax read), tokens/s, the model's build seconds, peak memory, the
    step's bytes bound, and a ``torch.profiler`` trace of decode steps
    (device time per step, and so the card's idle share).
    ``lm:sparse_ffn:<name>``: layer 0's FFN weights as float32 on the
    host, sparsified at ``h.ffn_density`` (``sparsify_ffn_params``), and
    ``w2`` again with row blocks of ``h.narrow_b_r``; each
    ``SparseLinear`` at T in ``h.tokens`` and ``sparse_ffn_apply`` run
    with the counts at 0 (K5 launched, no plain call), then held to the
    plain version (Y_TOL), to
    float64 with the pruned dense weight (SCIPY_TOL) and to the dense
    pruned FFN in float64 (FFN_TOL), and timed (K5 as a burst of host
    calls, ``k5_ms``, and as a CUDA graph, ``k5_graph_ms``) beside their
    bound, cuBLAS's bf16 ``x @ w_pruned`` and
    cuSPARSE (``torch.sparse.mm`` of the pruned Wᵀ as an f32 CSR by X).
    K5 must take the split walk on the FFN's weights at ``ffn_density``
    (``pjds_spmm.split_plan``); each row names the walk, its slices and
    column tile.  Returns the launches and the per-layer rows."""
    import types

    import numpy as np
    import torch

    from repro_torch.kernels import ops as TO
    from repro_torch.kernels import pjds_spmm as K5
    from repro_torch.kernels import ref as R
    from repro_torch.models import build_model
    from repro_torch.models.common import activation
    from repro_torch.serve import Engine, Request
    from repro_torch.sparse.sparse_ffn import (T_PAD, SparseLinear, prune,
                                               sparse_ffn_apply,
                                               sparsify_ffn_params)

    dev, cfg = h.dev, h.lm_cfg
    require, emit, time_ms = h.require, h.emit, h.time_ms
    cuda = dev.type == "cuda"
    launches = {}

    def counted(phase):
        launched, plain_calls = h.counts()
        h.plain_free(plain_calls, phase)
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
        return {k: v for k, v in launched.items() if v}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def quartiles(v):
        return [float(q) for q in np.percentile(v, [50, 25, 75])]

    # ---- lm:serve -- the engine at full width and depth --------------
    phase = f"lm:serve:{cfg.name}"
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(h.seed))
    sync()
    t_build = time.perf_counter() - t0
    vocab = cfg.vocab
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def watched_step(*args):
        """``model.decode_step`` with a device-side latch of finite
        logits (no host read per step)."""
        cache, logits = model.decode_step(*args)
        finite.logical_and_(torch.isfinite(logits[..., :vocab]).all())
        return cache, logits

    served = types.SimpleNamespace(decode_step=watched_step,
                                   init_cache=model.init_cache)
    rng = np.random.default_rng(h.seed)
    prompts = [rng.integers(0, vocab, (4 + i % 13,)).astype(np.int32)
               for i in range(h.n_requests)]

    def serve(ids, slots, steps=None):
        eng = Engine(served, params, batch_slots=slots, max_len=h.max_len)
        reqs = [Request(rid=i, prompt=prompts[i], max_new=h.max_new)
                for i in ids]
        if steps is not None:
            tick = eng.step

            def timed():
                busy = sum(r is not None and not r.done for r in eng.active)
                t = time.perf_counter()
                tick()
                steps.append((busy, 1e3 * (time.perf_counter() - t)))
            eng.step = timed
        t = time.perf_counter()
        eng.run(reqs)
        return reqs, time.perf_counter() - t, eng

    h.reset_counts()
    steps = []
    reqs, t_run, eng = serve(range(h.n_requests), 4, steps)
    launched = counted(phase)
    require(all(r.done and len(r.out) == h.max_new for r in reqs),
            f"{phase}: a request is not done with {h.max_new} tokens: "
            f"{[(r.rid, r.done, len(r.out)) for r in reqs]}")
    require(all(0 <= t < vocab for r in reqs for t in r.out),
            f"{phase}: a token outside the vocab")
    alone, one_slot = {}, {}
    for i in h.solo_ids:
        alone[i] = serve([i], 4)[0][0].out
        require(alone[i] == reqs[i].out,
                f"{phase}: request {i} batched {reqs[i].out} != alone "
                f"{alone[i]}")
        one_slot[i] = serve([i], 1)[0][0].out
    require(bool(finite), f"{phase}: non-finite logits")

    # prefill against the same prompt streamed through decode_step
    p = prompts[h.consistency_id]
    _, lp = model.prefill(params, {"tokens": p[None]}, max_len=h.max_len)
    c1 = model.init_cache(1, h.max_len)
    for j, tok in enumerate(p):
        c1, ld = model.decode_step(params, c1, np.array([[tok]], np.int32),
                                   np.array([j], np.int32))
    a, b = lp[0, -1, :vocab].double(), ld[0, -1, :vocab].double()
    pd_rel = float((a - b).norm() / b.norm())
    require(bool(torch.isfinite(a).all()) and pd_rel <= PREFILL_TOL,
            f"{phase}: prefill vs streamed decode {pd_rel} > {PREFILL_TOL}")
    del c1

    full = [ms for busy, ms in steps if busy == 4]
    busy_ms = [ms for busy, ms in steps if busy]
    emb = params["embed"]["w"]
    weight_bytes = nbytes(params.parameters())
    cache_bytes = nbytes(t for c in eng.cache for k, t in c.items()
                         if k in ("k", "v"))
    # a step reads every weight but the embedding table (4 rows of it),
    # the whole cache, and writes float32 logits
    step_bytes = (weight_bytes - nbytes([emb]) + 4 * emb[0].numel()
                  * emb.element_size() + cache_bytes
                  + 4 * emb.shape[0] * 4)
    step_flops = 2.0 * 4 * (weight_bytes - nbytes([emb])) / emb.element_size()
    t_bytes, t_ops = step_bytes / h.HBM, step_flops / h.BF16_FLOPS
    c4 = model.init_cache(4, h.max_len)
    toks4 = np.zeros((4, 1), np.int32)
    pos4 = np.arange(4, dtype=np.int32)
    trace = h.trace(lambda: model.decode_step(params, c4, toks4, pos4), n=5)
    del c4
    step_ms = quartiles(full) if full else None
    serve_row = {
        "config": {"name": cfg.name, "n_layers": cfg.n_layers,
                   "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                   "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
                   "vocab": vocab, "dtype": cfg.param_dtype,
                   "n_params": sum(t.numel() for t in params.parameters())},
        "build_s": t_build, "weight_bytes": weight_bytes,
        "requests": h.n_requests, "slots": 4, "max_new": h.max_new,
        "prompt_tokens": int(sum(len(q) for q in prompts)),
        "run_s": t_run,
        "tokens_per_s": sum(len(r.out) for r in reqs) / t_run,
        "step_ms_4_busy": step_ms, "steps_4_busy": len(full),
        "step_ms_busy": quartiles(busy_ms), "steps_busy": len(busy_ms),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "all_weights_bound_ms": 1e3 * weight_bytes / h.HBM,
        "step_bytes": step_bytes,
        "profile_decode_step": trace,
        "idle_share": (1.0 - trace["device_ms"] / step_ms[0]) if step_ms
        else None,
        "launches": launched,
        "alone_equal": {str(i): alone[i] == reqs[i].out for i in alone},
        "one_slot_equal": {str(i): one_slot[i] == reqs[i].out
                           for i in one_slot},
        "prefill_vs_decode_rel_l2": pd_rel,
        "prefill_vs_decode_max_abs": float((a - b).abs().max()),
        "prefill_vs_decode_argmax_equal": int(a.argmax()) == int(b.argmax()),
        "tokens": {str(r.rid): r.out for r in reqs[:2]},
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if cuda else None)}
    emit(phase, **serve_row)

    # ---- lm:sparse_ffn -- layer 0's FFN through K5 ---------------------
    phase = f"lm:sparse_ffn:{cfg.name}"
    mlp = params["dec"][0]["mlp"]
    w_host = {k: mlp[k]["w"].float().cpu().numpy() for k in mlp}
    t0 = time.perf_counter()
    sp = sparsify_ffn_params(mlp, h.ffn_density, device=dev)
    t_sp = time.perf_counter() - t0
    # w2 again with row blocks of h.narrow_b_r: its 5120 output rows fill
    # 40 CTAs of 128 lanes on a 132-SM card, 160 of 32
    t0 = time.perf_counter()
    w2_narrow = SparseLinear.from_dense(w_host["w2"], h.ffn_density,
                                        b_r=h.narrow_b_r, device=dev)
    t_w2n = time.perf_counter() - t0
    pruned = {k: prune(w_host[k], h.ffn_density) for k in mlp}
    layers = [(k, h.ffn_density, sp[k]) for k in sp] + [
        ("w2", h.ffn_density, w2_narrow)]
    gen = torch.Generator(device=dev).manual_seed(h.seed + 8)
    xs = {(n_in, t): torch.randn((t, n_in), generator=gen, device=dev)
          for n_in in {sl.op.shape[1] for _, _, sl in layers}
          for t in h.tokens}
    x_ffn = torch.randn((4, cfg.d_model), generator=gen, device=dev)
    h.reset_counts()
    ys, split_runs = {}, []
    for i, (_, _, sl) in enumerate(layers):
        before = K5.pjds_matmat_kernel_call.split_launches
        for t in h.tokens:
            ys[i, t] = sl(xs[sl.op.shape[1], t])
        split_runs.append(K5.pjds_matmat_kernel_call.split_launches
                          - before)
    y_ffn = sparse_ffn_apply(sp, cfg, x_ffn)
    launched = counted(phase)
    require(launched.get("pjds_spmm", 0) >= 1,
            f"{phase}: K5 not launched: {launched}")

    def plain(sl, xt, chunk=16):
        """K5's plain version on the same stored arrays, in column chunks
        (a column is independent of the others)."""
        d, sd = sl.a, sl.op.dev
        out = [R.pjds_matmat_ref(d.val, d.col_idx, d.row_block,
                                 xt[:, j:j + chunk].contiguous(), d.n_blocks)
               for j in range(0, xt.shape[1], chunk)]
        return torch.cat(out, dim=1).index_select(0, sd.stored_rows())

    rows = []
    for i, (k, dens, sl) in enumerate(layers):
        n_out, n_in = sl.op.shape
        d, sd = sl.a, sl.op.dev
        wp = pruned[k]
        nnz = int(np.count_nonzero(wp))
        wp64 = torch.from_numpy(wp).to(dev, torch.float64)
        wp16 = wp64.to(torch.bfloat16)
        walked = int(d.warp_len.sum()) * 32
        vb, ib = d.val.element_size(), d.col_idx.element_size()
        # K5's walk on this weight: the split walk for the FFN's weights
        # at ffn_density (split_plan), one split launch per T above
        if cuda and dens == h.ffn_density:
            require(split_runs[i] == len(h.tokens),
                    f"{phase}: {k}@{dens}: {split_runs[i]} of "
                    f"{len(h.tokens)} K5 launches took the split walk")
        csr = torch.from_numpy(np.ascontiguousarray(wp.T)).to(dev)
        csr = csr.to_sparse_csr()
        row = {"weight": k, "density": dens, "format": sl.fmt, "b_r": d.b_r,
               "shape_wt": [n_out, n_in], "nnz": nnz,
               "stored_slots": d.val.numel(), "walked_slots": walked,
               "split_launches": split_runs[i],
               "memory_summary": sl.memory_summary(), "by_t": {}}
        for t in h.tokens:
            x = xs[n_in, t]
            y = ys[i, t]
            t_pad = -(-t // T_PAD) * T_PAD
            xt = torch.nn.functional.pad(x.T, (0, t_pad - t)).contiguous()
            yp = plain(sl, xt)[:, :t].T
            e_abs, e_rel = h.rel_err(y, yp)
            require(e_rel <= h.Y_TOL,
                    f"{phase}: {k}@{dens} T={t} vs plain {e_rel}")
            s_abs, s_rel = h.rel_err(y, x.double() @ wp64)
            require(s_rel <= h.SCIPY_TOL,
                    f"{phase}: {k}@{dens} T={t} vs f64 {s_rel}")
            k5 = lambda: TO.pjds_matmat_kernel_call(
                d.val, d.col_idx, d.block_start, d.warp_len, xt,
                n_blocks=d.n_blocks, max_col=d.max_col,
                out_row=sd.row_map(), n_out=n_out)
            plan = K5.plan_for(d.val, d.n_blocks) if cuda else K5.LANE
            require(not cuda or plan.walk == (
                "split" if split_runs[i] else "lane"),
                f"{phase}: {k}@{dens} T={t}: plan {plan} did not run")
            kt, lanes = K5.column_tile(t_pad)
            tile = kt * lanes if plan.walk == "split" else 8
            # k5_ms: a burst of host calls, what a caller gets; the
            # device time beside it as a CUDA graph of the burst (the
            # wrapper's host work outlasts a split-walk call at T = 4)
            k_ms = time_ms(k5)
            g_ms = time_ms(k5, graph=cuda)
            xc = x.T.contiguous()
            x16 = x.to(torch.bfloat16)
            tb = (walked * (vb + ib) + (n_in + n_out) * t * 4) / h.HBM
            tn = (nnz * (vb + ib) + (n_in + n_out) * t * 4) / h.HBM
            to = 2.0 * nnz * t / h.F32_FLOPS
            row["by_t"][str(t)] = {
                "k5_ms": k_ms[0], "k5_ms_q25_q75": k_ms[1:],
                "k5_graph_ms": g_ms[0], "k5_graph_ms_q25_q75": g_ms[1:],
                "layer_ms_bf16_x": time_ms(lambda: sl(x16))[0],
                "plain_ms": time_ms(lambda: plain(sl, xt), reps=5, warm=1,
                                    burst=1)[0],
                "cublas_bf16_ms": time_ms(lambda: x16 @ wp16)[0],
                "cusparse_ms": time_ms(lambda: torch.sparse.mm(csr, xc))[0],
                "walk": plan.walk, "slices": plan.slices,
                "column_tile": tile,
                "bound_ms": 1e3 * max(tb, to),
                "bound_by": "bytes" if tb >= to else "operations",
                "bound_nnz_ms": 1e3 * max(tn, to),
                "share_of_bound": 1e3 * max(tb, to) / k_ms[0],
                "share_of_bound_graph": 1e3 * max(tb, to) / g_ms[0],
                "column_tiles": -(-t_pad // tile),
                "max_rel_err_vs_plain": e_rel,
                "max_rel_err_vs_f64": s_rel}
        rows.append(row)
        del wp64, wp16, csr

    act = activation(cfg.act)
    p64 = {k: torch.from_numpy(pruned[k]).to(dev, torch.float64)
           for k in mlp}
    x64 = x_ffn.double()
    ref = act(x64 @ p64["w1"])
    ref = (ref * (x64 @ p64["w3"]) if "w3" in p64 else ref) @ p64["w2"]
    f_abs, f_rel = h.rel_err(y_ffn, ref)
    require(f_rel <= FFN_TOL,
            f"{phase}: sparse_ffn_apply vs dense pruned FFN {f_rel}")
    del p64
    emit(phase, launches=launched, ffn_density=h.ffn_density,
         sparsify_s=t_sp, w2_narrow_convert_s=t_w2n,
         tokens=list(h.tokens), layers=rows,
         ffn_max_rel_err_vs_f64=f_rel,
         ffn_ms_t4=time_ms(lambda: sparse_ffn_apply(sp, cfg, x_ffn))[0],
         peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                   if cuda else None))
    return {"launches": launches, "serve": serve_row, "ffn": rows}

SLICE9_MODELS = {"moe": "deepseek-moe-16b", "ssm": "falcon-mamba-7b",
                 "hybrid": "recurrentgemma-2b", "audio": "seamless-m4t-medium",
                 "vlm": "llava-next-mistral-7b"}


def slice9_phases(h) -> dict:
    """The rest of LM serving, each model at its published width and the
    depth ``h.cfgs`` gives it (``main`` cuts it: ``GROUP_DEPTH``), built
    on the card in bf16 with random weights
    from ``torch.Generator(device).manual_seed(h.seed)`` and freed before
    the next.

    ``lm:serve:<moe>`` (deepseek-moe-16b): the engine (4 slots,
    ``h.max_len`` positions) on ``h.n_requests`` requests with
    ``launch/serve.py``'s prompts and ``h.max_new`` new tokens; every
    request done with its tokens in the vocab, finite logits, and the
    same run again giving the same tokens.  That second run records each
    MoE layer's input and its dropped assignments; on the first 4-slot
    step's inputs the sorted dispatch is held to ``moe_dispatch=
    "onehot"`` (MOE_ONEHOT_TOL) and to a float64 loop over tokens and
    their kept assignments (MOE_F64_TOL), relative L2 per layer.  A
    request served batched cannot equal itself served alone here: the
    capacity counts every token of a step.  Prefill against the prompt
    streamed through decode steps is reported, unbounded (T differs,
    so does the capacity).
    ``lm:serve:<ssm>`` / ``<hybrid>`` (falcon-mamba-7b,
    recurrentgemma-2b): ``slice8_phases``' checks -- requests
    ``h.solo_ids`` equal to themselves served alone at 4 slots, and prefill (the chunked scan)
    against the prompt streamed through decode steps, here on the same
    model built again in float32 within ``PREFILL_F32_TOL`` (bf16's is
    reported) -- plus the recurrent state's bytes per slot.
    Each serving phase reports ms per engine step at 4 busy slots (host
    clock), tokens/s, the device ms per decode step and the card's idle
    share (``h.trace``: ``torch.profiler``), kernels launched per step,
    the step's bytes bound and peak memory.
    ``lm:cross:<audio>`` / ``<vlm>`` (seamless-m4t-medium,
    llava-next-mistral-7b): a batch of ``h.cross_batch`` with frames
    (``enc_frames``) or patches (``frontend``) of ``cfg.frontend_seq``
    positions drawn on the card, ``h.cross_prompt`` prompt tokens each,
    ``prefill`` and ``h.cross_steps`` greedy ``decode_step``s; finite
    logits; prefill of S tokens plus one decode step against prefill of
    S + 1 in softmax within the reference's 5e-3 / 1e-2 and in logits
    within ``PREFILL_TOL``; other frames change the logits.  Reports
    prefill ms, ms per decode step and the step's bytes bound.
    Returns the launches of the repo's kernels (none of these paths runs
    one) and the phases' rows."""
    import dataclasses
    import gc
    import types

    import numpy as np
    import torch

    from repro_torch.models import build_model
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import activation
    from repro_torch.serve import Engine, Request

    dev = h.dev
    require, emit = h.require, h.emit
    cuda = dev.type == "cuda"
    launches, rows = {}, {}

    def counted(phase):
        launched, plain_calls = h.counts()
        h.plain_free(plain_calls, phase)
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
        return {k: v for k, v in launched.items() if v}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def leaves(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in leaves(v)]
        return [tree]

    def quartiles(v):
        return [float(q) for q in np.percentile(v, [50, 25, 75])] if v \
            else None

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda \
            else None

    def build(cfg):
        gc.collect()
        if cuda:
            sync()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(h.seed))
        sync()
        return model, params, time.perf_counter() - t0

    def config_row(cfg, params):
        return {"name": cfg.name, "family": cfg.family,
                "n_layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
                "d_model": cfg.d_model, "d_ff": cfg.d_ff,
                "vocab": cfg.vocab, "dtype": cfg.param_dtype,
                "n_params": sum(t.numel() for t in params.parameters())}

    def rel_l2(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm())

    def step_bytes(model, params, cache, rows_read=None):
        """Bytes a batch-4 decode step moves: the decoder's weights (all
        of them, or ``rows_read`` bytes of them), 4 rows of an untied
        embedding table, every cache tensor read and the f32 logits
        written.  Returns (bytes, the decoder's weight bytes)."""
        emb = params["embed"]["w"]
        tied = model.cfg.tie_embeddings
        dec = [t for k, m in params.items()
               if k not in ("embed", "enc", "enc_ln") for t in m.parameters()]
        dec += [emb] if tied else []
        w = nbytes(dec) if rows_read is None else rows_read
        emb_rows = 0 if tied else 4 * emb[0].numel() * emb.element_size()
        return (w + emb_rows + nbytes(t for c in cache for t in leaves(c))
                + 4 * emb.shape[0] * 4), nbytes(dec)

    def bound(nb, weight_bytes, elt):
        tb = nb / h.HBM
        to = 2.0 * 4 * weight_bytes / elt / h.BF16_FLOPS
        return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"

    def traced_step(model, params):
        c4 = model.init_cache(4, h.max_len)
        toks4 = np.zeros((4, 1), np.int32)
        pos4 = np.arange(4, dtype=np.int32)
        tr = h.trace(lambda: model.decode_step(params, c4, toks4, pos4),
                     n=5)
        return tr, c4

    def prefill_vs_stream(model, params, prompt):
        """Prefill's last logits against the same prompt streamed through
        ``decode_step``: (relative L2, argmax equal)."""
        _, lp = model.prefill(params, {"tokens": prompt[None]},
                              max_len=h.max_len)
        c1 = model.init_cache(1, h.max_len)
        for j, tok in enumerate(prompt):
            c1, ld = model.decode_step(params, c1,
                                       np.array([[tok]], np.int32),
                                       np.array([j], np.int32))
        a, b = lp[0, -1, :model.cfg.vocab], ld[0, -1, :model.cfg.vocab]
        require(bool(torch.isfinite(a).all()),
                f"{model.cfg.name}: prefill logits not finite")
        return rel_l2(a, b), int(a.argmax()) == int(b.argmax())

    # ---- the engine phases ------------------------------------------------
    def serve_phase(role):
        cfg = h.cfgs[role]
        phase = f"lm:serve:{cfg.name}"
        model, params, t_build = build(cfg)
        vocab = cfg.vocab
        finite = torch.ones((), dtype=torch.bool, device=dev)

        def watched_step(*args):
            cache, logits = model.decode_step(*args)
            finite.logical_and_(torch.isfinite(logits[..., :vocab]).all())
            return cache, logits

        served = types.SimpleNamespace(decode_step=watched_step,
                                       init_cache=model.init_cache)
        rng = np.random.default_rng(h.seed)
        prompts = [rng.integers(0, vocab, (4 + i % 13,)).astype(np.int32)
                   for i in range(h.n_requests)]

        def serve(ids, steps=None):
            eng = Engine(served, params, batch_slots=4, max_len=h.max_len)
            reqs = [Request(rid=i, prompt=prompts[i], max_new=h.max_new)
                    for i in ids]
            if steps is not None:
                tick = eng.step

                def timed():
                    busy = sum(r is not None and not r.done
                               for r in eng.active)
                    t = time.perf_counter()
                    tick()
                    steps.append((busy, 1e3 * (time.perf_counter() - t)))
                eng.step = timed
            t = time.perf_counter()
            eng.run(reqs)
            return reqs, time.perf_counter() - t, eng

        h.reset_counts()
        steps = []
        reqs, t_run, eng = serve(range(h.n_requests), steps)
        launched = counted(phase)
        require(all(r.done and len(r.out) == h.max_new for r in reqs),
                f"{phase}: a request is not done with {h.max_new} tokens: "
                f"{[(r.rid, r.done, len(r.out)) for r in reqs]}")
        require(all(0 <= t < vocab for r in reqs for t in r.out),
                f"{phase}: a token outside the vocab")
        row = {"config": config_row(cfg, params), "build_s": t_build,
               "requests": h.n_requests, "slots": 4, "max_new": h.max_new,
               "prompt_tokens": int(sum(len(q) for q in prompts)),
               "run_s": t_run,
               "tokens_per_s": sum(len(r.out) for r in reqs) / t_run,
               "launches": launched}
        rows_read = None
        if cfg.n_experts:
            # the same run again, each MoE layer's input and drops recorded
            calls = []
            apply = MOE.moe_apply

            def recording(p, c, x):
                t = x.shape[0] * x.shape[1]
                _, _, experts = MOE.route(p, c, x.reshape(t, -1))
                calls.append((t, MOE.dropped_assignments(c, experts),
                              experts, p, x.clone()))
                return apply(p, c, x)
            MOE.moe_apply = recording
            try:
                again = serve(range(h.n_requests))[0]
            finally:
                MOE.moe_apply = apply
            require([r.out for r in again] == [r.out for r in reqs],
                    f"{phase}: a second run gave other tokens")
            n_moe = sum(1 for blk in params["dec"] if "moe" in blk)
            batched = [c for c in calls if c[0] == 4]
            require(len(batched) % n_moe == 0 and batched,
                    f"{phase}: {len(batched)} batched MoE calls, "
                    f"{n_moe} layers")
            drops = [sum(c[1] for c in batched[i:i + n_moe])
                     for i in range(0, len(batched), n_moe)]
            first = batched[:n_moe]
            onehot_cfg = dataclasses.replace(cfg, moe_dispatch="onehot")
            act = activation(cfg.act)
            e_onehot, e_f64 = [], []
            for _, _, experts, p, x in first:
                y, _ = MOE.moe_apply(p, cfg, x)
                y1, _ = MOE.moe_apply(p, onehot_cfg, x)
                e_onehot.append(rel_l2(y, y1))
                xt = x.reshape(4, -1)
                _, gates, ex = MOE.route(p, cfg, xt)
                cap = MOE.capacity(cfg, 4)
                x64 = xt.double()
                y64 = torch.zeros_like(x64)
                seen = {}
                for i in range(4):
                    for j in range(cfg.top_k):
                        e = int(ex[i, j])
                        seen[e] = seen.get(e, 0) + 1
                        if seen[e] > cap:
                            continue
                        hh = act(x64[i] @ p["w1"][e].double()) \
                            * (x64[i] @ p["w3"][e].double())
                        y64[i] += float(gates[i, j]) * (
                            hh @ p["w2"][e].double())
                if "shared" in p:
                    sh = {k: p["shared"][k]["w"].double()
                          for k in ("w1", "w3", "w2")}
                    y64 += (act(x64 @ sh["w1"]) * (x64 @ sh["w3"])) \
                        @ sh["w2"]
                e_f64.append(rel_l2(y.reshape(4, -1), y64))
            require(max(e_onehot) <= MOE_ONEHOT_TOL,
                    f"{phase}: sorted vs onehot {max(e_onehot)}")
            require(max(e_f64) <= MOE_F64_TOL,
                    f"{phase}: sorted vs float64 {max(e_f64)}")
            # the routed experts' bytes of the recorded step
            per_expert = sum(p[k][0].numel() * p[k].element_size()
                             for k in ("w1", "w3", "w2") if k in p)
            expert_bytes = sum(nbytes([p[k] for k in ("w1", "w3", "w2")
                                       if k in p]) for _, _, _, p, _ in first)
            routed = sum(int(ex.unique().numel()) for _, _, ex, _, _ in first)
            row["moe"] = {
                "moe_layers": n_moe,
                "capacity_decode": MOE.capacity(cfg, 4),
                "dispatch_shards_decode": MOE.dispatch_shards(cfg, 4),
                "assignments_per_step": 4 * cfg.top_k * n_moe,
                "dropped_per_step": quartiles(drops),
                "dropped_per_step_all": drops,
                "dropped_per_step_mean": float(np.mean(drops)),
                "distinct_experts_first_step": routed,
                "sorted_vs_onehot_rel_l2_max": max(e_onehot),
                "sorted_vs_f64_rel_l2_max": max(e_f64)}
            del calls, batched, first
        else:
            for i in h.solo_ids:
                alone = serve([i])[0][0].out
                require(alone == reqs[i].out,
                        f"{phase}: request {i} batched {reqs[i].out} != "
                        f"alone {alone}")
        require(bool(finite), f"{phase}: non-finite logits")

        pd_rel, pd_argmax = prefill_vs_stream(model, params,
                                              prompts[h.consistency_id])

        full = [ms for busy, ms in steps if busy == 4]
        trace, c4 = traced_step(model, params)
        nb, w_all = step_bytes(model, params, c4)
        elt = params["embed"]["w"].element_size()
        b_ms, b_by = bound(nb, w_all, elt)
        step_ms = quartiles(full)
        state = [c[k] for c in c4 for k in ("conv", "h") if k in c]
        row.update({
            "step_ms_4_busy": step_ms, "steps_4_busy": len(full),
            "step_ms_busy": quartiles([ms for busy, ms in steps if busy]),
            "bound_ms": b_ms, "bound_by": b_by, "step_bytes": nb,
            "weight_bytes": nbytes(params.parameters()),
            "profile_decode_step": trace,
            "device_ms_per_step": trace["device_ms"],
            "kernels_per_step": trace.get("kernels_per_call"),
            "idle_share": (1.0 - trace["device_ms"] / step_ms[0]) if step_ms
            else None,
            "prefill_vs_decode_rel_l2": pd_rel,
            "prefill_vs_decode_argmax_equal": pd_argmax,
            "tokens": {str(r.rid): r.out for r in reqs[:2]},
            "peak_gib": peak_gib()})
        if state:
            row["state_bytes_per_slot"] = nbytes(state) // 4
            row["cache_bytes_per_slot"] = nbytes(
                t for c in c4 for t in leaves(c)) // 4
        if cfg.n_experts:
            # the reference's einsums read every expert; a dispatch that
            # read only the routed ones would move this much
            nb_r, _ = step_bytes(model, params, c4, rows_read=w_all
                                 - expert_bytes + routed * per_expert)
            row["bound_routed_only_ms"] = 1e3 * nb_r / h.HBM
            row["step_bytes_routed_only"] = nb_r
        del model, params, eng, c4, reqs, served
        if not cfg.n_experts:
            # prefill (the chunked scan) against streamed decode, in f32:
            # in bf16 the two paths round apart with depth
            model, params, _ = build(dataclasses.replace(
                cfg, param_dtype="float32", activation_dtype="float32"))
            rel32, _ = prefill_vs_stream(model, params,
                                         prompts[h.consistency_id])
            require(rel32 <= PREFILL_F32_TOL,
                    f"{phase}: f32 prefill vs streamed decode {rel32} > "
                    f"{PREFILL_F32_TOL}")
            row["prefill_vs_decode_rel_l2_f32"] = rel32
            row["peak_gib_f32_check"] = peak_gib()
            del model, params
        emit(phase, **row)
        return row

    # ---- the cross-attention phases ---------------------------------------
    def cross_phase(role):
        cfg = h.cfgs[role]
        phase = f"lm:cross:{cfg.name}"
        model, params, t_build = build(cfg)
        vocab, bsz, s = cfg.vocab, h.cross_batch, h.cross_prompt
        gen = torch.Generator(device=dev).manual_seed(h.seed + 9)
        key = "enc_frames" if cfg.is_encdec else "frontend"
        n_front = 0 if cfg.is_encdec else cfg.frontend_seq
        max_len = n_front + 64

        def frames():
            return torch.randn((bsz, cfg.frontend_seq, cfg.d_model),
                               generator=gen, device=dev).to(model.adt)
        fe = frames()
        toks = np.random.default_rng(h.seed + 9).integers(
            0, vocab, (bsz, s + 1)).astype(np.int32)
        h.reset_counts()
        sync()
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, {"tokens": toks[:, :s],
                                               key: fe}, max_len=max_len)
        sync()
        t_prefill = 1e3 * (time.perf_counter() - t0)
        first = logits
        out, step_ms = [], []
        pos = np.full(bsz, n_front + s, np.int32)
        tok = torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None]
        finite = bool(torch.isfinite(logits[..., :vocab]).all())
        for i in range(h.cross_steps):
            t0 = time.perf_counter()
            cache, logits = model.decode_step(params, cache, tok, pos + i)
            tok = torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None]
            out.append(tok[:, 0].cpu().numpy())
            step_ms.append(1e3 * (time.perf_counter() - t0))
            finite &= bool(torch.isfinite(logits[..., :vocab]).all())
        launched = counted(phase)
        require(finite, f"{phase}: non-finite logits")
        gen_toks = np.stack(out, axis=1)
        require(bool(((gen_toks >= 0) & (gen_toks < vocab)).all()),
                f"{phase}: a token outside the vocab")

        # prefill of S plus one decode step against prefill of S + 1
        c_s, _ = model.prefill(params, {"tokens": toks[:, :s], key: fe},
                               max_len=max_len)
        _, l_step = model.decode_step(params, c_s, toks[:, s:s + 1],
                                      np.full(bsz, n_front + s, np.int32))
        _, l_full = model.prefill(params, {"tokens": toks, key: fe},
                                  max_len=max_len)
        a, b = l_step[:, -1, :vocab].float(), l_full[:, -1, :vocab].float()
        pa, pb = torch.softmax(a, -1), torch.softmax(b, -1)
        p_err = float(((pa - pb).abs() - 1e-2 * pb.abs()).max())
        s_rel = rel_l2(a, b)
        require(p_err <= 5e-3,
                f"{phase}: prefill + step vs longer prefill in softmax "
                f"{p_err} > 5e-3 + 1e-2 |p|")
        require(s_rel <= PREFILL_TOL,
                f"{phase}: prefill + step vs longer prefill {s_rel} > "
                f"{PREFILL_TOL}")
        del c_s
        _, other = model.prefill(params, {"tokens": toks[:, :s],
                                          key: frames()}, max_len=max_len)
        live = rel_l2(other[:, -1, :vocab], first[:, -1, :vocab])
        require(live > 1e-3, f"{phase}: other frames moved the logits by "
                             f"only {live}")
        trace = h.trace(lambda: model.decode_step(params, cache, tok,
                                                  pos + h.cross_steps), n=5)
        nb, w_dec = step_bytes(model, params, cache)
        b_ms, b_by = bound(nb, w_dec, params["embed"]["w"].element_size())
        med = quartiles(step_ms[1:])
        row = {"config": config_row(cfg, params), "build_s": t_build,
               "batch": bsz, "frontend_seq": cfg.frontend_seq,
               "prompt_tokens": s, "steps": h.cross_steps,
               "max_len": max_len, "prefill_ms": t_prefill,
               "step_ms": med, "bound_ms": b_ms, "bound_by": b_by,
               "step_bytes": nb,
               "cross_cache_bytes": nbytes(t for c in cache
                                           for k, t in c.items()
                                           if k in ("xk", "xv")),
               "device_ms_per_step": trace["device_ms"],
               "kernels_per_step": trace.get("kernels_per_call"),
               "idle_share": 1.0 - trace["device_ms"] / med[0],
               "profile_decode_step": trace,
               "step_vs_longer_prefill_softmax_excess": p_err,
               "step_vs_longer_prefill_rel_l2": s_rel,
               "other_frames_rel_l2": live,
               "tokens": gen_toks[:2].tolist(), "launches": launched,
               "peak_gib": peak_gib()}
        emit(phase, **row)
        del model, params, cache, fe
        return row

    for role in ("moe", "ssm", "hybrid"):
        rows[role] = serve_phase(role)
    for role in ("audio", "vlm"):
        rows[role] = cross_phase(role)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


SLICE10_MODELS = {"main": "minicpm-2b", "moe": "granite-moe-3b-a800m",
                  "hybrid": "recurrentgemma-2b",
                  "audio": "seamless-m4t-medium"}
SLICE10_PARITY = ("minicpm-2b", "granite-moe-3b-a800m", "seamless-m4t-medium")
# train:parity: one train step of an f32 smoke config on the card against
# the same step on the CPU -- loss and grad_norm relative, each updated
# param within PARITY_TOL * max|p_cpu| of its tensor.  The params carry
# N(0, 0.02^2) noise so that no leaf is zero: a zero-init bias holds only
# lr * g / (|g| + eps) after one step, which turns float32 rounding of g
# into a change of order lr (tests/test_torch_train_step.py).
PARITY_TOL = 1e-5
# train:resume: the resumed run's losses against the uninterrupted run's,
# relative, with torch.use_deterministic_algorithms on; a wrong restored
# moment or master moves a loss by the order of lr, 3e-4.
RESUME_TOL = 1e-5
OPT_BYTES_PER_PARAM = 28    # bf16 grad and param, f32 m, v and master


def slice10_phases(h) -> dict:
    """LM training (ROADMAP 1.27) at published widths, each model freed
    before the next.

    ``train:<main>`` (minicpm-2b, ``h.cfgs["main"]``): the main path,
    ``repro_torch.launch.train.main`` at the published width and depth,
    bf16, batch ``h.batch`` x ``h.seq``, WSD at lr 3e-4,
    ``h.steps_main`` steps, a checkpoint to a temporary directory at the
    last step (committed, the leaves of params and optimizer state, the
    data state; ``shutil.disk_usage`` before it is written).
    ``train:<moe>`` (granite-moe-3b-a800m: 40 experts, top-8, the aux
    loss), ``train:<hybrid>`` (recurrentgemma-2b: RG-LRU and local
    attention, its suffix layers outside the rematerialised periods) and
    ``train:<audio>`` (seamless-m4t-medium: the encoder over the
    pipeline's ``enc_frames``): the same launcher at the depth of
    ``h.cfgs`` (its ``--n-layers`` / ``--enc-layers`` where that is cut),
    ``h.steps_other`` steps, no checkpoint.  Every launcher phase: losses and grad norms
    finite, the mean of the last two losses below the first, every
    master and most bf16 params moved, K1-K7 launched 0 times; reports
    ms a step (host clock around a step ending in the loss read,
    quartiles of the steps after the first), tokens/s, MFU (6 N T plus
    the attention's flops over the bf16 peak; N the params a token uses)
    and HFU (plus remat's second forward), the step's bound (8 N T at
    the bf16 peak plus 28 B a parameter at HBM's rate), the
    forward+backward / optimizer split (CUDA events around
    ``AdamW.update`` in one more step), ``torch.profiler``'s device ms,
    idle share, kernels a step and top device operations (``h.trace``
    over ``h.trace_steps`` more steps), peak memory, losses, grad norms
    and lrs.
    ``train:resume``: the main config with ``n_layers`` cut to
    ``h.resume_layers``, 4 steps with ``ckpt_every=2``, then fresh
    model, optimizer and pipeline resumed from the step-2 checkpoint:
    the restored leaves equal the saved ones (in memory at step 2 and on
    disk) bit for bit, the data state and the next batch equal, the
    resumed losses the uninterrupted run's within RESUME_TOL (and
    whether bit for bit), under deterministic algorithms.
    ``train:parity``: ``SLICE10_PARITY``'s f32 smoke configs, one
    ``make_train_step`` on ``h.dev`` and one on the CPU from the same
    params and batch, within PARITY_TOL.
    Returns the launches of the repo's kernels and the phases' rows."""
    import copy
    import dataclasses
    import gc
    import shutil

    import numpy as np
    import torch

    from repro_torch import configs as TCFG
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import for_config
    from repro_torch.launch import train as LT
    from repro_torch.models import build_model
    from repro_torch.models import transformer as TT
    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import AdamW, trainable
    from repro_torch.train.schedules import wsd
    from repro_torch.train.step import make_train_step

    dev = h.dev
    require, emit = h.require, h.emit
    cuda = dev.type == "cuda"
    launches, rows = {}, {}
    t_all = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def free():
        gc.collect()
        if cuda:
            sync()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda \
            else None

    def quartiles(v):
        return [float(q) for q in np.percentile(v, [50, 25, 75])] if v \
            else None

    def counted(phase):
        launched, plain_calls = h.counts()
        h.plain_free(plain_calls, phase)
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
        require(not any(launched.values()),
                f"{phase}: a kernel of the repo launched: {launched}")
        return launched

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def between(a, b):
        sync()
        return a.elapsed_time(b) if cuda else 1e3 * (b - a)

    def on_dev(batch):
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    # ---- flops, bytes and the bound of a step -----------------------------
    def pairs(sq, sk, causal, window):
        """(q, k) pairs attended per batch row and head."""
        if not causal:
            return sq * sk
        return sum(min(i + 1, window or sk) for i in range(sq))

    def step_costs(cfg, params, b, s):
        """Model flops of a step (6 N T + 3 x the attention's forward),
        remat's extra forward flops, N (params a token uses) and the
        params' count."""
        hd = cfg.resolved_head_dim
        t = b * s

        def active(block):
            n = sum(p.numel() for p in block.parameters())
            if "moe" in block:
                idle = 1 - cfg.top_k / cfg.n_experts
                n -= sum(block["moe"][k].numel() * idle
                         for k in ("w1", "w2", "w3") if k in block["moe"])
            return n

        def stack(layers, plan, causal, s_q, cross):
            """(active params, attention forward flops), total and of the
            rematerialised periods."""
            n_pre, k = len(plan.prefix_kinds), len(plan.period_kinds)
            tot, rem = [0, 0], [0, 0]
            for i, (kind, _) in enumerate(TT.layer_kinds(plan)):
                att = 0
                if kind in ("global", "local"):
                    w = cfg.window if kind == "local" else None
                    att = 4 * b * cfg.n_heads * hd * pairs(s_q, s_q, causal,
                                                           w)
                    if cross:
                        att += 4 * b * cfg.n_heads * hd * s_q * s
                n = active(layers[i])
                tot[0] += n
                tot[1] += att
                if n_pre <= i < n_pre + plan.n_periods * k:
                    rem[0] += n
                    rem[1] += att
            return tot, rem

        n_all = sum(p.numel() for p in params.parameters())
        dec_tot, dec_rem = stack(params["dec"], TT.make_plan(
            cfg, cfg.n_layers), True, s, cfg.is_encdec)
        n_act = n_all - sum(sum(p.numel() for p in blk.parameters())
                            - active(blk) for blk in params["dec"])
        attn, rem_n, rem_att = dec_tot[1], dec_rem[0], dec_rem[1]
        if cfg.is_encdec:
            enc_plan = TT.make_plan(cfg, cfg.enc_layers,
                                    force_dense_pattern=True, moe_ok=False)
            enc_tot, enc_rem = stack(params["enc"], enc_plan, False, s,
                                     False)
            attn += enc_tot[1]
            rem_n += enc_rem[0]
            rem_att += enc_rem[1]
        model_flops = 6 * n_act * t + 3 * attn
        remat_flops = 2 * rem_n * t + rem_att
        return model_flops, remat_flops, n_act, n_all

    # ---- a launcher phase -------------------------------------------------
    def launcher_phase(role, steps, ckpt_dir=None):
        cfg = h.cfgs[role]
        phase = f"train:{cfg.name}"
        free()
        got = {}
        real_train, real_make, real_save = LT.train, LT.make_train_step, \
            TL.store.save

        def making(model, opt, **kw):
            got.update(model=model, opt=opt, step_kw=kw)
            return real_make(model, opt, **kw)

        def saving(path, step, tree, extra=None):
            got["disk"] = shutil.disk_usage(os.path.dirname(path)
                                            or ".")._asdict()
            t0 = time.perf_counter()
            out = real_save(path, step, tree, extra)
            got["save_s"] = time.perf_counter() - t0
            return out

        def training(**kw):
            params, state = kw["params"], kw["opt_state"]
            got["before"] = {n: float(p.detach().sum(dtype=torch.float64))
                             for n, p in trainable(params).items()}
            got["built_peak_gib"] = peak_gib()
            params, state, hist = real_train(**kw)
            got["history"] = hist
            got["after"] = {n: float(p.detach().sum(dtype=torch.float64))
                            for n, p in trainable(params).items()}
            got["master"] = {n: float(w.sum(dtype=torch.float64))
                             for n, w in state.master.items()}
            got["peak_train_gib"] = peak_gib()
            # one more step with the optimizer's share marked, then the
            # profiler over h.trace_steps more
            step_fn, data = kw["step_fn"], kw["data"]
            batch = on_dev(data.next())
            marks = {}
            update = AdamW.update

            def marked_update(self, *a, **k):
                marks["opt0"] = mark()
                out = update(self, *a, **k)
                marks["opt1"] = mark()
                return out
            AdamW.update = marked_update
            try:
                m0 = mark()
                _, _, met = step_fn(params, state, batch)
                float(met["loss"])
            finally:
                AdamW.update = update
            got["fwd_bwd_ms"] = between(m0, marks["opt0"])
            got["opt_ms"] = between(marks["opt0"], marks["opt1"])
            got["trace"] = h.trace(
                lambda: float(step_fn(params, state, batch)[2]["loss"]),
                n=h.trace_steps)
            got["costs"] = step_costs(cfg, params, h.batch, h.seq)
            got["n_tensors"] = (len(list(params.parameters())),
                                len(state.master))
            return params, state, hist

        argv = ["--arch", cfg.name.removesuffix("-smoke"), "--steps",
                str(steps), "--batch", str(h.batch), "--seq", str(h.seq),
                "--lr", "3e-4", "--schedule", "wsd", "--device", str(dev)]
        argv += ["--smoke"] if h.smoke else []
        argv += ["--ckpt", ckpt_dir] if ckpt_dir else []
        # a config cut in depth (GROUP_DEPTH) goes in as the launcher's
        # depth options
        base = (TCFG.smoke if h.smoke else TCFG.get)(
            cfg.name.removesuffix("-smoke"))
        if cfg.n_layers != base.n_layers:
            argv += ["--n-layers", str(cfg.n_layers)]
        if cfg.enc_layers != base.enc_layers:
            argv += ["--enc-layers", str(cfg.enc_layers)]
        h.reset_counts()
        LT.train, LT.make_train_step, TL.store.save = training, making, \
            saving
        t0 = time.perf_counter()
        try:
            hist = LT.main(argv)
        finally:
            LT.train, LT.make_train_step, TL.store.save = real_train, \
                real_make, real_save
        wall = time.perf_counter() - t0
        launched = counted(phase)
        require(hist is got["history"], f"{phase}: not the loop's history")
        losses, gn = hist["losses"], hist["grad_norms"]
        moved = [n for n in got["before"]
                 if got["after"][n] != got["before"][n]]
        masters = [n for n in got["before"]
                   if got["master"][n] != got["before"][n]]
        failed = [what for ok, what in (
            (len(losses) == steps and len(gn) == steps,
             f"{len(losses)} steps of {steps}"),
            (all(np.isfinite(losses)) and all(np.isfinite(gn)),
             "a loss or grad norm is not finite"),
            (np.mean(losses[-2:]) < losses[0], "the loss did not fall"),
            (len(masters) == len(got["before"]),
             f"{len(got['before']) - len(masters)} masters did not move"),
            (len(moved) >= len(got["before"]) // 2,
             f"only {len(moved)} params moved")) if not ok]
        times = [1e3 * t for t in hist["times"]]
        step_ms = quartiles(times[1:])
        model_flops, remat_flops, n_act, n_all = got["costs"]
        tok = h.batch * h.seq
        sec = step_ms[0] / 1e3
        bound_ms = 1e3 * (8 * n_act * tok / h.BF16_FLOPS
                          + OPT_BYTES_PER_PARAM * n_all / h.HBM)
        tr = got["trace"]
        row = {"config": {"name": cfg.name, "family": cfg.family,
                          "n_layers": cfg.n_layers,
                          "enc_layers": cfg.enc_layers,
                          "d_model": cfg.d_model, "vocab": cfg.vocab,
                          "dtype": cfg.param_dtype, "n_params": n_all,
                          "n_active": int(n_act)},
               "argv": argv, "steps": steps, "batch": h.batch,
               "seq": h.seq, "tokens_per_step": tok,
               "step_kw": got["step_kw"], "wall_s": wall,
               "step_ms": step_ms, "step_ms_all": times,
               "tokens_per_s": tok / sec,
               "mfu": model_flops / sec / h.BF16_FLOPS,
               "hfu": (model_flops + remat_flops) / sec / h.BF16_FLOPS,
               "model_tflop_per_step": model_flops / 1e12,
               "remat_tflop_per_step": remat_flops / 1e12,
               "bound_ms": bound_ms,
               "bound_split_ms": {
                   "flops": 1e3 * 8 * n_act * tok / h.BF16_FLOPS,
                   "optimizer_bytes": 1e3 * OPT_BYTES_PER_PARAM * n_all
                   / h.HBM},
               "share_of_bound": bound_ms / step_ms[0],
               "fwd_bwd_ms": got["fwd_bwd_ms"], "opt_ms": got["opt_ms"],
               "device_ms_per_step": tr["device_ms"],
               "idle_share": 1.0 - tr["device_ms"] / step_ms[0],
               "kernels_per_step": tr.get("kernels_per_call"),
               "profile_step": tr,
               "losses": losses, "grad_norms": gn, "lrs": hist["lrs"],
               "stragglers": hist["stragglers"],
               "params_moved": len(moved), "masters_moved": len(masters),
               "param_tensors": got["n_tensors"][0],
               "trained_tensors": got["n_tensors"][1],
               "built_peak_gib": got["built_peak_gib"],
               "peak_gib": got["peak_train_gib"],
               "peak_gib_with_measurement": peak_gib(),
               "launches": launched, "failed": failed}
        if ckpt_dir:
            last = store.latest_step(ckpt_dir)
            require(last == steps, f"{phase}: latest checkpoint {last}")
            d = os.path.join(ckpt_dir, f"step_{steps:010d}")
            require(os.path.exists(os.path.join(d, "_COMMITTED")),
                    f"{phase}: checkpoint not committed")
            man = store.manifest(ckpt_dir, steps)
            n_p, n_t = got["n_tensors"]
            require(len(man["leaves"]) == n_p + 1 + 3 * n_t,
                    f"{phase}: {len(man['leaves'])} leaves")
            require(man["extra"]["data"] == {"seed": 0, "step": steps},
                    f"{phase}: data state {man['extra']}")
            row["checkpoint"] = {
                "step": last, "leaves": len(man["leaves"]),
                "bytes": sum(os.path.getsize(os.path.join(d, f))
                             for f in os.listdir(d)),
                "save_s": got["save_s"], "disk_before": got["disk"]}
            shutil.rmtree(ckpt_dir)
        emit(phase, **row)
        require(not failed, f"{phase}: {failed}: losses {losses}, grad "
                            f"norms {gn}")
        got.clear()
        return row

    # ---- train:resume -----------------------------------------------------
    def resume_phase():
        cfg = dataclasses.replace(h.cfgs["main"], n_layers=h.resume_layers)
        phase = "train:resume"
        free()
        ck = os.path.join(h.tmp, "resume")
        os.makedirs(ck, exist_ok=True)
        disk = shutil.disk_usage(ck)._asdict()

        def fresh():
            model = build_model(cfg, device=dev)
            params = model.init(torch.Generator(device=dev).manual_seed(
                h.seed))
            opt = AdamW(lr_fn=wsd(3e-4, warmup=1, stable=2, decay=1))
            state = opt.init(params)
            step = make_train_step(model, opt, q_chunk=128, k_chunk=128)
            return params, state, step, for_config(cfg, batch=h.batch,
                                                   seq=h.seq)

        def host(tree):
            return [(n, t.detach().to("cpu", copy=True))
                    for n, t in store.leaves(tree)]

        seen = {"a": [], "b": []}
        snap = {}

        def wrap(step, key):
            def fn(params, state, batch):
                seen[key].append({k: v.cpu() for k, v in batch.items()})
                if key == "b" and len(seen["b"]) == 1:
                    snap["restored"] = host((params, state))
                out = step(params, state, batch)
                if key == "a" and len(seen["a"]) == 2:
                    snap["step2"] = host(out[:2])
                return out
            return fn

        h.reset_counts()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            params, state, step, data = fresh()
            t0 = time.perf_counter()
            _, _, ha = TL.train(step_fn=wrap(step, "a"), params=params,
                                opt_state=state, data=data, steps=4,
                                ckpt_dir=ck, ckpt_every=2,
                                log_fn=lambda s: None)
            t_a = time.perf_counter() - t0
            del params, state, step, data
            free()
            require(store.latest_step(ck) == 4, f"{phase}: no step 4")
            ck_bytes = sum(os.path.getsize(os.path.join(ck, d, f))
                           for d in os.listdir(ck)
                           for f in os.listdir(os.path.join(ck, d)))
            shutil.rmtree(os.path.join(ck, f"step_{4:010d}"))
            log = []
            params, state, step, data = fresh()
            t0 = time.perf_counter()
            _, _, hb = TL.train(step_fn=wrap(step, "b"), params=params,
                                opt_state=state, data=data, steps=4,
                                ckpt_dir=ck, ckpt_every=2, log_fn=log.append)
            t_b = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)
        launched = counted(phase)
        require(log and log[0] == "[resume] restored step 2",
                f"{phase}: {log[:1]}")
        names = [n for n, _ in snap["step2"]]
        require(names == [n for n, _ in snap["restored"]],
                f"{phase}: leaf names differ")
        diff = [n for (n, a), (_, b) in zip(snap["step2"], snap["restored"])
                if not (a.dtype == b.dtype and torch.equal(a, b))]
        require(not diff, f"{phase}: restored leaves differ: {diff[:5]}")
        man = store.manifest(ck, 2)
        on_disk = [m["name"] for (_, a), m in zip(snap["step2"],
                                                  man["leaves"])
                   if not torch.equal(store.load_leaf(ck, 2, m), a)]
        require(not on_disk, f"{phase}: stored leaves differ: {on_disk[:5]}")
        require(man["extra"]["data"] == {"seed": 0, "step": 2},
                f"{phase}: data state {man['extra']}")
        require(all(torch.equal(seen["a"][2][k], seen["b"][0][k])
                    for k in seen["a"][2]), f"{phase}: another batch")
        la, lb = ha["losses"][2:], hb["losses"]
        rel = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
        require(len(lb) == 2 and rel <= RESUME_TOL,
                f"{phase}: resumed losses {lb} vs {la}")
        n_all = sum(t.numel() for n, t in snap["step2"]
                    if n.startswith("0/"))
        row = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                          "d_model": cfg.d_model, "vocab": cfg.vocab,
                          "n_params": n_all},
               "cut": f"n_layers {h.cfgs['main'].n_layers} -> "
                      f"{cfg.n_layers}",
               "disk_before": disk, "checkpoint_bytes_step2_and_4": ck_bytes,
               "leaves": len(names), "leaves_restored_bit_equal": True,
               "losses_uninterrupted": ha["losses"], "losses_resumed": lb,
               "losses_max_rel_diff": rel, "losses_bit_equal": la == lb,
               "grad_norms_bit_equal": ha["grad_norms"][2:]
               == hb["grad_norms"],
               "run_s": t_a, "resumed_run_s": t_b, "peak_gib": peak_gib(),
               "launches": launched}
        shutil.rmtree(ck)
        emit(phase, **row)
        return row

    # ---- train:parity -----------------------------------------------------
    def parity_phase():
        phase = "train:parity"
        free()
        out = {}
        h.reset_counts()
        for name in SLICE10_PARITY:
            cfg = TCFG.smoke(name)
            cpu = torch.device("cpu")
            mc, md = build_model(cfg, device=cpu), build_model(cfg, device=dev)
            pc = mc.init(torch.Generator().manual_seed(h.seed))
            g = torch.Generator().manual_seed(h.seed + 1)
            with torch.no_grad():
                for p in pc.parameters():
                    p.add_(0.02 * torch.randn(p.shape, generator=g))
            pd = copy.deepcopy(pc).to(dev)
            batch = for_config(cfg, batch=h.batch, seq=h.seq).next()
            res = {}
            for key, model, params in (("cpu", mc, pc), ("dev", md, pd)):
                opt = AdamW(lr_fn=wsd(3e-4, 10, 50, 33))
                state = opt.init(params)
                step = make_train_step(model, opt, q_chunk=128, k_chunk=128)
                _, state, met = step(params, state, {
                    k: torch.as_tensor(v).to(params["embed"]["w"].device)
                    for k, v in batch.items()})
                res[key] = ({k: float(v) for k, v in met.items()},
                            {n: p.detach().cpu()
                             for n, p in trainable(params).items()})
            mc_, pc_ = res["cpu"]
            md_, pd_ = res["dev"]
            rel = {k: abs(md_[k] - mc_[k]) / max(abs(mc_[k]), 1e-30)
                   for k in ("loss", "nll", "grad_norm")}
            p_err = max(float((pd_[n] - pc_[n]).abs().max())
                        / max(float(pc_[n].abs().max()), 1e-30)
                        for n in pc_)
            require(max(rel.values()) <= PARITY_TOL and p_err <= PARITY_TOL,
                    f"{phase}: {name} card vs CPU {rel}, params {p_err}")
            out[name] = {"rel_err": rel, "param_max_rel_err": p_err,
                         "loss": md_["loss"], "aux": md_["aux"]}
            del mc, md, pc, pd, res
        launched = counted(phase)
        row = {"configs": out, "batch": h.batch, "seq": h.seq,
               "tol": PARITY_TOL, "launches": launched}
        emit(phase, **row)
        return row

    rows["main"] = launcher_phase("main", h.steps_main,
                                  os.path.join(h.tmp, "main"))
    for role in ("moe", "hybrid", "audio"):
        rows[role] = launcher_phase(role, h.steps_other)
    rows["resume"] = resume_phase()
    rows["parity"] = parity_phase()
    free()
    return {"launches": launches, "rows": rows,
            "seconds": time.perf_counter() - t_all}


SLICE11_MAIN = "minicpm-2b"
SLICE11_PARALLEL = "llava-next-mistral-7b"
# mesh:one: the sharded step on a one-rank (1, 1) mesh against the
# unsharded step, each of the losses relative; the same operations on
# the same card, so only DTensor's own choices of kernel can part them
MESH_ONE_TOL = 1e-6


def slice11_phases(h) -> dict:
    """The model across cards (ROADMAP 1.28) on one card.

    ``mesh:one:<main>`` (minicpm-2b, ``h.cfgs["main"]``): an NCCL group
    of one rank (gloo on the CPU) on a ``FileStore`` in ``h.tmp``, a
    (1, 1) (data, model) mesh, the config at its published width and the
    depth ``h.cfgs`` gives it (``main`` cuts it: ``GROUP_DEPTH``) in
    bf16: ``h.steps`` train steps of the unsharded model
    (``model.init``, ``make_train_step``) on batches ``h.batch`` x
    ``h.seq`` from the pipeline, the model freed, then the same steps of
    the sharded one (``train.step.init_sharded``, ``AdamW.init`` with
    ``train_state_shardings``' ZeRO-1 placements, DTensor params and a
    ``Shard(0)`` batch) from the same generator: the losses within
    MESH_ONE_TOL relative, and whether they are equal bit for bit; ms a
    step of each (the host cost of DTensor), peak memory, K1-K7 launched
    0 times.
    ``mesh:one:decode:<main>`` (the same config): a batch of
    ``h.decode_batch`` prompts of ``h.decode_prompt`` tokens prefilled
    by the unsharded model, then ``h.decode_steps`` decode steps fed the
    next tokens; then the same on a one-rank (1, 1) mesh with DTensor
    params under ``rules_for("decode", ...)``, the cache laid out by
    ``Model.cache_specs()``: every step's logits within MESH_ONE_TOL
    relative to their max, and whether they are equal bit for bit; ms
    a step of each.
    ``lm:parallel_block:<vlm>`` (llava-next-mistral-7b with
    ``parallel_block=True``, ``h.cfgs["parallel"]``): bf16 at full width
    and depth, a batch of ``h.pb_batch`` prompts of ``h.pb_prompt``
    tokens after the frontend's patches; prefill, then ``h.pb_steps``
    decode steps fed the next prompt tokens, against one prefill of the
    longer prompt (PREFILL_TOL, and the softmax check of the cross
    phases); the same params with the sequential block must move the
    logits (the flag is live).
    Returns the launches of the repo's kernels and the phases' rows."""
    import dataclasses
    import datetime
    import gc

    import numpy as np
    import torch
    import torch.distributed as tdist

    from repro_torch.data.pipeline import for_config
    from repro_torch.launch import mesh as LM
    from repro_torch.models import build_model
    from repro_torch.models import sharding as MS
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedules import wsd
    from repro_torch.train import step as ST

    dev = h.dev
    require, emit = h.require, h.emit
    cuda = dev.type == "cuda"
    launches, rows = {}, {}
    t_all = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def free():
        gc.collect()
        if cuda:
            sync()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda \
            else None

    def counted(phase):
        launched, plain_calls = h.counts()
        h.plain_free(plain_calls, phase)
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
        require(not any(launched.values()),
                f"{phase}: a kernel of the repo launched: {launched}")
        return launched

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm((a - b).float())
                     / torch.linalg.vector_norm(b.float()))

    # ---- mesh:one -- the sharded step on a one-rank mesh -----------------
    def mesh_one():
        cfg = h.cfgs["main"]
        phase = f"mesh:one:{cfg.name}"
        free()
        model = build_model(cfg, device=dev)
        data = for_config(cfg, batch=h.batch, seq=h.seq)
        batches = [{k: torch.as_tensor(v).to(dev) for k, v in
                    data.next().items()} for _ in range(h.steps)]

        def opt():
            return AdamW(lr_fn=wsd(3e-4, 1, h.steps // 2, h.steps // 3))

        def run(params, state, step):
            losses, ms = [], []
            for b in batches:
                sync()
                t0 = time.perf_counter()
                params, state, m = step(params, state, b)
                losses.append(float(m["loss"]))
                ms.append(1e3 * (time.perf_counter() - t0))
            return losses, ms

        h.reset_counts()
        o = opt()
        params = model.init(torch.Generator(device=dev).manual_seed(h.seed))
        state = o.init(params)
        plain_losses, plain_ms = run(params, state, ST.make_train_step(
            model, o, q_chunk=128, k_chunk=128))
        plain_peak = peak_gib()
        del params, state
        free()
        tdist_store = tdist.FileStore(os.path.join(h.tmp, "mesh_one"), 1)
        LM.join("cpu" if not cuda else None, rank=0, world=1,
                store=tdist_store, local_rank=dev.index or 0,
                timeout=datetime.timedelta(seconds=600))
        try:
            mesh = LM.make_mesh((1, 1), ("data", "model"))
            rules = dict(MS.DEFAULT_SINGLE_POD)
            o = opt()
            with MS.use_rules(rules):
                _, osh = ST.train_state_shardings(model, mesh, rules)
                params = ST.init_sharded(
                    model, torch.Generator(device=dev).manual_seed(h.seed),
                    mesh, rules)
                state = o.init(params, shardings=osh)
                sharded = MS.is_dtensor(params["embed"]["w"])
                mesh_losses, mesh_ms = run(params, state, ST.make_train_step(
                    model, o, q_chunk=128, k_chunk=128))
            mesh_peak = peak_gib()
            del params, state
        finally:
            LM.leave()
        launched = counted(phase)
        rel = [abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(mesh_losses, plain_losses)]
        require(sharded, f"{phase}: the params are not DTensors")
        require(all(np.isfinite(mesh_losses)), f"{phase}: a loss is not "
                                               f"finite: {mesh_losses}")
        require(max(rel) <= MESH_ONE_TOL,
                f"{phase}: sharded vs unsharded losses {rel} > "
                f"{MESH_ONE_TOL}")
        row = {"mesh": {"data": 1, "model": 1},
               "batch": h.batch, "seq": h.seq, "steps": h.steps,
               "losses": mesh_losses, "losses_unsharded": plain_losses,
               "max_rel_err": max(rel),
               "bit_equal": mesh_losses == plain_losses,
               "tol": MESH_ONE_TOL, "ms_per_step": mesh_ms,
               "ms_per_step_unsharded": plain_ms,
               "peak_gib": mesh_peak, "peak_gib_unsharded": plain_peak,
               "launches": launched}
        emit(phase, **row)
        del model
        free()
        return row

    # ---- mesh:one:decode -- sharded serving on a one-rank mesh ----------
    def mesh_one_decode():
        cfg = h.cfgs["main"]
        phase = f"mesh:one:decode:{cfg.name}"
        free()
        model = build_model(cfg, device=dev)
        b, s, k = h.decode_batch, h.decode_prompt, h.decode_steps
        toks = torch.as_tensor(np.random.default_rng(h.seed + 13).integers(
            0, cfg.vocab, (b, s + k))).to(dev)
        max_len = s + k

        def serve(params, place=lambda x: x, lay_out=lambda c: c):
            logits_all, ms = [], []
            cache, logits = model.prefill(params, place({"tokens":
                                                          toks[:, :s]}),
                                          max_len=max_len)
            cache = lay_out(cache)
            logits_all.append(full(logits))
            for i in range(k):
                pos = torch.full((b,), s + i, dtype=torch.int32,
                                 device=dev)
                x = place({"t": toks[:, s + i:s + i + 1], "p": pos})
                sync()
                t0 = time.perf_counter()
                _, logits = model.decode_step(params, cache, x["t"],
                                              x["p"])
                sync()
                ms.append(1e3 * (time.perf_counter() - t0))
                logits_all.append(full(logits))
            return logits_all, ms

        def full(t):
            return (t.full_tensor() if MS.is_dtensor(t) else t)[
                ..., :cfg.vocab].float()

        h.reset_counts()
        params = model.init(torch.Generator(device=dev).manual_seed(h.seed))
        plain, plain_ms = serve(params)
        del params
        free()
        tdist_store = tdist.FileStore(os.path.join(h.tmp, "mesh_one_decode"),
                                      1)
        LM.join("cpu" if not cuda else None, rank=0, world=1,
                store=tdist_store, local_rank=dev.index or 0,
                timeout=datetime.timedelta(seconds=600))
        try:
            mesh = LM.make_mesh((1, 1), ("data", "model"))
            rules = MS.rules_for("decode", b, {"data": 1, "model": 1})
            with MS.use_rules(rules):
                params = ST.init_sharded(
                    model, torch.Generator(device=dev).manual_seed(h.seed),
                    mesh, rules)
                sharded = MS.is_dtensor(params["embed"]["w"])
                got, mesh_ms = serve(
                    params, place=lambda x: ST.place_batch(x, mesh),
                    lay_out=lambda c: MS.lay_out_cache(
                        c, model.cache_specs(), mesh))
            mesh_peak = peak_gib()
            del params
        finally:
            LM.leave()
        launched = counted(phase)
        rel = [float((a - b_).abs().max() / b_.abs().max())
               for a, b_ in zip(got, plain)]
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        require(sharded, f"{phase}: the params are not DTensors")
        require(finite, f"{phase}: non-finite logits")
        require(max(rel) <= MESH_ONE_TOL,
                f"{phase}: sharded vs unsharded logits {max(rel)} > "
                f"{MESH_ONE_TOL}")
        row = {"mesh": {"data": 1, "model": 1}, "batch": b,
               "prompt_tokens": s, "decode_steps": k,
               "max_rel_err": max(rel), "rel_err_per_step": rel,
               "bit_equal": all(torch.equal(a, b_)
                                for a, b_ in zip(got, plain)),
               "tol": MESH_ONE_TOL,
               "step_ms": [float(q) for q in np.percentile(mesh_ms[1:],
                                                           [50, 25, 75])],
               "step_ms_unsharded": [float(q) for q in np.percentile(
                   plain_ms[1:], [50, 25, 75])],
               "peak_gib": mesh_peak, "launches": launched}
        emit(phase, **row)
        del model, got, plain
        free()
        return row

    # ---- the parallel residual block at full width ------------------------
    def parallel_block():
        cfg = h.cfgs["parallel"]
        phase = f"lm:parallel_block:{cfg.name}"
        free()
        model = build_model(cfg, device=dev)
        seq_model = build_model(dataclasses.replace(cfg,
                                                    parallel_block=False),
                                device=dev)
        h.reset_counts()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(h.seed))
        sync()
        t_build = time.perf_counter() - t0
        bsz, s, k = h.pb_batch, h.pb_prompt, h.pb_steps
        gen = torch.Generator(device=dev).manual_seed(h.seed + 11)
        fe = torch.randn((bsz, cfg.frontend_seq, cfg.d_model), generator=gen,
                         device=dev).to(model.adt)
        toks = np.random.default_rng(h.seed + 11).integers(
            0, cfg.vocab, (bsz, s + k)).astype(np.int32)
        n_front, max_len = cfg.frontend_seq, cfg.frontend_seq + s + k + 8
        sync()
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, {"tokens": toks[:, :s],
                                               "frontend": fe},
                                      max_len=max_len)
        sync()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        finite = bool(torch.isfinite(logits[..., :cfg.vocab]).all())
        step_ms = []
        for i in range(k):
            t0 = time.perf_counter()
            cache, logits = model.decode_step(
                params, cache, toks[:, s + i:s + i + 1],
                np.full(bsz, n_front + s + i, np.int32))
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            finite &= bool(torch.isfinite(logits[..., :cfg.vocab]).all())
        # the longer prefill ends at the last fed token
        _, l_full = model.prefill(params, {"tokens": toks[:, :s + k],
                                           "frontend": fe}, max_len=max_len)
        _, l_seq = seq_model.prefill(params, {"tokens": toks[:, :s + k],
                                              "frontend": fe},
                                     max_len=max_len)
        launched = counted(phase)
        a = logits[:, -1, :cfg.vocab].float()
        b = l_full[:, -1, :cfg.vocab].float()
        pa, pb = torch.softmax(a, -1), torch.softmax(b, -1)
        p_err = float(((pa - pb).abs() - 1e-2 * pb.abs()).max())
        s_rel = rel_l2(a, b)
        live = rel_l2(l_seq[:, -1, :cfg.vocab], b)
        require(finite, f"{phase}: non-finite logits")
        require(p_err <= 5e-3, f"{phase}: prefill + {k} steps vs longer "
                               f"prefill in softmax {p_err} > 5e-3 + 1e-2 "
                               f"|p|")
        require(s_rel <= PREFILL_TOL, f"{phase}: prefill + {k} steps vs "
                                      f"longer prefill {s_rel} > "
                                      f"{PREFILL_TOL}")
        require(live > 1e-3, f"{phase}: the sequential block moved the "
                             f"logits by only {live}")
        row = {"parallel_block": True, "build_s": t_build, "batch": bsz,
               "frontend_seq": n_front, "prompt_tokens": s,
               "decode_steps": k, "prefill_ms": prefill_ms,
               "step_ms": [float(q) for q in np.percentile(step_ms[1:],
                                                           [50, 25, 75])],
               "steps_vs_longer_prefill_rel_l2": s_rel,
               "steps_vs_longer_prefill_softmax_excess": p_err,
               "sequential_block_rel_l2": live, "tol": PREFILL_TOL,
               "launches": launched, "peak_gib": peak_gib()}
        emit(phase, **row)
        del model, seq_model, params, cache
        free()
        return row

    rows["mesh_one"] = mesh_one()
    rows["mesh_one_decode"] = mesh_one_decode()
    rows["parallel_block"] = parallel_block()
    return {"launches": launches, "rows": rows,
            "seconds": time.perf_counter() - t_all}


# ---- the twelfth slice: the reference's examples, the recorder's peak ----
# The examples' own checks.  Products (quickstart's op @ x, op.T @ y and
# the x-gradient, cg_solver's op.T @ b) against float64 host products:
# max |err| <= EX_ROUND_OFF * max |ref|, f32 round-off.  eigensolver:
# the extremal Ritz values of Lanczos m = 100 and the polished one
# against numpy.linalg.eigvalsh on the dense HMEp (spectrum about
# +-6.3), absolute.  cg_solver: every solve converged at its tolerance
# (CG 1e-6, block CG 2e-6) and its true residual within 1.5 x of it.
# train_lm: finite losses, the last below the first.
EX_ROUND_OFF = 1e-5
EX_EIG_TOL = 1e-4
EX_RES_SLACK = 1.5
EXAMPLE_ARGS = {"quickstart": [], "eigensolver": [],
                "cg_solver": ["--side", "48"], "serve_solver": [],
                "serve_lm": [], "train_lm": ["--steps", "20"]}
# dryrun:peak: minicpm-2b cut to this many layers, one real train step
# of batch 8 x 256 (bf16, remat) under the dry run's recorder; its peak
# over torch.cuda.max_memory_allocated() must lie in PEAK_RATIO (a count
# of the wrong kind, such as the global-shape tensors MemTracker counted,
# falls outside; the allocator's rounding does not)
PEAK_LAYERS = 4
PEAK_RATIO = (0.5, 1.5)
# the dry run's peak carried from its plan's steps to PEAK_LAYERS against
# the recorder's peak of the PEAK_LAYERS step, in units of what one layer
# adds to the peak (a rule that misses a layer's growth reads >= 1)
PEAK_EXTRAP_TOL = 0.5


def slice12_phases(h) -> dict:
    """The reference's last surface on the card.

    ``examples:<name>``: each of ``repro_torch.examples``' six modules
    through ``main(["--device", <h.dev>, *h.example_args[name]])`` (on
    the card ``EXAMPLE_ARGS``: the reference's sizes, cg_solver's side
    48, ``train_lm`` 20 steps), its printed lines
    captured into the phase's row, launch counts set to 0 before it and
    read after it, and its own checks required (the constants above).
    Together the six must launch K1, K5 and K7.
    ``dryrun:peak``: ``h.cfgs["peak"]`` (minicpm-2b cut to
    PEAK_LAYERS) built on the card, one warm-up train step, then the
    peak statistics reset with the step's arguments resident and one
    step under ``launch.comm_analysis.StepRecorder``: the recorder's
    peak over ``torch.cuda.max_memory_allocated()``, and over that peak
    less what earlier phases left allocated (``main`` keeps its sAMG
    operands), both within PEAK_RATIO; the recorder's flops and bytes
    beside the step's time.  Then the dry run's depth plan for that
    config (``launch.dryrun.traced_configs``: 1, 2 and 3 layers), each
    step recorded alike, and ``launch.dryrun.extrapolate`` carries them
    to PEAK_LAYERS: the flops and bytes equal to the full step's, the
    peak within PEAK_EXTRAP_TOL of one layer's growth of the
    recorder's.
    Returns the launches of the examples, and the rows."""
    import contextlib
    import gc
    import importlib
    import io

    import numpy as np
    import torch

    from repro_torch.data.pipeline import for_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.comm_analysis import StepRecorder
    from repro_torch.models import build_model
    from repro_torch.train import step as ST
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedules import wsd

    dev = h.dev
    require, emit = h.require, h.emit
    cuda = dev.type == "cuda"
    launches, rows = {}, {}
    t_all = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def free():
        gc.collect()
        if cuda:
            sync()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def close(err, ref):
        return err <= EX_ROUND_OFF * max(ref, 1e-30)

    def check(name, out):
        if name == "quickstart":
            require(close(out["matvec_err"], out["y_ref_max"])
                    and out["rmatvec_rel_err"] <= EX_ROUND_OFF
                    and close(out["grad_err"], out["grad_ref_max"]),
                    f"quickstart: op @ x {out['matvec_err']}, op.T @ y "
                    f"{out['rmatvec_rel_err']}, grad {out['grad_err']}")
            require(out["pjds_elements"] < out["ell_elements"],
                    "quickstart: pJDS stores no less than ELLPACK")
        elif name == "eigensolver":
            require(max(out["err_lanczos_max"], out["err_lanczos_min"],
                        out["err_polished"]) <= EX_EIG_TOL,
                    f"eigensolver vs eigvalsh: Lanczos "
                    f"{out['err_lanczos_min']} / {out['err_lanczos_max']}, "
                    f"polished {out['err_polished']} > {EX_EIG_TOL}")
            require(out["solve_status"] == "converged",
                    f"eigensolver: inner solve {out['solve_status']}")
        elif name == "cg_solver":
            modes = out["modes"]
            require(all(r["status"] == "converged" and r["rel_res"] <= 1e-6
                        for r in modes.values())
                    and len({r["iters"] for r in modes.values()}) == 1
                    and out["ranks_agree"],
                    f"cg_solver: modes {modes}")
            require(out["jacobi"]["status"] == "converged"
                    and out["block_cg"]["status"] == "converged"
                    and out["bicgstab"]["status"] == "converged",
                    "cg_solver: jacobi / block CG / BiCGStab did not "
                    "converge")
            require(out["block_cg"]["true_res"] <= 2e-6 * EX_RES_SLACK
                    and out["bicgstab"]["true_res"] <= 1e-6 * EX_RES_SLACK
                    and out["cg_true_res"] <= 1e-6 * EX_RES_SLACK,
                    f"cg_solver true residuals: block "
                    f"{out['block_cg']['true_res']}, BiCGStab "
                    f"{out['bicgstab']['true_res']}, CG "
                    f"{out['cg_true_res']}")
            require(out["transpose_rel_err"] <= EX_ROUND_OFF,
                    f"cg_solver op.T: {out['transpose_rel_err']}")
        elif name == "serve_solver":
            st = out["statuses"]
            require(st.count("shed") == 1 and st.count("converged")
                    == len(st) - 1, f"serve_solver: {st}")
        elif name == "serve_lm":
            require(all(out["done"]) and all(len(t) == 8
                                             for t in out["tokens"]),
                    f"serve_lm: {out['tokens']}")
        elif name == "train_lm":
            ls = out["losses"]
            require(len(ls) == out["steps"] and all(np.isfinite(ls))
                    and ls[-1] < ls[0], f"train_lm: losses {ls}")

    for name, extra in h.example_args.items():
        phase = f"examples:{name}"
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        free()
        buf = io.StringIO()
        h.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main(["--device", str(dev), *extra])
        sync()
        seconds = time.perf_counter() - t0
        launched, plain_calls = h.counts()
        h.plain_free(plain_calls, phase)
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
        check(name, out)
        rows[name] = {"seconds": seconds, "launches": launched,
                      "result": out,
                      "printed": buf.getvalue().splitlines()[-40:],
                      "peak_gib": torch.cuda.max_memory_allocated(dev)
                      / 2 ** 30 if cuda else None}
        emit(phase, **rows[name])
    for k in ("pjds_spmv", "pjds_spmm", "transpose_spmv"):
        require(launches.get(k, 0) >= 1,
                f"examples: {k} was not launched: {launches}")

    # ---- dryrun:peak -- the recorder's peak against the allocator's -----
    cfg = h.cfgs["peak"]
    phase = "dryrun:peak"
    free()
    # what earlier phases leave resident is not the step's
    before = torch.cuda.memory_allocated(dev) if cuda else None

    def warm_step(c):
        """``c``'s model, state, a train step warmed up on one batch, and
        the next batch."""
        model = build_model(c, device=dev)
        o = AdamW(lr_fn=wsd(3e-4, 1, 1, 1))
        params = model.init(torch.Generator(device=dev).manual_seed(h.seed))
        state = o.init(params)
        data = for_config(c, batch=h.batch, seq=h.seq)
        batches = [{k: torch.as_tensor(v).to(dev) for k, v in
                    data.next().items()} for _ in range(2)]
        step = ST.make_train_step(model, o, q_chunk=128, k_chunk=128)
        params, state, m0 = step(params, state, batches[0])
        loss0 = float(m0["loss"])
        del m0
        gc.collect()
        sync()
        return step, params, state, batches[1], loss0

    h.reset_counts()
    step, params, state, batch, loss0 = warm_step(cfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev) if cuda else None
    rec = StepRecorder()
    held = rec.hold(params, state, batch)
    t0 = time.perf_counter()
    with rec:
        params, state, m1 = step(params, state, batch)
    sync()
    seconds = time.perf_counter() - t0
    loss1 = float(m1["loss"])
    peak_alloc = torch.cuda.max_memory_allocated(dev) if cuda else None
    launched, plain_calls = h.counts()
    h.plain_free(plain_calls, phase)
    require(not any(launched.values()),
            f"{phase}: a kernel of the repo launched: {launched}")
    ratio = rec.peak_bytes / peak_alloc if peak_alloc else None
    own = peak_alloc - before if cuda else None
    ratio_own = rec.peak_bytes / own if own else None
    require(np.isfinite([loss0, loss1]).all(),
            f"{phase}: losses {loss0}, {loss1}")
    if cuda:
        for what, r, alloc in (("max_memory_allocated", ratio, peak_alloc),
                               ("its rise over the phase's start",
                                ratio_own, own)):
            require(PEAK_RATIO[0] <= r <= PEAK_RATIO[1],
                    f"{phase}: recorder peak {rec.peak_bytes} over {what} "
                    f"{alloc} = {r}, outside {PEAK_RATIO}")
    n_params = sum(p.numel() for p in params.parameters())
    full = {"peak": rec.peak_bytes, "held": held, "bytes": rec.bytes,
            "flops": rec.flops}
    del step, params, state, batch, rec, m1
    free()

    # the dry run's depth plan: the same step at its plan's depths,
    # recorded, and the dry run's extrapolate carrying them to 4
    t_var = time.perf_counter()
    plan = DR._depth_variants(cfg)
    traces = {}
    for c in DR.traced_configs(plan, "train"):
        step, params, state, batch, _ = warm_step(c)
        r = StepRecorder()
        a = r.hold(params, state, batch)
        with r:
            out = step(params, state, batch)
        traces[c] = {"flops": r.flops, "bytes": r.bytes,
                     "collectives": r.collectives,
                     "memory": {"temp_size_in_bytes": r.peak_bytes - a,
                                "output_size_in_bytes":
                                    DR._storage_bytes(out)}}
        del step, params, state, batch, r, out
        free()
    ex = DR.extrapolate(plan, traces, full["held"], "train")
    extrap, (slope,) = ex["peak_bytes"], ex["slopes"]
    # in layers' growth: 0 when exact
    extrap_err = abs(extrap - full["peak"]) / max(abs(slope), 1)
    require(extrap_err <= PEAK_EXTRAP_TOL,
            f"{phase}: peak carried from {list(traces)} {extrap} vs the "
            f"recorder's {full['peak']} at {cfg.n_layers} layers: off by "
            f"{extrap_err} x a layer's {slope} B > {PEAK_EXTRAP_TOL}")
    require(ex["counts"]["flops"] == full["flops"]
            and ex["counts"]["bytes"] == full["bytes"],
            f"{phase}: flops / bytes carried from 1-2 layers "
            f"{ex['counts']['flops']} / {ex['counts']['bytes']} vs "
            f"{full['flops']} / {full['bytes']}")
    rows["peak"] = {"arch": cfg.name, "n_layers": cfg.n_layers,
                    "n_params": n_params, "batch": h.batch, "seq": h.seq,
                    "remat": True, "dtype": cfg.param_dtype,
                    "recorder_peak_bytes": full["peak"],
                    "recorder_held_bytes": full["held"],
                    "max_memory_allocated": peak_alloc,
                    "memory_allocated_at_reset": resident,
                    "memory_allocated_before_phase": before,
                    "max_memory_allocated_over_phase_start": own,
                    "ratio": ratio, "ratio_over_phase_start": ratio_own,
                    "ratio_limits": list(PEAK_RATIO),
                    "recorder_bytes": full["bytes"],
                    "recorder_flops": full["flops"],
                    "step_s_under_recorder": seconds,
                    "losses": [loss0, loss1], "launches": launched,
                    "variants": [{"kind": v.kind, "count": v.count}
                                 for v in plan],
                    "traced_layers": [c.n_layers for c in traces],
                    "variant_steps": [{"n_layers": c.n_layers,
                                       "temp": t["memory"][
                                           "temp_size_in_bytes"],
                                       "flops": t["flops"]}
                                      for c, t in traces.items()],
                    "extrapolated_peak_bytes": extrap,
                    "layer_peak_growth_bytes": slope,
                    "extrapolated_peak_err_layers": extrap_err,
                    "extrapolated_peak_tol": PEAK_EXTRAP_TOL,
                    "variants_s": time.perf_counter() - t_var,
                    "card": nvidia_smi_line() if cuda else None}
    emit(phase, **rows["peak"])
    return {"launches": launches, "rows": rows,
            "seconds": time.perf_counter() - t_all}


ATTN_MAIN = "minicpm-2b"


def attn_impl_phases(h) -> dict:
    """The reference's attention switch on the card.

    ``attn:qloop:<main>`` (minicpm-2b, ``h.cfgs["main"]``: published
    width, depth as given), bf16, attention in chunks of ``h.chunk`` so
    that a sequence of ``h.seq`` walks several q chunks.  Under each
    schedule -- ``use_attn_impl("pairs")`` and ``"qloop"`` -- a prefill
    of ``h.prefill_batch`` prompts (``torch.no_grad``, params drawn from
    ``h.seed``; its peak, then ``h.prefill_reps`` calls of each schedule
    in turns, timed by CUDA events), then ``h.train_steps`` train steps
    on batches ``h.batch`` x ``h.seq`` from params drawn again
    (``make_train_step``, AdamW, host clock around a step ending in the
    loss read), under the pair loop, the q-loop and the pair loop again
    (the order's share of a difference in step time).  The q-loop's last
    logits, prefill cache and every loss must equal the pair loop's bit
    for bit (the two visit the same pairs in the same order with the
    same operations); the grad norms and the params after the steps are
    compared and reported.  Reports ms and peak memory of each
    schedule's prefill and steps, K1-K7 launched 0 times.
    Returns the launches of the repo's kernels and the phase's row."""
    import gc

    import numpy as np
    import torch

    from repro_torch.data.pipeline import for_config
    from repro_torch.models import build_model
    from repro_torch.models.attention import get_attn_impl, use_attn_impl
    from repro_torch.train.optimizer import AdamW, trainable
    from repro_torch.train.schedules import wsd
    from repro_torch.train.step import make_train_step

    dev = h.dev
    require, emit = h.require, h.emit
    cuda = dev.type == "cuda"
    t_all = time.perf_counter()
    cfg = h.cfgs["main"]
    phase = f"attn:qloop:{cfg.name}"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def free():
        gc.collect()
        if cuda:
            sync()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda \
            else None

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def between(a, b):
        sync()
        return a.elapsed_time(b) if cuda else 1e3 * (b - a)

    def on_host(cache, logits):
        """The prefill's last logits and every cache tensor, copied to
        the host so that the next schedule's peak does not hold them."""
        return (logits.float().cpu(),
                [t.cpu() for layer in cache for t in layer.values()
                 if isinstance(t, torch.Tensor)])

    free()
    model = build_model(cfg, device=dev)
    toks = torch.as_tensor(np.random.default_rng(h.seed + 16).integers(
        0, cfg.vocab, (h.prefill_batch, h.seq))).to(dev)
    data = for_config(cfg, batch=h.batch, seq=h.seq, seed=h.seed)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in
                data.next().items()} for _ in range(h.train_steps)]
    chunks = dict(q_chunk=h.chunk, k_chunk=h.chunk)
    impls = ("pairs", "qloop")
    h.reset_counts()
    got = {impl: {} for impl in impls}
    # prefill: one set of params, each schedule's output and peak, then
    # the two timed in turns (so neither holds the other's order)
    params = model.init(torch.Generator(device=dev).manual_seed(h.seed))
    with torch.no_grad():
        for impl in impls:
            with use_attn_impl(impl):
                require(get_attn_impl() == impl, f"{phase}: switch not set")
                sync()
                if cuda:
                    torch.cuda.reset_peak_memory_stats(dev)
                out = model.prefill(params, {"tokens": toks},
                                    max_len=h.seq, **chunks)
                got[impl]["prefill_peak_gib"] = peak_gib()
                got[impl]["prefill"] = on_host(*out)
                del out
        ms = {impl: [] for impl in impls}
        for _ in range(h.prefill_reps):
            for impl in impls:
                with use_attn_impl(impl):
                    a = mark()
                    model.prefill(params, {"tokens": toks}, max_len=h.seq,
                                  **chunks)
                    ms[impl].append(between(a, mark()))
    del params
    # train steps from the same params under each schedule, the pair
    # loop again last: the step times' order effect
    for impl in ("pairs", "qloop", "pairs"):
        key = impl if "steps" not in got[impl] else "pairs_again"
        with use_attn_impl(impl):
            free()
            params = model.init(torch.Generator(device=dev).manual_seed(
                h.seed))
            opt = AdamW(lr_fn=wsd(3e-4, 1, h.train_steps, 1))
            state = opt.init(params)
            step = make_train_step(model, opt, **chunks)
            losses, gns, step_ms = [], [], []
            for b in batches:
                sync()
                t0 = time.perf_counter()
                params, state, met = step(params, state, b)
                losses.append(float(met["loss"]))
                step_ms.append(1e3 * (time.perf_counter() - t0))
                gns.append(float(met["grad_norm"]))
            got.setdefault(key, {}).update(
                steps=True, losses=losses, grad_norms=gns, step_ms=step_ms,
                train_peak_gib=peak_gib(),
                param_sums=[float(p.detach().sum(dtype=torch.float64))
                            for p in trainable(params).values()])
            del params, state, step, opt, met
    launched, plain_calls = h.counts()
    h.plain_free(plain_calls, phase)
    require(not any(launched.values()),
            f"{phase}: a kernel of the repo launched: {launched}")
    require(get_attn_impl() == "pairs", f"{phase}: switch not restored")
    p, q, p2 = got["pairs"], got["qloop"], got["pairs_again"]
    (lp, kvp), (lq, kvq) = p["prefill"], q["prefill"]
    require(bool(torch.isfinite(lq).all()) and all(np.isfinite(q["losses"])),
            f"{phase}: q-loop logits or losses not finite")
    logits_equal = torch.equal(lq, lp)
    cache_equal = len(kvq) == len(kvp) and all(
        torch.equal(a, b) for a, b in zip(kvq, kvp))
    require(logits_equal, f"{phase}: q-loop logits differ from the pair "
            f"loop's by {float((lq - lp).abs().max())}")
    require(cache_equal, f"{phase}: q-loop prefill cache differs")
    require(q["losses"] == p["losses"] == p2["losses"],
            f"{phase}: q-loop losses {q['losses']} vs the pair loop's "
            f"{p['losses']} and {p2['losses']}")
    row = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "head_dim": cfg.resolved_head_dim},
           "prefill_batch": h.prefill_batch, "batch": h.batch, "seq": h.seq,
           "chunk": h.chunk, "q_chunks": h.seq // h.chunk,
           "train_steps": h.train_steps,
           "logits_bit_equal": logits_equal, "cache_bit_equal": cache_equal,
           "losses_bit_equal": True, "losses": q["losses"],
           "grad_norms_bit_equal": q["grad_norms"] == p["grad_norms"],
           "params_after_equal": q["param_sums"] == p["param_sums"],
           "launches": launched,
           "card": nvidia_smi_line() if cuda else None}
    for impl in impls:
        row[impl] = {"prefill_ms": [float(v) for v in np.percentile(
                         ms[impl], [50, 25, 75])],
                     "prefill_ms_all": ms[impl],
                     "prefill_peak_gib": got[impl]["prefill_peak_gib"],
                     **{k: got[impl][k] for k in (
                         "step_ms", "train_peak_gib", "grad_norms")}}
    row["pairs_again"] = {k: p2[k] for k in ("step_ms", "train_peak_gib")}
    emit(phase, **row)
    del model, got, batches
    free()
    return {"launches": launched, "rows": {"qloop": row},
            "seconds": time.perf_counter() - t_all}


# The sizes main() passes each group of phases, and the depth of each
# config a group builds.  Widths never change: d_model, heads, head dim,
# vocab, experts and the layer pattern stay published; only n_layers
# (and an encoder's enc_layers) is cut, a multi-kind pattern in whole
# periods (recurrentgemma-2b keeps one (recurrent, recurrent, local)
# period and its two-layer suffix), deepseek-moe-16b keeps its dense
# first layer.  The cut configs serve phases that check behaviour (the
# MoE dispatch holds, prefill against streamed decode, the cross path,
# losses falling); minicpm-2b's training, qwen2.5-14b's serving and
# sparse FFN (K5's split walk on w1 and w2) and the sAMG kernels keep
# their published sizes.  PERF.md section 4 lists each cut and what it
# saved; the budget line (``budget_line``) gives each group's seconds
# against LIMIT_S.
SAMG_SCALE = 1.0                 # sAMG at its published 3.4 M rows
LIMIT_S = 1200                   # the whole proof, kernel build included
GROUP_SIZES = {
    "slice6": dict(poisson_side=512, hmep_scale=0.25, power_iters=2000),
    "slice7": dict(sweep_scale=0.05, poisson_side=512, n_requests=16,
                   serve_tol=1e-5, maxiter=5000),
    "slice8": dict(max_len=128, n_requests=8, max_new=16, solo_ids=(0, 5),
                   consistency_id=7, ffn_density=0.1, narrow_b_r=32,
                   tokens=(4, 128)),
    "slice9": dict(max_len=128, n_requests=8, max_new=16, solo_ids=(0, 5),
                   consistency_id=7, cross_batch=4, cross_prompt=8,
                   cross_steps=16),
    "slice10": dict(smoke=False, batch=8, seq=256, steps_main=8,
                    steps_other=8, resume_layers=2, trace_steps=1),
    "slice11": dict(batch=8, seq=256, steps=3, pb_batch=2, pb_prompt=16,
                    pb_steps=8, decode_batch=4, decode_prompt=64,
                    decode_steps=16),
    "slice12": dict(batch=8, seq=256),
    "attn": dict(prefill_batch=4, batch=2, seq=1024, chunk=256,
                 prefill_reps=5, train_steps=2),
}
# group -> role -> (n_layers, enc_layers) of a cut config
GROUP_DEPTH = {
    "slice9": {"moe": (3, 0), "ssm": (4, 0), "hybrid": (5, 0),
               "audio": (2, 2), "vlm": (4, 0)},
    "slice10": {"moe": (4, 0), "hybrid": (5, 0), "audio": (2, 2)},
    "slice11": {"main": (8, 0)},
}


def group_configs(TCFG, group: str) -> dict:
    """role -> the config ``main`` builds for ``group``: the published
    one of the group's model table, cut in depth by GROUP_DEPTH."""
    import dataclasses
    names = {"slice8": {"lm": "qwen2.5-14b"}, "slice9": SLICE9_MODELS,
             "slice10": SLICE10_MODELS,
             "slice11": {"main": SLICE11_MAIN, "parallel": SLICE11_PARALLEL},
             "slice12": {"peak": SLICE11_MAIN},
             "attn": {"main": ATTN_MAIN}}[group]
    out = {}
    for role, name in names.items():
        cfg = TCFG.get(name)
        depth = GROUP_DEPTH.get(group, {}).get(role)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth[0],
                                      enc_layers=depth[1])
        if group == "slice11" and role == "parallel":
            cfg = dataclasses.replace(cfg, parallel_block=True)
        if group == "slice12":
            cfg = dataclasses.replace(cfg, n_layers=PEAK_LAYERS)
        out[role] = cfg
    return out


def budget_line(groups: dict, total_s: float) -> dict:
    """The budget record: each group's seconds, the total and the
    limit; ``free_s`` is what a new phase may take."""
    return {"budget": {"groups_s": groups, "total_s": total_s,
                       "limit_s": LIMIT_S, "free_s": LIMIT_S - total_s}}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    t_start = T_START                    # the clock of every line's at_s
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
    from repro_torch.kernels import pjds_spmm as K5
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.cmrs_spmv import cmrs_matvec_kernel_call
    from repro_torch.kernels.ellr_spmv import ell_matvec_kernel_call
    from repro_torch.kernels.fused_iter import (fused_matvec_dots,
                                                fused_spmv_dots_kernel_call)
    from repro_torch.kernels.pjds_spmm import pjds_matmat_kernel_call
    from repro_torch.kernels.pjds_spmv import pjds_matvec_kernel_call
    from repro_torch.kernels.sell_spmv import (sell_matvec_kernel_call,
                                               slab_fits, window_blocks)
    from repro_torch.kernels.transpose_spmv import \
        transpose_matvec_kernel_call

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = {"pjds_spmv": pjds_matvec_kernel_call,
               "sell_spmv": sell_matvec_kernel_call,
               "fused_iter": fused_spmv_dots_kernel_call,
               "ellr_spmv": ell_matvec_kernel_call,
               "pjds_spmm": pjds_matmat_kernel_call,
               "cmrs_spmv": cmrs_matvec_kernel_call,
               "krylov_step": KS.step_kernel_call,
               "krylov_update": KS.update_kernel_call,
               "transpose_spmv": transpose_matvec_kernel_call}
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
    m = TM.samg(scale=SAMG_SCALE)
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
        if name == "pjds_spmm":     # sAMG keeps the lane walk (split_plan)
            rec["walk"] = K5.plan_for(d_s.val, n_blocks).walk
            require(rec["walk"] == "lane",
                    f"time:pjds_spmm: sAMG planned the {rec['walk']} walk")
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
    groups = {}

    def close_group(name, since):
        """Record group ``name``'s seconds (from ``since``) and emit its
        memory line; returns the clock for the next group."""
        now = time.perf_counter()
        groups[name] = now - since
        phase = {"build_to_tuning": "tuned", "training": "slice10",
                 "examples": "slice12"}.get(name, name)
        emit(f"memory:{phase}", max_allocated_gib=torch.cuda.
             max_memory_allocated() / 2 ** 30, seconds=groups[name],
             seconds_since_start=now - t_start)
        return now

    t_group = close_group("build_to_tuning", t_start)

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
    t_group = close_group("dist", t_group)

    # ---- 10c. transposes, gradients, RCM and the eigensolvers ----------
    s6 = slice6_phases(types.SimpleNamespace(
        dev=dev, m=m, a64=a64, x_np=x_np, y64=y64, seed=SEED, op_p=op_p,
        op_s=op_s, op_c=op_c, op_e=op_e, require=require, emit=emit,
        counts=counts, reset_counts=reset_counts, plain_free=plain_free,
        rel_err=rel_err, time_ms=time_ms, csr_of=csr_of,
        library_ms=library_ms, Y_TOL=Y_TOL, SCIPY_TOL=SCIPY_TOL,
        HBM=HBM_BYTES_PER_S, **GROUP_SIZES["slice6"]))
    for rec in record:
        if s6["launches"].get(rec["name"]):
            rec["launches_slice6"] = s6["launches"][rec["name"]]
    record.append(s6["k7"])
    emit("time:transpose_spmv", **s6["k7"])
    t_group = close_group("slice6", t_group)

    # ---- 10d. the distributed tuner and solve serving ------------------
    s7 = slice7_phases(types.SimpleNamespace(
        dev=dev, m=m, a64=a64, seed=SEED, require=require, emit=emit,
        counts=counts, reset_counts=reset_counts, plain_free=plain_free,
        rel_err=rel_err, time_ms=time_ms, SCIPY_TOL=SCIPY_TOL,
        **GROUP_SIZES["slice7"]))
    for rec in record:
        if s7["launches"].get(rec["name"]):
            rec["launches_slice7"] = s7["launches"][rec["name"]]
    t_group = close_group("slice7", t_group)

    # ---- 10e. the sparse FFN on K5, and LM serving at full width -------
    # every K5 launch so far -- sAMG, Poisson, block CG, the distributed
    # layer, serving -- took the lane walk; the FFN's weights split
    require(pjds_matmat_kernel_call.split_launches == 0,
            f"K5's split walk ran {pjds_matmat_kernel_call.split_launches} "
            f"times before the sparse FFN")
    from repro_torch import configs as TCFG
    s8 = slice8_phases(types.SimpleNamespace(
        dev=dev, lm_cfg=group_configs(TCFG, "slice8")["lm"], seed=SEED,
        require=require, emit=emit, counts=counts,
        reset_counts=reset_counts, plain_free=plain_free, rel_err=rel_err,
        time_ms=time_ms, trace=x_backward_trace, Y_TOL=Y_TOL,
        SCIPY_TOL=SCIPY_TOL, HBM=HBM_BYTES_PER_S, F32_FLOPS=F32_FLOPS,
        BF16_FLOPS=BF16_FLOPS, **GROUP_SIZES["slice8"]))
    for rec in record:
        if s8["launches"].get(rec["name"]):
            rec["launches_slice8"] = s8["launches"][rec["name"]]
        if rec["name"] == "pjds_spmm":
            rec["ffn"] = [
                {"weight": r["weight"], "density": r["density"],
                 "b_r": r["b_r"], "T": int(t),
                 **{key: v[key] for key in (
                     "walk", "slices", "k5_ms", "k5_graph_ms", "bound_ms",
                     "bound_by",
                     "cublas_bf16_ms", "cusparse_ms", "plain_ms",
                     "max_rel_err_vs_plain")}}
                for r in s8["ffn"] for t, v in r["by_t"].items()]
    t_group = close_group("slice8", t_group)

    # ---- 10f. MoE, Mamba, RG-LRU, cross-attention and the frontends ----
    s9 = slice9_phases(types.SimpleNamespace(
        dev=dev, seed=SEED, require=require, emit=emit, counts=counts,
        reset_counts=reset_counts, plain_free=plain_free,
        trace=x_backward_trace, HBM=HBM_BYTES_PER_S, BF16_FLOPS=BF16_FLOPS,
        cfgs=group_configs(TCFG, "slice9"), **GROUP_SIZES["slice9"]))
    for rec in record:
        rec["launches_slice9"] = s9["launches"].get(rec["name"], 0)
    t_group = close_group("slice9", t_group)

    # ---- 10g. LM training: the launcher, resume, card against CPU ------
    train_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    s10 = slice10_phases(types.SimpleNamespace(
        dev=dev, seed=SEED, require=require, emit=emit, counts=counts,
        reset_counts=reset_counts, plain_free=plain_free,
        trace=x_backward_trace, HBM=HBM_BYTES_PER_S, BF16_FLOPS=BF16_FLOPS,
        cfgs=group_configs(TCFG, "slice10"), tmp=train_dir.name,
        **GROUP_SIZES["slice10"]))
    train_dir.cleanup()
    for rec in record:
        rec["launches_slice10"] = s10["launches"].get(rec["name"], 0)
    t_group = close_group("training", t_group)

    # ---- 10h. the model across cards, on one card -----------------------
    mesh_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    s11 = slice11_phases(types.SimpleNamespace(
        dev=dev, seed=SEED, require=require, emit=emit, counts=counts,
        reset_counts=reset_counts, plain_free=plain_free,
        cfgs=group_configs(TCFG, "slice11"), tmp=mesh_dir.name,
        **GROUP_SIZES["slice11"]))
    mesh_dir.cleanup()
    for rec in record:
        rec["launches_slice11"] = s11["launches"].get(rec["name"], 0)
    t_group = close_group("slice11", t_group)

    # ---- 10i. the reference's examples, the recorder's peak ------------
    s12 = slice12_phases(types.SimpleNamespace(
        dev=dev, seed=SEED, require=require, emit=emit, counts=counts,
        reset_counts=reset_counts, plain_free=plain_free,
        cfgs=group_configs(TCFG, "slice12"), example_args=EXAMPLE_ARGS,
        **GROUP_SIZES["slice12"]))
    for rec in record:
        rec["launches_examples"] = s12["launches"].get(rec["name"], 0)
    t_group = close_group("examples", t_group)

    # ---- 10j. the reference's attention switch ---------------------------
    sa = attn_impl_phases(types.SimpleNamespace(
        dev=dev, seed=SEED, require=require, emit=emit, counts=counts,
        reset_counts=reset_counts, plain_free=plain_free,
        cfgs=group_configs(TCFG, "attn"), **GROUP_SIZES["attn"]))
    for rec in record:
        rec["launches_attn"] = sa["launches"].get(rec["name"], 0)
    groups["attn"] = time.perf_counter() - t_group

    # ---- 11. the record, the card, the budget, the verdict ---------------
    print(json.dumps({"kernels": record}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(budget_line(groups, time.perf_counter() - t_start)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
