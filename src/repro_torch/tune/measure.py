"""Measurement harness: warm-up, then the median of timed samples of a
candidate build.

Port of ``repro/tune/measure.py``.  Every measurement runs on the device
the candidate is built on, through the path a caller would take there:
the hand-written kernels on a CUDA card, the plain versions on the CPU
(only when the caller asked for ``device="cpu"``).  Nothing here picks a
device or a backend of its own, so a tuned decision is never a timing of
a plain version on a card.

On a card a sample is CUDA events around ``burst`` back-to-back calls,
then a synchronise: one launch's host overhead would outlast the
shortest kernels (K4 on Poisson 512^2 runs in about 5 us), and per-call
host clocks would make every candidate tie.  On the CPU a sample is the
host clock around the same burst.

A distributed candidate (:func:`measure_dist_candidate`) is timed as
one collective product: every rank calls it, and each sample starts
after a barrier of all ranks and ends when the rank's own stream is
idle (:func:`collective_seconds`).  It never synchronises the whole
device, so ranks that share one card (``ThreadComm``) do not wait for
each other's work outside the product.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.kernels import ops
from repro_torch.kernels._backend import resolve_device
from .space import Candidate

__all__ = [
    "median_seconds",
    "device_kind",
    "prepare_candidate",
    "measure_candidate",
    "measure_solver_candidate",
    "ab_compare",
    "collective_seconds",
    "measure_dist_candidate",
]

MEASURE_SEED = 0       # deterministic RHS for every measurement
BURST = 10             # back-to-back calls per sample of a product


def median_seconds(fn, *args, warmup: int = 1, iters: int = 5,
                   device=None, burst: int = BURST) -> float:
    """Median seconds per call of ``fn(*args)``: ``warmup`` calls, then
    ``iters`` samples of ``burst`` back-to-back calls each, timed with
    CUDA events and a synchronise on a CUDA ``device``, with the host
    clock otherwise."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    cuda = dev.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize(dev)
    ts = []
    for _ in range(iters):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(burst):
                fn(*args)
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) * 1e-3 / burst)
        else:
            t0 = time.perf_counter()
            for _ in range(burst):
                fn(*args)
            ts.append((time.perf_counter() - t0) / burst)
    return float(np.median(ts))


def device_kind(device=None) -> str:
    """Cache-key component naming the hardware a measurement runs on:
    ``torch-cuda:<card name>`` or ``torch-cpu`` (tuned statics do not
    transfer between cards -- that is the point of measuring)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"torch-cuda:{torch.cuda.get_device_name(dev)}"
    return f"torch-{dev.type}"


def _rhs(n: int, device) -> torch.Tensor:
    rng = np.random.default_rng(MEASURE_SEED)
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        device)


def prepare_candidate(
    m: F.CSRMatrix,
    c: Candidate,
    *,
    dtype=None,
    index_dtype="auto",
    device=None,
):
    """Build candidate ``c`` on ``device`` and return a nullary callable
    running one dispatched spMVM on the deterministic RHS (conversion is
    NOT timed: it amortises over the operand's lifetime and the
    conversion cache)."""
    dev = resolve_device(device)
    sd = ops.as_device(m, dtype=dtype, index_dtype=index_dtype, device=dev,
                       **c.build_kwargs())
    x = _rhs(m.shape[1], dev)
    return lambda: sd.matvec(x)


def measure_candidate(
    m: F.CSRMatrix,
    c: Candidate,
    *,
    dtype=None,
    index_dtype="auto",
    warmup: int = 1,
    iters: int = 5,
    device=None,
) -> float:
    """Median seconds of one dispatched spMVM through candidate ``c``'s
    build on ``device``."""
    dev = resolve_device(device)
    return median_seconds(prepare_candidate(m, c, dtype=dtype,
                                            index_dtype=index_dtype,
                                            device=dev),
                          warmup=warmup, iters=iters, device=dev)


def measure_solver_candidate(
    m: F.CSRMatrix,
    strategy: str,
    c: Candidate,
    *,
    method: str = "cg",
    dtype=None,
    index_dtype="auto",
    probe_iters: int = 20,
    warmup: int = 1,
    iters: int = 3,
    device=None,
) -> float:
    """Median seconds PER SOLVER ITERATION of ``(strategy, c)``: a
    fixed-length probe solve (``maxiter=probe_iters, tol=0`` -- no early
    exit) divided by ``probe_iters``.  Returns ``inf`` when the strategy
    cannot run this layout (fused needs a SELL build with x_tiles 1).

    A probe ends in host reads, so each sample is one probe.  At least
    one warm-up probe always runs: the first fused probe of an operand
    captures its CUDA graph (``SparseDevice.fused``), and that capture
    is never timed."""
    from repro_torch import api                # deferred: api imports tune
    from repro_torch.core.operator import operator

    dev = resolve_device(device)
    op = operator(m, dtype=dtype, index_dtype=index_dtype, device=dev,
                  **c.build_kwargs())
    b = _rhs(m.shape[0], dev)
    if strategy == "fused" and not api._fused_eligible(op, method, None, b):
        return float("inf")

    def probe():
        return api._one_solve(op, b, method=method, strategy=strategy,
                              maxiter=probe_iters, tol=0.0,
                              precond=None).x

    return median_seconds(probe, warmup=max(warmup, 1), iters=iters,
                          device=dev, burst=1) / probe_iters


def ab_compare(
    m: F.CSRMatrix,
    a: Candidate,
    b: Candidate,
    *,
    dtype=None,
    index_dtype="auto",
    rounds: int = 7,
    iters: int = 3,
    warmup: int = 2,
    device=None,
) -> tuple[float, float]:
    """Drift-robust paired timing of two candidates: alternate the two
    builds round by round (order flipped every round) and keep each
    side's MINIMUM round median, so slow drift (load, clocks) lands on
    both sides and the inflated rounds drop out."""
    dev = resolve_device(device)
    fa = prepare_candidate(m, a, dtype=dtype, index_dtype=index_dtype,
                           device=dev)
    fb = prepare_candidate(m, b, dtype=dtype, index_dtype=index_dtype,
                           device=dev)
    for f in (fa, fb):
        for _ in range(warmup):
            f()
    ta, tb = np.inf, np.inf
    for r in range(rounds):
        order = ((0, fa), (1, fb)) if r % 2 == 0 else ((1, fb), (0, fa))
        for side, f in order:
            t = median_seconds(f, warmup=0, iters=iters, device=dev)
            if side == 0:
                ta = min(ta, t)
            else:
                tb = min(tb, t)
    return float(ta), float(tb)


def _barrier(comm, dev: torch.device) -> None:
    """Return once every rank of ``comm`` got here with its stream idle:
    one ``all_reduce_sum`` of a zero, read on the host."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    float(comm.all_reduce_sum(torch.zeros(1, device=dev))[0])


def collective_seconds(fn, comm, *, warmup: int = 1, iters: int = 3,
                       device=None, burst: int = BURST) -> float:
    """This rank's median seconds per call of ``fn()``, a collective
    every rank of ``comm`` runs together: ``warmup`` calls, then
    ``iters`` samples, each a barrier of all ranks, ``burst`` calls and
    a wait for the rank's own stream, on the host clock."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        _barrier(comm, dev)
        t0 = time.perf_counter()
        for _ in range(burst):
            fn()
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        ts.append((time.perf_counter() - t0) / burst)
    return float(np.median(ts))


def measure_dist_candidate(
    m: F.CSRMatrix,
    comm,
    cand: dict,
    *,
    b_r: int = 128,
    diag_align: int = 8,
    chunk_l: int = 8,
    rem_chunk_l=None,
    sigma=None,
    index_dtype="auto",
    warmup: int = 1,
    iters: int = 3,
    device=None,
    dist=None,
) -> dict:
    """Partition ``m`` per distributed candidate ``cand`` (a
    ``space.dist_candidates`` dict: grid / halo / mode / halo_w) and
    time one distributed product on this rank of ``comm`` end to end --
    the exchange, K1 on the local and remote operands (one per stage in
    ``"pipeline"``) and the reduction, exactly as
    ``DistOperator.matvec`` runs them.  Every rank calls it together.

    ``dist`` is a partition already built for the candidate's grid and
    ``halo_w`` (with ``build_stages=True``, so any mode runs on it);
    without one, the partition is built here (once for all ranks that
    are threads of this process).  Returns the reference's row: the
    wire statistics (``msgs`` / ``bytes`` per rank) beside
    ``measured_s``, THIS rank's median; ``tune_partition`` takes the
    slowest rank's.
    """
    from repro_torch.core import dist_spmv as D     # deferred: imports ops
    from repro_torch.core.operator import DistOperator, _shared_plan

    dev = resolve_device(device)
    if dist is None:
        stages = cand["mode"] == "pipeline"
        key = ("measure_dist_candidate", cand.get("grid"),
               cand.get("halo_w"), b_r, diag_align, chunk_l, rem_chunk_l,
               sigma, str(index_dtype), stages)
        dist = _shared_plan(comm, m, key, lambda: D.partition_csr(
            m, comm.size, b_r=b_r, diag_align=diag_align, chunk_l=chunk_l,
            halo_w=cand.get("halo_w"), sigma=sigma,
            index_dtype=index_dtype, rem_chunk_l=rem_chunk_l,
            grid=cand.get("grid"), build_stages=stages))
    op = DistOperator(dist, comm, mode=cand["mode"], halo=cand["halo"],
                      device=dev)
    rng = np.random.default_rng(MEASURE_SEED)
    x = op.shard_vector(rng.standard_normal(dist.n_global_pad)
                        .astype(np.float32))
    t = collective_seconds(lambda: op.matvec(x), comm, warmup=warmup,
                           iters=iters, device=dev)
    vb = dist.loc_val.dtype.itemsize
    return dict(
        grid=cand.get("grid"), halo=cand["halo"], mode=cand["mode"],
        halo_w=int(dist.halo_w), red_w=int(dist.red_w),
        msgs=int(dist.comm_msgs_per_device(halo=cand["halo"])),
        bytes=int(dist.comm_bytes_per_device(value_bytes=vb,
                                             halo=cand["halo"])),
        measured_s=float(t))
