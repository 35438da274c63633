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
