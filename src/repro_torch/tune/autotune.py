"""The tuning drivers: enumerate -> prune -> measure -> cache.

Port of the single-device drivers of ``repro/tune/autotune.py``.
:func:`autotune` is the driver behind ``ops.as_device(..., tune=...)``
and ``operator(..., tune=...)``; :func:`tune_solver` is the one behind
``repro_torch.solve``'s default ``tune="auto"``.  Both measure on the
device they are given (CUDA unless ``device="cpu"``; with no card and no
device they raise, as every entry point does) and go through the
persistent :class:`cache.TuneCache`: a hit returns the stored decision
without building or measuring anything.  The distributed driver,
:func:`tune_partition`, waits for the distributed layer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch._todo import not_ported
from repro_torch.core import formats as F
from repro_torch.core import perf_model as PM
from repro_torch.kernels._backend import resolve_device
from . import cache as C
from . import measure as ME
from .space import (Candidate, enumerate_candidates, heuristic_candidate,
                    price_candidate, prune_candidates, solver_candidates)

__all__ = ["TuneResult", "SolverTuneResult", "autotune", "tune_solver",
           "tune_partition"]

_DEFAULT_TOP_K = 6


@dataclasses.dataclass
class TuneResult:
    """Outcome of one :func:`autotune` call.  ``rows`` carries one dict
    per measured candidate (statics + uncalibrated ``model_s`` +
    ``measured_s``) -- the input ``calibrate.fit_calibration`` wants --
    and ``cached`` says whether measurement was skipped entirely."""

    best: Candidate
    rows: list
    cached: bool
    key: str

    @property
    def heuristic_row(self) -> Optional[dict]:
        for r in self.rows:
            if r.get("heuristic"):
                return r
        return None


def autotune(
    m: F.CSRMatrix,
    *,
    format: str = "auto",
    dtype=None,
    index_dtype="auto",
    top_k: int = _DEFAULT_TOP_K,
    warmup: int = 1,
    iters: int = 5,
    cache: Optional[C.TuneCache] = None,
    force: bool = False,
    measure_fn: Optional[Callable] = None,
    spec: PM.TPUSpec = PM.H100,
    device=None,
) -> TuneResult:
    """Pick measured-best kernel statics for ``m`` on ``device`` under
    the given format restriction and dtype policy.

    The cache key is (structural fingerprint, device kind, dtype policy,
    format restriction).  ``force=False`` returns a hit verbatim -- zero
    builds, zero measurements; ``force=True`` re-measures and
    overwrites.  ``measure_fn`` (the signature of
    ``measure.measure_candidate``) exists for tests and custom
    harnesses.  ``spec`` prices the pruning and the heuristic's format
    pick.

    A winner other than the heuristic default is CONFIRMED by a paired
    comparison (``measure.ab_compare``) before it is cached; if it
    cannot beat the heuristic head-to-head the heuristic is kept.
    (Skipped under an injected ``measure_fn``.)"""
    dev = resolve_device(device)
    if cache is None:
        cache = C.default_cache()
    key = C.cache_key(F.structural_fingerprint(m), ME.device_kind(dev),
                      C.dtype_policy(dtype, index_dtype),
                      extra=f"fmt={format}" if format != "auto" else "")
    if not force:
        hit = cache.get(key, require=("best",))
        if hit is not None:
            try:
                return TuneResult(best=Candidate.from_dict(hit["best"]),
                                  rows=list(hit.get("rows", [])),
                                  cached=True, key=key)
            except (AttributeError, KeyError, TypeError, ValueError):
                cache.quarantined[key] = "malformed 'best' candidate"

    heur = heuristic_candidate(m, format, dtype, index_dtype, spec)
    cands = prune_candidates(
        m, enumerate_candidates(m, format, dtype, index_dtype, spec=spec),
        top_k=top_k, dtype=dtype, index_dtype=index_dtype, spec=spec,
        heuristic=heur)
    confirm = measure_fn is None
    if measure_fn is None:
        measure_fn = ME.measure_candidate
    rows = []
    for c in cands:
        t = measure_fn(m, c, dtype=dtype, index_dtype=index_dtype,
                       warmup=warmup, iters=iters, device=dev)
        rows.append({
            **c.as_dict(),
            "label": c.label(),
            "heuristic": c == heur,
            "model_s": price_candidate(m, c, dtype=dtype,
                                       index_dtype=index_dtype, spec=spec,
                                       calibration=None),
            "measured_s": float(t),
        })
    best = cands[int(np.argmin([r["measured_s"] for r in rows]))]
    if confirm and best != heur:
        t_h, t_b = ME.ab_compare(m, heur, best, dtype=dtype,
                                 index_dtype=index_dtype,
                                 rounds=5, iters=max(iters // 2, 2),
                                 warmup=warmup, device=dev)
        if t_b >= t_h:
            best = heur
    cache.put(key, {"best": best.as_dict(), "rows": rows})
    return TuneResult(best=best, rows=rows, cached=False, key=key)


@dataclasses.dataclass
class SolverTuneResult:
    """Outcome of one :func:`tune_solver` call: the iteration STRATEGY
    (``"fused"`` / ``"composed"``) and the layout to build it on, plus
    one row per measured (strategy, layout) probe."""

    strategy: str
    layout: Candidate
    rows: list
    cached: bool
    key: str


def tune_solver(
    m: F.CSRMatrix,
    *,
    method: str = "cg",
    dtype=None,
    index_dtype="auto",
    probe_iters: int = 20,
    warmup: int = 1,
    iters: int = 3,
    cache: Optional[C.TuneCache] = None,
    force: bool = False,
    measure_fn: Optional[Callable] = None,
    spec: PM.TPUSpec = PM.H100,
    device=None,
) -> SolverTuneResult:
    """Pick the measured-best (strategy, layout) for running ``method``
    on ``m`` on ``device`` -- the configuration that wins per solver
    ITERATION, not per matvec (K3's fused pass amortises differently
    from a bare product).

    The cache discipline of :func:`autotune`, with the method as the
    key's ``extra`` segment; ``measure_fn`` (the signature of
    ``measure.measure_solver_candidate``) exists for tests.  ``spec``
    prices the composed probe's heuristic format pick."""
    dev = resolve_device(device)
    if cache is None:
        cache = C.default_cache()
    key = C.cache_key(F.structural_fingerprint(m), ME.device_kind(dev),
                      C.dtype_policy(dtype, index_dtype),
                      extra=f"solver:method={method}")
    if not force:
        hit = cache.get(key, require=("strategy", "layout"))
        if hit is not None:
            try:
                return SolverTuneResult(
                    strategy=str(hit["strategy"]),
                    layout=Candidate.from_dict(hit["layout"]),
                    rows=list(hit.get("rows", [])), cached=True, key=key)
            except (AttributeError, KeyError, TypeError, ValueError):
                cache.quarantined[key] = "malformed 'layout' candidate"

    if measure_fn is None:
        measure_fn = ME.measure_solver_candidate
    cands = solver_candidates(m, method=method, dtype=dtype,
                              index_dtype=index_dtype, spec=spec)
    rows = []
    for strategy, c in cands:
        t = measure_fn(m, strategy, c, method=method, dtype=dtype,
                       index_dtype=index_dtype, probe_iters=probe_iters,
                       warmup=warmup, iters=iters, device=dev)
        rows.append({"strategy": strategy, "layout": c.as_dict(),
                     "label": f"{strategy}: {c.label()}",
                     "seconds_per_iter": float(t)})
    best = rows[int(np.argmin([r["seconds_per_iter"] for r in rows]))]
    cache.put(key, {"strategy": best["strategy"], "layout": best["layout"],
                    "rows": rows})
    return SolverTuneResult(strategy=best["strategy"],
                            layout=Candidate.from_dict(best["layout"]),
                            rows=rows, cached=False, key=key)


def tune_partition(m: F.CSRMatrix, n_dev: int, **kwargs):
    """The reference's distributed driver (per-operand ``chunk_l`` of a
    row partition, and the communication sweep), with the link
    calibration it measures; not ported yet."""
    raise not_ported("tune_partition", "dist_tune")
