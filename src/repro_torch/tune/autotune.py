"""The tuning drivers: enumerate -> prune -> measure -> cache.

Port of the single-device drivers of ``repro/tune/autotune.py``.
:func:`autotune` is the driver behind ``ops.as_device(..., tune=...)``
and ``operator(..., tune=...)``; :func:`tune_solver` is the one behind
``repro_torch.solve``'s default ``tune="auto"``.  Both measure on the
device they are given (CUDA unless ``device="cpu"``; with no card and no
device they raise, as every entry point does) and go through the
persistent :class:`cache.TuneCache`: a hit returns the stored decision
without building or measuring anything.

:func:`tune_partition` is the distributed tuner behind
``dist_operator(..., tune=...)``: it chooses the ``chunk_l`` of a row
partition's LOCAL and REMOTE operands independently (their row lengths
differ structurally: the remote part holds only the halo coupling) and,
given a communicator, sweeps the communication configuration (grid,
halo flavour, mode) by timing whole distributed products.  Every rank
calls it, and every rank leaves with the same decision: rank 0 alone
reads and writes the cache and measures the chunk sweep, and its
decision and times reach the other ranks through ``all_reduce_sum``;
the sweep's times form an ``(n_ranks, n_candidates)`` table, summed the
same way, and the slowest rank's time decides each candidate (the
reference's "straggler decides").
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.core import perf_model as PM
from repro_torch.kernels import ops
from repro_torch.kernels._backend import resolve_device
from . import cache as C
from . import measure as ME
from .space import (Candidate, enumerate_candidates, heuristic_candidate,
                    price_candidate, prune_candidates, solver_candidates)

__all__ = ["TuneResult", "TunePartition", "SolverTuneResult", "autotune",
           "tune_partition", "tune_solver"]

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


# --------------------------------------------------------------------------
# Distributed-partition tuning
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TunePartition:
    """Independently chosen tile heights for a row partition's local
    (block-diagonal) and remote (halo-coupling) operands, plus -- when
    the sweep ran over a communicator -- the measured-best
    communication configuration (``halo`` flavour, execution ``mode``,
    2-D ``grid`` shape; ``None`` each without a sweep, ``grid=None``
    also meaning the 1-D ``(n_dev, 1)`` winner).  ``phase_s`` splits the
    host seconds of a measured call (``slices``, ``splits``, ``perms``,
    ``build``, ``measure`` and ``sweep``); a cache hit has none."""

    chunk_l: int
    rem_chunk_l: int
    rows: list
    cached: bool
    key: str
    halo: Optional[str] = None
    mode: Optional[str] = None
    grid: Optional[tuple] = None
    phase_s: dict = dataclasses.field(default_factory=dict)


def _measure_operand(sub: F.CSRMatrix, perm: np.ndarray, b_r: int,
                     diag_align: int, chunk_l: int, index_dtype,
                     warmup: int, iters: int, *, device=None,
                     phase_s: Optional[dict] = None) -> float:
    """Median seconds of K1 over one rank's operand built the exact way
    ``partition_csr`` builds it (the shared windowed row sort, then pJDS
    blocking at this chunk_l), on ``device``.  Adds the build and
    measurement seconds to ``phase_s`` when given."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    pj = F._pjds_with_perm(sub, perm, b_r, max(diag_align, chunk_l),
                           False, index_dtype)
    a = ops.to_device_pjds(pj, chunk_l=chunk_l, device=dev)
    x = ME._rhs(sub.shape[1], dev)
    t1 = time.perf_counter()
    t = ME.median_seconds(lambda: ops.pjds_matvec(a, x), warmup=warmup,
                          iters=iters, device=dev)
    if phase_s is not None:
        phase_s["build"] = phase_s.get("build", 0.0) + t1 - t0
        phase_s["measure"] = (phase_s.get("measure", 0.0)
                              + time.perf_counter() - t1)
    return t


def _straggler_operands(m: F.CSRMatrix, n_dev: int, b_r: int, sigma,
                        phase_s: Optional[dict] = None) -> dict:
    """The host half of the chunk sweep, as the reference computes it:
    each rank's row slice of the 1-D partition, its remote columns by
    ring distance, the coupling width ``halo_w``, the local / remote
    split, the shared windowed row sort of each rank, and the ranks
    storing the most local and remote non-zeros (``p_loc``,
    ``p_rem``)."""
    from repro_torch.core import dist_spmv as D   # deferred: imports ops

    phase_s = {} if phase_s is None else phase_s
    t0 = time.perf_counter()
    n_pad = D.padded_global_size(m.n_rows, n_dev, b_r)
    n_loc = n_pad // n_dev
    slices = [D._csr_row_slice(m, p * n_loc, (p + 1) * n_loc, n_loc)
              for p in range(n_dev)]
    needs = [F.csr_remote_columns_by_distance(sl, p, n_loc, n_dev)
             for p, sl in enumerate(slices)]
    halo_w = min(max((max((abs(d) for d in nd), default=0) for nd in needs),
                     default=0), n_dev // 2)
    sig = max(min(int(sigma) if sigma is not None else 8 * b_r, n_loc), 1)
    t1 = time.perf_counter()
    splits = [D._split_loc_rem(sl, p, n_loc, n_dev, halo_w)
              for p, sl in enumerate(slices)]
    t2 = time.perf_counter()
    perms = [F.windowed_sort_perm(loc.row_lengths() + rem.row_lengths(), sig)
             for loc, rem in splits]
    t3 = time.perf_counter()
    phase_s["slices"] = phase_s.get("slices", 0.0) + t1 - t0
    phase_s["splits"] = phase_s.get("splits", 0.0) + t2 - t1
    phase_s["perms"] = phase_s.get("perms", 0.0) + t3 - t2
    return dict(slices=slices, needs=needs, halo_w=halo_w, sigma=sig,
                splits=splits, perms=perms,
                p_loc=int(np.argmax([loc.nnz for loc, _ in splits])),
                p_rem=int(np.argmax([rem.nnz for _, rem in splits])))


def _from_rank0(comm, values: Sequence[float], dev) -> np.ndarray:
    """``values`` as rank 0 holds them, on every rank: one
    ``all_reduce_sum`` to which the other ranks add zeros (exact: each
    entry has one non-zero term)."""
    t = torch.tensor(list(values), dtype=torch.float64, device=dev)
    if comm.rank != 0:
        t = torch.zeros_like(t)
    return comm.all_reduce_sum(t).cpu().numpy()


def _hit_of(cache, key: str, require: tuple):
    """The cached decision ``(chunk_l, rem_chunk_l, halo, mode, grid,
    rows)`` under ``key``, or None (a malformed record is quarantined:
    a miss)."""
    hit = cache.get(key, require=require)
    if hit is None:
        return None
    try:
        return (int(hit["chunk_l"]), int(hit["rem_chunk_l"]),
                hit.get("halo"), hit.get("mode"),
                tuple(hit["grid"]) if hit.get("grid") else None,
                list(hit.get("rows", [])))
    except (TypeError, ValueError):
        cache.quarantined[key] = "malformed chunk_l record"
        return None


def tune_partition(
    m: F.CSRMatrix,
    n_dev: int,
    *,
    b_r: int = 128,
    diag_align: int = 8,
    sigma: Optional[int] = None,
    index_dtype="auto",
    chunk_l_options: Sequence[int] = (8, 16, 32),
    warmup: int = 1,
    iters: int = 3,
    cache: Optional[C.TuneCache] = None,
    force: bool = False,
    comm=None,
    comm_candidates: Optional[Sequence[dict]] = None,
    device=None,
) -> TunePartition:
    """Measure the best ``chunk_l`` for the local and remote operands of
    an ``n_dev``-way row partition of ``m``, independently, on
    ``device`` (CUDA unless named).

    The straggler decides distributed step time, so the chunk sweep
    runs on the rank whose operand stores the most (separately for local
    and remote), with the same shared windowed row sort
    ``partition_csr`` uses.  The result feeds ``partition_csr(...,
    chunk_l=, rem_chunk_l=)`` through ``dist_operator(tune=...)``.

    ``comm`` (a ``GroupComm`` or ``ThreadComm`` rank of ``n_dev``
    ranks; every rank calls this function with it) makes the decision
    collective -- rank 0 decides cache hit or miss, measures the chunk
    sweep and writes the cache, and every rank returns the same
    decision -- and sweeps the COMMUNICATION configuration: halo flavour
    x mode x 2-D grid (``space.dist_candidates``, or ``comm_candidates``;
    an empty list skips the sweep) by timing one whole distributed
    product per candidate (``measure.measure_dist_candidate``) with the
    chunk winners in place.  One partition per (grid, halo_w) serves
    every halo and mode of it.  The slowest rank's time decides; the
    winner fills ``.halo`` / ``.mode`` / ``.grid``, and the sweep's rows
    (``msgs`` / ``bytes`` beside ``measured_s``) are the input of
    ``calibrate.fit_link_calibration``.  Without ``comm`` only the chunk
    sweep runs, in this process alone.
    """
    from repro_torch.core import dist_spmv as D   # deferred: imports ops
    from repro_torch.core.operator import _shared_plan
    from .space import dist_candidates

    dev = resolve_device(device)
    if comm is not None and comm.size != n_dev:
        raise ValueError(f"n_dev={n_dev}, but the communicator has "
                         f"{comm.size} ranks")
    if cache is None:
        cache = C.default_cache()
    if comm is None:
        comm_candidates = []
    elif comm_candidates is None:
        comm_candidates = dist_candidates(n_dev)
    comm_candidates = [dict(c) for c in comm_candidates]
    sweep = bool(comm_candidates)
    comm_sig = ""
    if sweep:
        comm_sig = ":comm=" + ";".join(
            f"{c.get('grid')}/{c['halo']}/{c['mode']}/{c.get('halo_w')}"
            for c in comm_candidates)
    key = C.cache_key(
        F.structural_fingerprint(m), ME.device_kind(dev),
        C.dtype_policy(None, index_dtype),
        extra=(f"partition:n_dev={n_dev}:b_r={b_r}:sigma={sigma}"
               f":da={diag_align}"
               f":cl={','.join(map(str, chunk_l_options))}" + comm_sig))
    require = (("chunk_l", "rem_chunk_l", "halo", "mode")
               if sweep else ("chunk_l", "rem_chunk_l"))
    lead = comm is None or comm.rank == 0
    sig = [(c.get("grid"), c["halo"], c["mode"]) for c in comm_candidates]

    hit = None if force or not lead else _hit_of(cache, key, require)
    if comm is not None:
        # rank 0's hit or miss, to every rank: (hit, chunk_l,
        # rem_chunk_l, index of the winning candidate or -1)
        won = -1
        if hit is not None and sweep:
            won = next((i for i, s in enumerate(sig)
                        if s == (hit[4], hit[2], hit[3])), -1)
        got = _from_rank0(comm, [0.0] * 4 if hit is None else
                          [1.0, hit[0], hit[1], won], dev)
        if got[0]:
            w = comm_candidates[int(got[3])] if got[3] >= 0 else None
            hit = (int(got[1]), int(got[2]),
                   w["halo"] if w else None, w["mode"] if w else None,
                   tuple(w["grid"]) if w and w.get("grid") else None,
                   hit[5] if hit is not None else [])
        else:
            hit = None
    if hit is not None:
        cl, rcl, halo, mode, grid, rows = hit
        return TunePartition(chunk_l=cl, rem_chunk_l=rcl, rows=rows,
                             cached=True, key=key, halo=halo, mode=mode,
                             grid=grid)

    phase_s: dict = {}
    n_opt = len(chunk_l_options)
    times = [0.0] * (2 * n_opt) + [0.0, 0.0]       # ..., p_loc, p_rem
    if lead:
        ops_ = _straggler_operands(m, n_dev, b_r, sigma, phase_s)
        times[-2:] = ops_["p_loc"], ops_["p_rem"]
        for i, (which, p) in enumerate((("loc", ops_["p_loc"]),
                                        ("rem", ops_["p_rem"]))):
            sub = ops_["splits"][p][i]
            for j, cl in enumerate(chunk_l_options):
                times[i * n_opt + j] = _measure_operand(
                    sub, ops_["perms"][p], b_r, diag_align, cl, index_dtype,
                    warmup, iters, device=dev, phase_s=phase_s)
    if comm is not None:
        times = _from_rank0(comm, times, dev)
    rows, best = [], {}
    for i, which in enumerate(("loc", "rem")):
        p = int(times[2 * n_opt + i])
        for j, cl in enumerate(chunk_l_options):
            t = float(times[i * n_opt + j])
            rows.append(dict(operand=which, device=p, chunk_l=cl,
                             measured_s=t))
            if t < best.get(which, (np.inf,))[0]:
                best[which] = (t, cl)
    chunk_l, rem_chunk_l = best["loc"][1], best["rem"][1]

    halo = mode = grid = None
    if sweep:
        t0 = time.perf_counter()
        plans, comm_rows = {}, []
        for cand in comm_candidates:
            pk = (cand.get("grid"), cand.get("halo_w"))
            if pk not in plans:
                plans[pk] = _shared_plan(
                    comm, m, ("tune_partition", pk, b_r, diag_align,
                              chunk_l, rem_chunk_l, sigma, str(index_dtype)),
                    lambda pk=pk: D.partition_csr(
                        m, n_dev, b_r=b_r, diag_align=diag_align,
                        chunk_l=chunk_l, halo_w=pk[1], sigma=sigma,
                        index_dtype=index_dtype, rem_chunk_l=rem_chunk_l,
                        grid=pk[0], build_stages=True))
            r = ME.measure_dist_candidate(
                m, comm, cand, b_r=b_r, diag_align=diag_align,
                chunk_l=chunk_l, rem_chunk_l=rem_chunk_l, sigma=sigma,
                index_dtype=index_dtype, warmup=warmup, iters=iters,
                device=dev, dist=plans[pk])
            r["operand"] = "comm"
            r["group"] = F.structural_fingerprint(m)
            comm_rows.append(r)
        # every rank's times, one row each; the straggler's decides
        tab = torch.zeros((n_dev, len(comm_rows)), dtype=torch.float64,
                          device=dev)
        tab[comm.rank] = torch.tensor([r["measured_s"] for r in comm_rows],
                                      dtype=torch.float64, device=dev)
        tab = comm.all_reduce_sum(tab).cpu().numpy()
        for r, col in zip(comm_rows, tab.T):
            r["rank_s"] = [float(v) for v in col]
            r["measured_s"] = float(col.max())
        w = comm_rows[int(np.argmin([r["measured_s"] for r in comm_rows]))]
        halo, mode = w["halo"], w["mode"]
        grid = tuple(w["grid"]) if w.get("grid") else None
        rows += comm_rows
        phase_s["sweep"] = time.perf_counter() - t0

    if lead:
        cache.put(key, {"chunk_l": chunk_l, "rem_chunk_l": rem_chunk_l,
                        "halo": halo, "mode": mode,
                        "grid": list(grid) if grid else None, "rows": rows})
    return TunePartition(chunk_l=chunk_l, rem_chunk_l=rem_chunk_l,
                         rows=rows, cached=False, key=key, halo=halo,
                         mode=mode, grid=grid, phase_s=phase_s)
