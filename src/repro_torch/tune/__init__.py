"""The empirical autotuner and perf-model calibration.

Port of ``repro/tune``'s single-device half.  The paper picks formats
with "a suitable performance model"; this package closes the loop:
enumerate the legal static space (``space``), prune it with the model,
MEASURE the survivors on the card (``measure``), remember the decision
in a persistent cache keyed by structural fingerprint x device kind x
dtype policy (``cache``), and fit the model's rate and per-format
overheads to the measured rows (``calibrate``).

Most callers go one level up -- ``operator(m, tune="auto")``,
``as_device(m, tune="auto")`` or ``repro_torch.solve(m, b)`` -- which
route here.  ``tune_partition`` (the distributed driver) raises until
the distributed tuner is ported (ROADMAP.md, item 1.20).
"""
from .space import (Candidate, enumerate_candidates, heuristic_candidate,
                    price_candidate, prune_candidates, solver_candidates)
from .measure import (measure_candidate, measure_solver_candidate,
                      prepare_candidate, ab_compare, median_seconds,
                      device_kind)
from .cache import (TuneCache, default_cache, cache_key, dtype_policy,
                    RECORD_SCHEMA)
from .calibrate import fit_calibration, model_error
from .autotune import (TuneResult, SolverTuneResult, autotune, tune_solver,
                       tune_partition)

__all__ = [
    "Candidate",
    "enumerate_candidates",
    "heuristic_candidate",
    "price_candidate",
    "prune_candidates",
    "solver_candidates",
    "measure_candidate",
    "measure_solver_candidate",
    "prepare_candidate",
    "ab_compare",
    "median_seconds",
    "device_kind",
    "TuneCache",
    "RECORD_SCHEMA",
    "default_cache",
    "cache_key",
    "dtype_policy",
    "fit_calibration",
    "model_error",
    "TuneResult",
    "SolverTuneResult",
    "autotune",
    "tune_solver",
    "tune_partition",
]
