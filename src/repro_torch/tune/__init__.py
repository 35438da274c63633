"""The empirical autotuner and perf-model calibration.

Port of ``repro/tune``.  The paper picks formats with "a suitable
performance model"; this package closes the loop: enumerate the legal
static space (``space``), prune it with the model, MEASURE the
survivors on the card (``measure``), remember the decision in a
persistent cache keyed by structural fingerprint x device kind x dtype
policy (``cache``), and fit the model's rate and per-format overheads
to the measured rows (``calibrate``).  The distributed tuner,
``tune_partition``, chooses a row partition's tile heights and, over a
communicator, its grid, halo flavour and mode; its sweep's rows fit
the link model's per-message cost (``fit_link_calibration``).

Most callers go one level up -- ``operator(m, tune="auto")``,
``as_device(m, tune="auto")``, ``repro_torch.solve(m, b)`` or
``dist_operator(m, comm, tune="auto")`` -- which route here.
"""
from .space import (Candidate, enumerate_candidates, heuristic_candidate,
                    price_candidate, prune_candidates, solver_candidates,
                    dist_candidates)
from .measure import (measure_candidate, measure_solver_candidate,
                      measure_dist_candidate, prepare_candidate, ab_compare,
                      median_seconds, device_kind)
from .cache import (TuneCache, default_cache, cache_key, dtype_policy,
                    RECORD_SCHEMA)
from .calibrate import (fit_calibration, model_error, fit_link_calibration,
                        link_model_error, rows_from_bench_kernels,
                        fit_from_bench_kernels)
from .autotune import (TuneResult, TunePartition, SolverTuneResult,
                       autotune, tune_partition, tune_solver)

__all__ = [
    "Candidate",
    "enumerate_candidates",
    "heuristic_candidate",
    "price_candidate",
    "prune_candidates",
    "solver_candidates",
    "dist_candidates",
    "measure_candidate",
    "measure_solver_candidate",
    "measure_dist_candidate",
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
    "fit_link_calibration",
    "link_model_error",
    "rows_from_bench_kernels",
    "fit_from_bench_kernels",
    "TuneResult",
    "TunePartition",
    "SolverTuneResult",
    "autotune",
    "tune_partition",
    "tune_solver",
]
