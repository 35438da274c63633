"""Serving observability: latency summaries, occupancy, typed counters.

Port of ``repro/serve/metrics.py`` (numpy only, copied unchanged apart
from the docstrings).  One :class:`ServeMetrics` instance rides a
:class:`~repro_torch.serve.scheduler.SolveScheduler` and records what
the request diagnostics export:

* per-request latency split three ways — ``queue_s`` (submit ->
  dispatch), ``solve_s`` (dispatch -> completion), ``total_s`` — each a
  :class:`LatencySummary` with count/mean/p50/p99/max;
* ``occupancy`` — filled slots / total slots per dispatched batch, the
  continuous-batching health signal (an occupancy stuck at 1/slots
  means coalescing never happens and block-CG amortisation is lost);
* ``counters`` — monotonically increasing typed event counts:
  ``admitted`` / ``rejected`` / ``shed`` / ``converged`` / ``failed`` /
  ``error`` / ``batches`` / ``group_splits`` (poisoned-batch bisection
  re-solves) / ``value_swaps`` / ``evictions``.

Everything here is plain host-side bookkeeping — no clock of its own
(the scheduler owns time, so deterministic-clock tests drive real
latency numbers), no device work, no locks (the scheduler is
single-threaded per tick by design).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

import numpy as np

__all__ = ["LatencySummary", "ServeMetrics"]


class LatencySummary:
    """Streaming-ish summary of a latency series.

    Samples are kept (exact p50/p99 over a few thousand requests; a
    reservoir would be premature here) and summarised on demand.  ``percentile`` uses the lower interpolation
    so a p99 over a small deterministic test series is an actual
    observed sample, not an invented midpoint.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self._xs: List[float] = []

    def observe(self, seconds: float) -> None:
        self._xs.append(float(seconds))

    @property
    def count(self) -> int:
        return len(self._xs)

    def percentile(self, p: float) -> float:
        if not self._xs:
            return float("nan")
        return float(np.percentile(self._xs, p, method="lower"))

    def snapshot(self) -> dict:
        if not self._xs:
            return {"count": 0}
        xs = np.asarray(self._xs)
        return {
            "count": len(self._xs),
            "mean_s": float(xs.mean()),
            "p50_s": self.percentile(50),
            "p99_s": self.percentile(99),
            "max_s": float(xs.max()),
        }


@dataclasses.dataclass
class ServeMetrics:
    """The scheduler's ledger; see the module docstring for the fields.

    ``inc`` / ``observe_request`` / ``observe_batch`` are the only write
    paths; ``snapshot`` renders one JSON-ready dict."""

    counters: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    queue_s: LatencySummary = dataclasses.field(
        default_factory=lambda: LatencySummary("queue_s"))
    solve_s: LatencySummary = dataclasses.field(
        default_factory=lambda: LatencySummary("solve_s"))
    total_s: LatencySummary = dataclasses.field(
        default_factory=lambda: LatencySummary("total_s"))
    occupancy: LatencySummary = dataclasses.field(
        default_factory=lambda: LatencySummary("occupancy"))

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def observe_request(self, queue_s: float, solve_s: float,
                        total_s: float) -> None:
        self.queue_s.observe(queue_s)
        self.solve_s.observe(solve_s)
        self.total_s.observe(total_s)

    def observe_batch(self, filled: int, slots: int) -> None:
        self.inc("batches")
        self.occupancy.observe(filled / max(slots, 1))

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "queue_s": self.queue_s.snapshot(),
            "solve_s": self.solve_s.snapshot(),
            "total_s": self.total_s.snapshot(),
            "occupancy": self.occupancy.snapshot(),
        }
