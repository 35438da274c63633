"""Multi-tenant solve serving (port of ``repro/serve``).

Layered registry -> scheduler -> group solver:

* :class:`OperatorRegistry` (``registry.py``) -- resident operators
  keyed by structural fingerprint, sharing the persistent tune cache
  (warm admits measure nothing), with zero-reconversion value swaps and
  LRU eviction;
* :class:`SolveScheduler` (``scheduler.py``) -- async admission,
  continuous RHS batching into certified block-CG groups, deadline
  shedding, tick-based slot recycling;
* :class:`ServeMetrics` (``metrics.py``) -- latency/occupancy summaries
  and typed counters;
* :class:`SolveEngine` (``engine.py``) -- the single-operator
  compatibility shim.  ``Engine`` / ``Request``, the LM decode engine,
  wait for the models (ROADMAP.md, item 1.15) and raise.

Operators are built on CUDA unless the registry is given
``device="cpu"``.
"""
from .metrics import LatencySummary, ServeMetrics
from .registry import OperatorRegistry, RegistryMismatch, ResidentOperator
from .scheduler import GroupSolver, SolveRequest, SolveScheduler
from .engine import Engine, Request, SolveEngine

__all__ = [
    "Engine", "Request", "SolveEngine", "SolveRequest",
    "OperatorRegistry", "RegistryMismatch", "ResidentOperator",
    "GroupSolver", "SolveScheduler",
    "ServeMetrics", "LatencySummary",
]
