"""Serving engines: the solve-serving shim, and the LM engine's place.

Port of ``repro/serve/engine.py``'s :class:`SolveEngine`: a thin
single-operator COMPATIBILITY SHIM over the multi-tenant path
(:mod:`repro_torch.serve.registry` + :mod:`repro_torch.serve.scheduler`)
-- same constructor, same blocking ``run(requests)``, same typed request
statuses -- for callers who have one operator in hand and no interest
in tenancy.  New code should drive the registry and scheduler directly.

The reference's LM decode engine (``Engine`` and its ``Request``) needs
a model's cache and decode step, which come with the models (ROADMAP.md,
item 1.15); here both names raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import List

from repro_torch._todo import not_ported

from .scheduler import SolveRequest  # re-export: the shim's request type

__all__ = ["Engine", "Request", "SolveEngine", "SolveRequest"]


class Request:
    """The LM engine's request (a prompt and its decoded tokens); not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise not_ported("serve.Request (the LM engine's request)",
                         "lm_engine")


class Engine:
    """The LM continuous-batching decode engine; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise not_ported("serve.Engine (the LM decode engine)", "lm_engine")


class SolveEngine:
    """Single-operator compatibility shim over the serving subsystem.

    ``SolveEngine(op).run(requests)`` packs queued right-hand sides
    ``slots`` columns at a time into certified multi-RHS block-CG groups
    (SPD systems only -- the block-CG contract), with admission checks,
    deadline shedding (``deadline_s`` measured from submission) and
    poisoned-batch bisection.  Internally it is one resident operator in
    an :class:`~repro_torch.serve.registry.OperatorRegistry` (on the
    operator's device) driven by a :class:`~repro_torch.serve.scheduler.
    SolveScheduler`; the scheduler's metrics are ``engine.metrics`` and
    per-request summaries land in ``request.diagnostics["serve"]``.

    ``_dispatch`` / ``_admit`` are the fault-injection seams: they route
    into the underlying :class:`~repro_torch.serve.scheduler.GroupSolver`.
    """

    def __init__(self, op, *, slots: int = 4, maxiter: int = 2000,
                 tol: float = 1e-6, jacobi_precond: bool = False,
                 cert_slack: float = 10.0):
        if op.shape[0] != op.shape[1]:
            raise ValueError("SolveEngine serves square systems")
        from .registry import OperatorRegistry
        from .scheduler import SolveScheduler

        self.op = op
        self.slots = slots
        self.maxiter = maxiter
        self.tol = tol
        self.registry = OperatorRegistry(capacity=1, device=op.device)
        self.entry = self.registry.admit_operator(op)
        self.scheduler = SolveScheduler(
            self.registry, slots=slots, maxiter=maxiter, tol=tol,
            jacobi_precond=jacobi_precond, cert_slack=cert_slack)
        solver = self.scheduler.solver_for(self.entry)
        # late-bound hooks: a monkeypatched engine._dispatch/_admit is
        # picked up because the lambdas resolve the attribute per call
        solver._dispatch_fn = lambda batch: self._dispatch(batch)
        solver._admit_fn = lambda req: self._admit(req)
        self._solver = solver

    @property
    def metrics(self):
        return self.scheduler.metrics

    def _dispatch(self, batch: List[SolveRequest]):
        return self._solver.dispatch_impl(batch)

    def _admit(self, req: SolveRequest) -> bool:
        return self._solver.admit_impl(req)

    def run(self, requests: List[SolveRequest]) -> List[SolveRequest]:
        """Submit ``requests`` and block until all are finalized."""
        for req in requests:
            self.scheduler.submit(req)
        self.scheduler.run_until_drained()
        return requests
