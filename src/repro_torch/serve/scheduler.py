"""Continuous-batching solve scheduler over the operator registry.

Port of ``repro/serve/scheduler.py``.  The serving pipeline is

    submit() --admission--> per-operator queue --tick()--> block-CG group
       |                        |                              |
       rejected (typed)         shed (deadline expired)        certified /
                                                               bisected

* **Async admission** -- :meth:`SolveScheduler.submit` validates the RHS
  against its tenant's resident operator (shape, finiteness) and
  enqueues; nothing solves until a tick.
* **Continuous RHS batching** -- every :meth:`~SolveScheduler.tick`
  pops up to ``slots`` queued requests PER resident operator and solves
  them as ONE multi-RHS block-CG group (``repro_torch.solve(...,
  method="block_cg", fallback="off")``), so each CG iteration streams
  the matrix once for the whole group on SELL / pJDS (K5); on
  ELLPACK-R and CMRS the block product runs K4 / K6 once per column.
  Completed groups free their slots for the next tick's queue drain.
* **Deadline-aware shedding** -- a request may carry ``deadline_s``
  (seconds after submission).  Expired requests are shed at the next
  tick, before they can occupy a slot; live deadlined requests are
  batched earliest-deadline-first ahead of deadline-free ones.
* **Certification + bisection** -- each group rides
  :class:`GroupSolver`: per-column certification against the original
  system, poisoned-group bisection isolating a bad column in O(log
  slots) re-solves, typed per-request ``status``.  A group whose solve
  RAISES is split the same way, and a single request that still raises
  ends ``"error"`` with the exception in ``diagnostics["error"]``: in
  the port a raise is a kernel build, launch or capture failure (the
  solve's ladder lets every raise through), so a caller that must not
  serve such a failure checks for that status.
* **Metrics** -- every event lands in a :class:`~repro_torch.serve.
  metrics.ServeMetrics`, and each completed request carries its own
  summary under ``request.diagnostics["serve"]``.

The scheduler owns time through an injectable ``clock`` (default
``time.monotonic``), so deterministic-clock tests drive shedding and
latency accounting without sleeping.  SPD systems only: the block-CG
contract.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.kernels._backend import host_tensor

from .metrics import ServeMetrics
from .registry import OperatorRegistry, ResidentOperator

__all__ = ["SolveRequest", "GroupSolver", "SolveScheduler"]


@dataclasses.dataclass
class SolveRequest:
    """One tenant solve request: ``x = A^-1 b`` against the resident
    operator of ``tenant`` (a registry key; optional when only one
    operator is resident).  ``deadline_s`` counts from submission."""

    rid: int
    b: np.ndarray                # (n,) right-hand side, original basis
    tenant: Optional[str] = None
    deadline_s: Optional[float] = None
    x: Optional[np.ndarray] = None
    iters: int = 0
    residual: float = float("inf")
    status: str = "pending"      # queued/converged/maxiter/breakdown/
    #                              diverged/non_finite/rejected/shed/error
    diagnostics: dict = dataclasses.field(default_factory=dict)
    done: bool = False


class GroupSolver:
    """Certified block-CG group solves against ONE resident operator.

    Shared by the scheduler and the :class:`~repro_torch.serve.engine.
    SolveEngine` shim: zero-padded ``slots``-column dispatch, per-column
    certification in the solver's own basis, poisoned-group bisection,
    typed statuses.  ``dispatch_fn`` / ``admit_fn`` are indirection
    hooks for the shim (fault tests monkeypatch the engine's methods;
    the hooks route those patches here).

    Reads ``entry.op`` at every dispatch and keys the cached Jacobi
    scaling on ``entry.version``, so registry value swaps take effect
    without rebuilding the solver.
    """

    def __init__(self, entry: ResidentOperator, *, slots: int = 4,
                 maxiter: int = 2000, tol: float = 1e-6,
                 jacobi_precond: bool = False, cert_slack: float = 10.0,
                 metrics: Optional[ServeMetrics] = None,
                 dispatch_fn: Optional[Callable] = None,
                 admit_fn: Optional[Callable] = None):
        if entry.op.shape[0] != entry.op.shape[1]:
            raise ValueError("GroupSolver serves square systems")
        self.entry = entry
        self.slots = slots
        self.maxiter = maxiter
        self.tol = tol
        self.jacobi_precond = jacobi_precond
        # tol stops the recurrence; certification accepts within
        # cert_slack * tol (recurrence-vs-true drift near the storage
        # dtype's accuracy floor; a poisoned column sits at NaN or
        # O(1), orders of magnitude past any sane slack).
        self._cert_tol = tol * cert_slack
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._dispatch_fn = dispatch_fn
        self._admit_fn = admit_fn
        self._scale = None
        self._scaled_apply = None
        self._scale_version = None

    # -- hooks -------------------------------------------------------------
    def admit(self, req: SolveRequest) -> bool:
        if self._admit_fn is not None:
            return self._admit_fn(req)
        return self.admit_impl(req)

    def dispatch(self, batch: List[SolveRequest]):
        if self._dispatch_fn is not None:
            return self._dispatch_fn(batch)
        return self.dispatch_impl(batch)

    # -- admission ---------------------------------------------------------
    def admit_impl(self, req: SolveRequest) -> bool:
        """Reject a request whose RHS would poison a batch: wrong
        shape, too long for the operator, or non-finite entries."""
        op = self.entry.op
        b = np.asarray(req.b)
        reason = None
        if b.ndim != 1:
            reason = f"b must be 1-D, got shape {b.shape}"
        elif len(b) > op.shape[0]:
            reason = f"b has {len(b)} rows, operator has {op.shape[0]}"
        elif not np.all(np.isfinite(b)):
            reason = "b contains non-finite values"
        if reason is not None:
            req.status = "rejected"
            req.diagnostics["reason"] = reason
            req.done = True
            return False
        return True

    # -- dispatch ----------------------------------------------------------
    def _jacobi(self):
        """(scale, scaled_apply) for the current operator values,
        rebuilt only when a value swap bumps ``entry.version``."""
        if not self.jacobi_precond:
            return None, None
        if self._scale_version != self.entry.version:
            op = self.entry.op
            d = op.diagonal().detach().float().cpu().numpy()
            scale = np.where(d > 0, 1.0 / np.sqrt(np.abs(d) + 1e-30),
                             1.0).astype(d.dtype)
            s = host_tensor(scale, op.device)[:, None]
            self._scale = scale
            self._scaled_apply = lambda X: s * op.matmat(s * X)
            self._scale_version = self.entry.version
        return self._scale, self._scaled_apply

    def dispatch_impl(self, batch: List[SolveRequest]):
        """One block-CG solve for ``batch``, zero-padded to ``slots``
        columns, on the operator's device (with Jacobi scaling the
        solve gets the bare closure ``s * op.matmat(s * X)``).  Returns
        ``(x, rr, rr_cert, res)`` where ``rr`` is the per-column TRUE
        relative residual of the ORIGINAL system and ``rr_cert`` the
        certification signal in the basis the solver targeted tol in
        (numpy, float32, as the reference computes them)."""
        import repro_torch
        op = self.entry.op
        dev = op.device
        scale, scaled_apply = self._jacobi()
        n = op.shape[0]
        bmat = np.zeros((n, self.slots), dtype=np.float32)
        for j, req in enumerate(batch):
            bmat[: len(req.b), j] = req.b
        if scale is None:
            res = repro_torch.solve(op, host_tensor(bmat, dev),
                                    method="block_cg", maxiter=self.maxiter,
                                    tol=self.tol, fallback="off")
            x = res.x.detach().cpu().numpy()
        else:
            res = repro_torch.solve(scaled_apply,
                                    host_tensor(scale[:, None] * bmat, dev),
                                    method="block_cg", maxiter=self.maxiter,
                                    tol=self.tol, fallback="off", device=dev)
            x = scale[:, None] * res.x.detach().cpu().numpy()
        with np.errstate(invalid="ignore", over="ignore"):
            ax = op.matmat(host_tensor(x, dev)).detach().cpu().numpy()
            r = bmat - ax
            rr = np.linalg.norm(r, axis=0) \
                / np.maximum(np.linalg.norm(bmat, axis=0), 1e-30)
            if scale is None:
                rr_cert = rr
            else:
                # s*(b - A x) == b' - A' x', so no second matmat needed.
                sc = scale[:, None]
                rr_cert = np.linalg.norm(sc * r, axis=0) \
                    / np.maximum(np.linalg.norm(sc * bmat, axis=0), 1e-30)
        return x, rr, rr_cert, res

    # -- group solve with certification + bisection ------------------------
    def solve_group(self, batch: List[SolveRequest]) -> None:
        """Solve a group, certify each column, bisect on failure.

        A single poisoned column corrupts the whole block-CG recurrence
        (the Gram matrix couples the columns), so certification failure
        says "someone in this group is bad", not who.  Splitting the
        group in half and re-solving isolates the culprit in
        O(log slots) extra solves while every healthy request still
        gets a certified answer."""
        try:
            x, rr, rr_cert, res = self.dispatch(batch)
        except Exception as e:     # a build, launch or capture failure
            if len(batch) == 1:
                req = batch[0]
                req.status = "error"
                req.diagnostics["error"] = f"{type(e).__name__}: {e}"
                req.done = True
                return
            self.metrics.inc("group_splits")
            mid = (len(batch) + 1) // 2
            self.solve_group(batch[:mid])
            self.solve_group(batch[mid:])
            return
        retry: List[SolveRequest] = []
        for j, req in enumerate(batch):
            rn = float(rr_cert[j])
            if np.isfinite(rn) and rn <= self._cert_tol:
                req.x = x[: len(req.b), j]
                req.iters = int(res.iters)
                req.residual = float(rr[j])
                req.status = "converged"
                req.done = True
            elif len(batch) == 1:
                # isolated and still failing: this request is the poison
                req.x = x[: len(req.b), j]
                req.iters = int(res.iters)
                req.residual = float(rr[j])
                req.status = "non_finite" if not np.isfinite(rn) \
                    else res.status
                if req.status == "converged":   # recurrence lied; rn didn't
                    req.status = "diverged"
                req.diagnostics["true_residual"] = rn
                req.diagnostics.update(
                    {k: v for k, v in res.diagnostics.items()
                     if k not in req.diagnostics})
                req.done = True
            else:
                retry.append(req)
        if retry:
            self.metrics.inc("group_splits")
            if len(retry) == 1:
                self.solve_group(retry)
            else:
                mid = (len(retry) + 1) // 2
                self.solve_group(retry[:mid])
                self.solve_group(retry[mid:])


@dataclasses.dataclass
class _Queued:
    req: SolveRequest
    key: str
    seq: int
    t_submit: float
    t_deadline: Optional[float]       # absolute clock time; None = never


class SolveScheduler:
    """The multi-tenant serving loop; see the module docstring.

    ``registry`` holds the resident operators (one queue + one
    :class:`GroupSolver` per resident).  ``slots``/``maxiter``/``tol``/
    ``jacobi_precond``/``cert_slack`` parameterize every group solver;
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, registry: OperatorRegistry, *, slots: int = 4,
                 maxiter: int = 2000, tol: float = 1e-6,
                 jacobi_precond: bool = False, cert_slack: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[ServeMetrics] = None):
        self.registry = registry
        self.slots = slots
        self.maxiter = maxiter
        self.tol = tol
        self.jacobi_precond = jacobi_precond
        self.cert_slack = cert_slack
        self.clock = clock
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._queues: Dict[str, deque] = {}
        self._solvers: Dict[str, GroupSolver] = {}
        self._seq = 0

    # -- solvers -----------------------------------------------------------
    def solver_for(self, entry: ResidentOperator) -> GroupSolver:
        s = self._solvers.get(entry.key)
        if s is None or s.entry is not entry:
            s = GroupSolver(entry, slots=self.slots, maxiter=self.maxiter,
                            tol=self.tol, jacobi_precond=self.jacobi_precond,
                            cert_slack=self.cert_slack, metrics=self.metrics)
            self._solvers[entry.key] = s
        return s

    def _resolve_entry(self, tenant: Optional[str]) -> ResidentOperator:
        if tenant is None:
            entries = self.registry.entries()
            if len(entries) == 1:
                return entries[0]
            raise ValueError(
                f"tenant=None is ambiguous with {len(entries)} resident "
                "operators; pass the registry key (request.tenant)")
        e = self.registry.get(tenant)
        if e is None:
            raise KeyError(f"no resident operator for tenant {tenant!r} — "
                           "admit it first (registry.admit)")
        return e

    # -- admission ---------------------------------------------------------
    def submit(self, req: SolveRequest,
               tenant: Optional[str] = None) -> SolveRequest:
        """Asynchronous admission: validate, enqueue, return.  The
        request solves at a later :meth:`tick`; a rejected request is
        finalized immediately (typed ``status="rejected"``)."""
        key_req = tenant if tenant is not None else req.tenant
        entry = self._resolve_entry(key_req)
        req.tenant = entry.key
        solver = self.solver_for(entry)
        if not solver.admit(req):
            self.metrics.inc("rejected")
            return req
        now = self.clock()
        self._seq += 1
        item = _Queued(req=req, key=entry.key, seq=self._seq, t_submit=now,
                       t_deadline=(None if req.deadline_s is None
                                   else now + req.deadline_s))
        self._queues.setdefault(entry.key, deque()).append(item)
        req.status = "queued"
        self.metrics.inc("admitted")
        return req

    # -- the serving loop --------------------------------------------------
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _shed_expired(self, items: List[_Queued], now: float
                      ) -> List[_Queued]:
        live = []
        for it in sorted(items, key=lambda i: (i.t_deadline is None,
                                               i.t_deadline or 0.0, i.seq)):
            if it.t_deadline is not None and now >= it.t_deadline:
                it.req.status = "shed"
                it.req.diagnostics["deadline_s"] = it.req.deadline_s
                it.req.diagnostics["serve"] = {
                    "queue_s": now - it.t_submit, "tenant": it.key}
                it.req.done = True
                self.metrics.inc("shed")
            else:
                live.append(it)
        return live

    def tick(self) -> int:
        """One scheduling round: per resident operator, shed expired
        requests, form ONE group (earliest-deadline-first, FIFO among
        deadline-free), solve it, account.  Returns the number of
        requests finalized this tick (solved, failed, or shed)."""
        finalized = 0
        for key in list(self._queues):
            q = self._queues.get(key)
            if not q:
                self._queues.pop(key, None)
                continue
            now = self.clock()
            n_before = len(q)
            live = self._shed_expired(list(q), now)
            finalized += n_before - len(live)
            # EDF among deadlined, then FIFO: _shed_expired already
            # returns that order (deadlined ascending, then by seq).
            batch_items = live[: self.slots]
            rest = live[self.slots:]
            self._queues[key] = deque(rest)
            if not batch_items:
                continue
            entry = self.registry.get(key)
            solver = self.solver_for(entry)
            t_start = self.clock()
            solver.solve_group([it.req for it in batch_items])
            t_end = self.clock()
            self.metrics.observe_batch(len(batch_items), self.slots)
            for it in batch_items:
                req = it.req
                queue_s = t_start - it.t_submit
                solve_s = t_end - t_start
                req.diagnostics["serve"] = {
                    "queue_s": queue_s, "solve_s": solve_s,
                    "total_s": queue_s + solve_s,
                    "batch_k": len(batch_items), "tenant": key,
                }
                self.metrics.observe_request(queue_s, solve_s,
                                             queue_s + solve_s)
                if req.status == "converged":
                    self.metrics.inc("converged")
                elif req.status == "error":
                    self.metrics.inc("error")
                else:
                    self.metrics.inc("failed")
                finalized += 1
        return finalized

    def run_until_drained(self, max_ticks: int = 10_000) -> int:
        """Tick until every queue is empty; returns ticks consumed."""
        ticks = 0
        while self.pending() and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks
