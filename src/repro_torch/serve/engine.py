"""Serving engines: LM continuous batching, and the solve-serving shim.

:class:`Engine` ports the reference's LM engine
(``repro/serve/engine.py:41-146``): requests queue up, each is
prefilled into a free cache slot, and every tick runs one batched
``decode_step`` for all slots, greedy argmax read on the host.  A
finished sequence (EOS or its token budget) frees its slot for the next
queued request.  Params may hold ``SparseLinear`` FFN modules
(``repro_torch.sparse``); their products then run through K5.  Every
family serves: a layer's cache may nest (cross-attention's ``{"self",
"xk", "xv"}``) or hold a recurrent state (``conv``, ``h``), and a
reused slot starts from a fresh cache.  As the reference's, the engine
takes no frames or patches: an encoder-decoder's cross keys and values
stay zero and a VLM serves text alone (``Model.prefill`` takes them).

**A deliberate difference.**  The reference's ``_prefill_one`` streams a
new prompt through ``decode_step`` for EVERY slot, so each slot already
decoding gets one extra cache entry per prompt token -- its own last
token at its own position -- and its attention then counts that
position twice: a request admitted while others decode changes their
tokens.  Here the prompt streams through the admitted slot alone, as
``decode_step`` on a batch-1 view of that slot's cache rows (the cache
is updated in place, so the view writes into the engine's cache), and no
other slot's cache changes: every request gets the tokens it gets alone.
An MoE layer is the exception the reference's semantics make: its
expert capacity counts every token of a step, idle slots included, so
a token's output depends on the tokens routed beside it.

:class:`SolveEngine` is a thin single-operator COMPATIBILITY SHIM over
the multi-tenant solve path (:mod:`repro_torch.serve.registry` +
:mod:`repro_torch.serve.scheduler`) -- same constructor, same blocking
``run(requests)``, same typed request statuses -- for callers who have
one operator in hand and no interest in tenancy.  New code should drive
the registry and scheduler directly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .scheduler import SolveRequest  # re-export: the shim's request type

__all__ = ["Engine", "Request", "SolveEngine", "SolveRequest"]


def _map_tree(fn, tree, *others):
    """``fn`` over the tensors of a nested dict (and the same places of
    ``others``), as a dict of the same shape."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Continuous-batching greedy decoding over ``batch_slots`` cache
    slots of ``max_len`` positions, on the model's device."""

    def __init__(self, model, params, *, batch_slots: int, max_len: int,
                 eos_id: int = -1):
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.eos = eos_id
        self.cache = model.init_cache(batch_slots, max_len)
        self.pos = np.zeros(batch_slots, np.int32)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.budget: List[int] = [0] * batch_slots
        self._last_tok = np.zeros((batch_slots, 1), np.int32)

    def _slot_cache(self, slot: int) -> list:
        """Slot ``slot``'s cache rows as a batch-1 cache: views, so a
        decode step on it writes into the engine's cache."""
        return [_map_tree(lambda t: t[slot:slot + 1], c) for c in self.cache]

    def _prefill_one(self, slot: int, req: Request):
        """Stream the prompt through decode steps of this slot alone."""
        view = self._slot_cache(slot)
        logits = None
        for tok in req.prompt.astype(np.int32):
            _, logits = self.model.decode_step(
                self.params, view, np.array([[tok]], np.int32),
                self.pos[slot:slot + 1].copy())
            self.pos[slot] += 1
        nxt = int(torch.argmax(logits[0, -1]).item())
        self._last_tok[slot, 0] = nxt
        req.out.append(nxt)

    def submit(self, req: Request) -> bool:
        for s in range(self.slots):
            if self.active[s] is None:
                self.active[s] = req
                # prefill emits the first token; budget covers the rest
                self.budget[s] = req.max_new - 1
                self.pos[s] = 0
                self._reset_slot(s)
                self._prefill_one(s, req)
                if self.budget[s] <= 0:
                    req.done = True
                    self.active[s] = None
                return True
        return False

    def _reset_slot(self, s: int):
        """Slot ``s`` back to a fresh cache: every tensor of every layer's
        (possibly nested) cache, recurrent states and cross keys
        included."""
        fresh = self.model.init_cache(1, self.max_len)
        for view, f in zip(self._slot_cache(s), fresh):
            _map_tree(lambda t, new: t.copy_(new), view, f)

    def step(self):
        """One engine tick: batched decode for all slots."""
        if not any(r is not None and not r.done for r in self.active):
            return
        self.cache, logits = self.model.decode_step(
            self.params, self.cache, self._last_tok.copy(), self.pos.copy())
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None or req.done:
                continue
            self.pos[s] += 1
            self.budget[s] -= 1
            tok = int(nxt[s])
            req.out.append(tok)
            self._last_tok[s, 0] = tok
            if tok == self.eos or self.budget[s] <= 0:
                req.done = True
                self.active[s] = None

    def run(self, requests: List[Request], max_ticks: int = 10_000):
        queue = list(requests)
        ticks = 0
        while (queue or any(self.active)) and ticks < max_ticks:
            while queue and self.submit(queue[0]):
                queue.pop(0)
            self.step()
            ticks += 1
        return requests


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
