"""Fault-injection harness: controlled chaos for the solve pipeline.

Port of ``repro/testing/faults.py``.  Each context manager injects ONE
failure mode and restores clean state on exit, so a fault test reads as

    with faults.poison_values(m, count=3):
        res = repro_torch.solve(m, b, fallback="off", device="cpu")
    assert res.status == "non_finite"

Injection points, and what each means in the port:

* **Values** (:func:`poison_values`) mutate the HOST matrix in place --
  the fault reaches the device only through builds that happen inside
  the ``with`` block (the conversion cache is cleared on entry and on
  exit).  Operators built before the block stay clean.
* **Tune cache** (:func:`corrupt_tune_cache`) mangles the JSON file on
  disk in a chosen ``mode``; the loader's quarantine must degrade to a
  re-measurement, never crash.
* **Solve paths** (:func:`fail_strategy`, :func:`fail_kernel_backend`)
  patch ``repro_torch.api._one_solve``, the reference's patch point, so
  selected rungs raise the way a failed kernel build, launch or graph
  capture would.  The port's ladder catches nothing (ROADMAP.md, queue
  3): the :class:`InjectedFault` propagates out of ``solve``, where the
  reference's ladder records it and walks on (and has a ``kernel->ref``
  rung the port does not).  The serving scheduler turns it into a typed
  ``"error"`` status.
* **Halo exchange** (:func:`drop_halo`, :func:`garble_halo`) patch
  ``core.dist_spmv._post_halo``: what the exchange posts is waited for
  as before, and then the fault is applied to the received buffers,
  which ``_ext_of`` and the pipeline's stages read -- so every mode and
  halo flavour sees it.  The product looks the function up as a module
  global at every call, so the patch reaches operators built before the
  block too, and ends with it (the reference's traced exchange must be
  built inside the block; the port's need not).  ``garble_halo``
  corrupts the received entries as a function of the rank's x slice --
  per-call INCONSISTENT on purpose: a consistently wrong exchange is
  just a different linear operator, which a Krylov solve happily
  "solves" and certifies, while an x-dependent corruption breaks
  linearity, which the breakdown / stagnation detectors and the
  certification can see.  ``drop_halo`` (received entries zeroed) IS a
  consistent wrong operator -- tests using it must check against the
  clean matrix out of band.
"""
from __future__ import annotations

import contextlib
import json
import pathlib

import numpy as np
import torch

from repro_torch.kernels._backend import resolve_backend

__all__ = [
    "poison_values",
    "corrupt_tune_cache",
    "fail_strategy",
    "fail_kernel_backend",
    "drop_halo",
    "garble_halo",
    "InjectedFault",
]


class InjectedFault(RuntimeError):
    """Raised by the forced-failure patches; lets tests distinguish the
    injected fault from a genuine one."""


# --------------------------------------------------------------------------
# Data faults
# --------------------------------------------------------------------------
@contextlib.contextmanager
def poison_values(m, *, count: int = 1, value: float = float("nan"),
                  seed: int = 0):
    """Overwrite ``count`` stored values of host CSR ``m`` with
    ``value`` (NaN by default), restoring them on exit."""
    from repro_torch.kernels import ops as K
    data = np.asarray(m.data)
    if data.size == 0:
        raise ValueError("cannot poison a matrix with no stored values")
    rng = np.random.default_rng(seed)
    idx = rng.choice(data.size, size=min(count, data.size), replace=False)
    saved = data[idx].copy()
    data[idx] = value
    # the conversion cache keys on the host object's id -- an in-place
    # mutation aliases stale builds both ways (a clean build hiding the
    # poison on entry, a poisoned build surviving the restore on exit)
    K.clear_device_cache()
    try:
        yield m
    finally:
        data[idx] = saved
        K.clear_device_cache()


# --------------------------------------------------------------------------
# Tune-cache faults
# --------------------------------------------------------------------------
def _rewrite_records(path: pathlib.Path, fn):
    payload = json.loads(path.read_text())
    entries = payload.get("entries", {})
    payload["entries"] = {k: fn(v) for k, v in entries.items()}
    path.write_text(json.dumps(payload))


@contextlib.contextmanager
def corrupt_tune_cache(path, mode: str = "truncate"):
    """Mangle the tune-cache file at ``path``; original bytes restored
    on exit.  ``mode``:

    * ``"truncate"`` -- cut the file mid-JSON (crashed writer).
    * ``"garbage"``  -- replace with non-JSON bytes.
    * ``"bad_schema"`` -- stamp every record ``schema: 999`` (written
      by a future version).
    * ``"missing_keys"`` -- strip every record down to its stamp.
    """
    p = pathlib.Path(path)
    orig = p.read_bytes() if p.exists() else None
    if mode == "truncate":
        if orig is None:
            raise FileNotFoundError(p)
        p.write_bytes(orig[: max(1, len(orig) // 2)])
    elif mode == "garbage":
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"\x00not json at all{{{")
    elif mode == "bad_schema":
        _rewrite_records(p, lambda rec: {**rec, "schema": 999}
                         if isinstance(rec, dict) else rec)
    elif mode == "missing_keys":
        _rewrite_records(p, lambda rec: {"schema": rec.get("schema")}
                         if isinstance(rec, dict) else rec)
    else:
        raise ValueError(f"unknown corrupt_tune_cache mode {mode!r}")
    try:
        yield p
    finally:
        if orig is None:
            p.unlink(missing_ok=True)
        else:
            p.write_bytes(orig)


# --------------------------------------------------------------------------
# Solve-path faults
# --------------------------------------------------------------------------
@contextlib.contextmanager
def fail_strategy(*strategies: str):
    """Make ``api._one_solve`` raise :class:`InjectedFault` for the
    given strategies (``"fused"``, ``"composed"``) -- a rung that dies
    the way a failed kernel launch does.  The raise propagates out of
    ``repro_torch.solve``."""
    from repro_torch import api
    orig = api._one_solve

    def patched(op, b, *, strategy, **kw):
        if strategy in strategies:
            raise InjectedFault(f"injected {strategy} failure")
        return orig(op, b, strategy=strategy, **kw)

    api._one_solve = patched
    try:
        yield
    finally:
        api._one_solve = orig


@contextlib.contextmanager
def fail_kernel_backend():
    """Make ``api._one_solve`` raise :class:`InjectedFault` whenever the
    operator resolves to the kernel backend for the right-hand side's
    device (``kernels._backend.resolve_backend``: a CUDA card) -- a
    kernel launch failure.  The port has no plain-version rung to fall
    to, so the raise propagates out of ``repro_torch.solve``."""
    from repro_torch import api
    orig = api._one_solve

    def patched(op, b, **kw):
        backend = getattr(op, "backend", None)
        if backend is not None and resolve_backend(b, backend) == "kernel":
            raise InjectedFault("injected kernel-launch failure")
        return orig(op, b, **kw)

    api._one_solve = patched
    try:
        yield
    finally:
        api._one_solve = orig


# --------------------------------------------------------------------------
# Halo-exchange faults (distributed operator)
# --------------------------------------------------------------------------
class _FaultedExchange:
    """An exchange handle whose ``wait`` applies ``fault`` to every
    receive buffer once, after the messages have landed."""

    def __init__(self, handle, bufs: dict, fault):
        self.handle, self.bufs, self.fault = handle, bufs, fault
        self.applied = False

    def wait(self) -> None:
        self.handle.wait()
        if not self.applied:
            for buf in self.bufs.values():
                buf.copy_(self.fault(buf))
            self.applied = True


@contextlib.contextmanager
def _halo_fault(fault):
    from repro_torch.core import dist_spmv as D
    orig = D._post_halo

    def patched(shard, x, comm, halo, ks):
        handle, bufs = orig(shard, x, comm, halo, ks)
        return _FaultedExchange(handle, bufs,
                                lambda buf: fault(buf, x)), bufs

    D._post_halo = patched
    try:
        yield
    finally:
        D._post_halo = orig


@contextlib.contextmanager
def drop_halo():
    """Zero the received halo -- a silently wrong but CONSISTENT linear
    operator (a lost message every call).  In-band certification cannot
    see this (it certifies through the same broken operator); tests
    must check against the clean matrix out of band."""
    with _halo_fault(lambda buf, x: torch.zeros_like(buf)):
        yield


@contextlib.contextmanager
def garble_halo(scale: float = 1.0):
    """Corrupt the received halo with an iterate-dependent term --
    per-call inconsistent, so the effective operator is NOT linear and
    the solver's breakdown / divergence detectors (or the certification)
    catch it instead of converging to a wrong answer."""
    def garble(buf, x):
        # nonlinear in x: breaks the Krylov invariants every iteration
        noise = torch.tanh(x.float().sum() * 7.0) + 0.5
        return buf + scale * noise.to(buf.dtype) * torch.sign(buf)

    with _halo_fault(garble):
        yield
