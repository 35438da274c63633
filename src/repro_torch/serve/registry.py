"""Multi-tenant operator registry keyed by structural fingerprint.

Port of ``repro/serve/registry.py``.  The serving workload is many
tenants, few structures: a tenant shows up with a matrix, and very
often its sparsity STRUCTURE is one the system has already served -- the
same mesh re-assembled with new coefficients, the next time step of a
PDE.  Everything expensive about admitting an operator is a function of
the structure alone:

* the tuned kernel statics (``repro_torch.tune`` caches them
  persistently under ``formats.structural_fingerprint`` -- the SAME key
  this registry uses, so a new tenant whose structure was ever tuned on
  this card admits with ZERO tuning measurements);
* the format conversion (permutation + padding -- value-independent);
* the value map (where each host non-zero lands in the stored stream).

So the registry keys resident operators by fingerprint and makes the
warm paths cheap: a warm admit with identical values is a pure lookup;
a warm admit with NEW values on the same structure is a
zero-reconversion VALUE SWAP (one gather through the entry's value map
into the existing layout, then ``DeviceOperator.with_values``).  A warm
admit whose shape / nnz / dtype policy contradicts the resident entry
is REJECTED with :class:`RegistryMismatch`.

Capacity is bounded: admitting past ``capacity`` evicts the least
recently used resident (its tune-cache entry survives).  Operators live
on ``device`` (CUDA unless the registry is given another).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from repro_torch.kernels._backend import host_tensor, resolve_device

__all__ = ["RegistryMismatch", "ResidentOperator", "OperatorRegistry"]

# Above this nnz an f32-exact value map cannot be built (the tag stream
# would lose integer precision); value swaps then reconvert, which is
# correct but not zero-cost.
_MAP_EXACT_NNZ = 1 << 24


class RegistryMismatch(ValueError):
    """A fingerprint hit whose shape / nnz / dtype policy contradicts
    the resident entry: served would be wrong, so admit refuses."""


@dataclasses.dataclass
class ResidentOperator:
    """One resident tenant operator and its serving bookkeeping."""

    key: str                     # structural fingerprint (or opaque:<id>)
    op: object                   # SparseOperator serving this structure
    shape: tuple
    nnz: int
    policy: str                  # dtype-policy contract (cache.dtype_policy)
    backend: str = "auto"
    build_kwargs: dict = dataclasses.field(default_factory=dict)
    tune_info: Optional[dict] = None   # {"cached": bool, "label": str}
    host: bool = False           # admitted from a host CSR (swaps possible)
    hits: int = 0
    swaps: int = 0
    version: int = 0             # bumped on every value swap -- consumers
    #                              caching derived state (Jacobi scales)
    #                              key on it
    _data_sha: Optional[str] = None
    _val_map: Optional[np.ndarray] = None   # stored slot -> nnz index (-1 pad)
    _dtype: Optional[object] = None
    _index_dtype: object = "auto"

    def stats(self) -> dict:
        return {"key": self.key, "shape": list(self.shape), "nnz": self.nnz,
                "policy": self.policy, "hits": self.hits,
                "swaps": self.swaps,
                "tuned": None if self.tune_info is None else self.tune_info}


def _data_sha(data: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(data).tobytes()).hexdigest()


class OperatorRegistry:
    """LRU-bounded registry of resident operators; see module docstring.

    ``tune`` is the registry-wide default admission policy (``"auto"`` /
    ``"force"`` / ``"off"``); ``cache`` / ``measure_fn`` thread straight
    into ``repro_torch.tune.autotune`` -- an injected ``measure_fn`` is
    the hook that PROVES a warm admit measures nothing.  ``device`` is
    where admitted operators are built and tuned (CUDA unless named;
    resolved at each admission)."""

    def __init__(self, capacity: int = 8, *, tune: str = "auto",
                 cache=None, measure_fn: Optional[Callable] = None,
                 device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self.tune = tune
        self.cache = cache
        self.measure_fn = measure_fn
        self.device = device
        self.evictions = 0
        self._entries: "OrderedDict[str, ResidentOperator]" = OrderedDict()

    # -- lookup ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def keys(self):
        return list(self._entries)

    def get(self, key: str) -> Optional[ResidentOperator]:
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
        return e

    def entries(self):
        return list(self._entries.values())

    # -- admission ---------------------------------------------------------
    def admit(self, m, *, dtype=None, index_dtype="auto", backend="auto",
              tune: Optional[str] = None,
              format: str = "auto") -> ResidentOperator:
        """Admit a host ``CSRMatrix`` and return its resident entry.

        Cold structure: tune (per registry/``tune`` policy -- a
        persistent-cache hit already costs zero measurements), build the
        operator once, insert (evicting LRU past capacity).  Warm
        structure: verify the shape/nnz/dtype-policy contract
        (:class:`RegistryMismatch` on contradiction), then swap values
        in place through the value map iff they changed.  The entry's
        LAYOUT is fixed at first admission -- warm admits serve the
        resident layout regardless of ``format``/``tune`` arguments."""
        from repro_torch.core import formats as F
        from repro_torch.tune import cache as C

        if not isinstance(m, F.CSRMatrix):
            raise TypeError(
                f"admit() takes a host CSRMatrix; got {type(m).__name__} "
                "(wrap existing operators with admit_operator())")
        key = F.structural_fingerprint(m)
        policy = C.dtype_policy(dtype, index_dtype)
        e = self._entries.get(key)
        if e is not None:
            self._check_contract(e, m, policy)
            self._entries.move_to_end(key)
            e.hits += 1
            sha = _data_sha(m.data)
            if sha != e._data_sha:
                self._swap_values(e, m)
                e._data_sha = sha
            return e

        dev = resolve_device(self.device)
        tune = self.tune if tune is None else tune
        build_kwargs = {"format": format}
        tune_info = None
        if tune in ("auto", "force"):
            from repro_torch.tune import autotune
            tr = autotune(m, format=format, dtype=dtype,
                          index_dtype=index_dtype, cache=self.cache,
                          force=(tune == "force"),
                          measure_fn=self.measure_fn, device=dev)
            build_kwargs = tr.best.build_kwargs()
            tune_info = {"cached": tr.cached, "label": tr.best.label()}
        elif tune not in ("off", False, None):
            raise ValueError(f"tune must be 'auto', 'force' or 'off'; "
                             f"got {tune!r}")

        from repro_torch.core.operator import operator
        op = operator(m, dtype=dtype, index_dtype=index_dtype,
                      backend=backend, device=dev, **build_kwargs)
        # Record the RESOLVED layout, not the request: the value-map
        # build must replay the exact conversion.
        build_kwargs = dict(build_kwargs)
        build_kwargs["format"] = op.fmt
        e = ResidentOperator(key=key, op=op, shape=tuple(m.shape),
                             nnz=m.nnz, policy=policy, backend=backend,
                             build_kwargs=build_kwargs,
                             tune_info=tune_info, host=True,
                             _data_sha=_data_sha(m.data), _dtype=dtype,
                             _index_dtype=index_dtype)
        self._insert(key, e)
        return e

    def admit_operator(self, op, key: Optional[str] = None
                       ) -> ResidentOperator:
        """Register an EXISTING operator (no host matrix).  No tuning,
        no value swaps -- the path :class:`~repro_torch.serve.engine.
        SolveEngine` rides; ``key`` defaults to an opaque identity key
        (such entries never alias a fingerprint)."""
        key = key or f"opaque:{id(op):x}"
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
            e.hits += 1
            return e
        e = ResidentOperator(key=key, op=op, shape=tuple(op.shape),
                             nnz=-1, policy="as-built", host=False)
        self._insert(key, e)
        return e

    def evict(self, key: str) -> bool:
        return self._entries.pop(key, None) is not None

    def stats(self) -> dict:
        return {"resident": len(self._entries), "capacity": self.capacity,
                "evictions": self.evictions,
                "entries": [e.stats() for e in self._entries.values()]}

    # -- internals ---------------------------------------------------------
    def _insert(self, key: str, e: ResidentOperator) -> None:
        self._entries[key] = e
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    @staticmethod
    def _check_contract(e: ResidentOperator, m, policy: str) -> None:
        if tuple(e.shape) != tuple(m.shape) or e.nnz != m.nnz:
            raise RegistryMismatch(
                f"fingerprint {e.key[:12]} hit with mismatched structure: "
                f"resident shape={e.shape} nnz={e.nnz}, "
                f"offered shape={tuple(m.shape)} nnz={m.nnz}")
        if e.policy != policy:
            raise RegistryMismatch(
                f"fingerprint {e.key[:12]} hit with mismatched dtype "
                f"policy: resident {e.policy!r}, offered {policy!r} -- "
                "evict first or use a separate registry per storage "
                "contract")
        if not e.host:
            raise RegistryMismatch(
                f"entry {e.key[:12]} was admitted as an opaque operator; "
                "it cannot serve host-matrix admissions")

    def _swap_values(self, e: ResidentOperator, m) -> None:
        """New coefficients on the resident structure, without touching
        it: gather the host value stream through the entry's value map
        into the stored layout and ``with_values`` the operator (the
        structure is shared; the walk lengths, which follow the values,
        are derived again).  Reconverts when the map cannot be exact."""
        vmap = self._value_map(e, m)
        if vmap is None:
            from repro_torch.core.operator import operator
            e.op = operator(m, dtype=e._dtype, index_dtype=e._index_dtype,
                            backend=e.backend, device=e.op.device,
                            **e.build_kwargs)
        else:
            stored = np.where(vmap >= 0, m.data[np.clip(vmap, 0, None)],
                              0.0).astype(np.float32)
            e.op = e.op.with_values(
                host_tensor(stored, e.op.device).to(e.op.values.dtype))
        e.swaps += 1
        e.version += 1

    @staticmethod
    def _value_map(e: ResidentOperator, m) -> Optional[np.ndarray]:
        """stored-slot -> host-nnz-index (-1 for padding), built ONCE
        per entry by replaying the structure conversion on a tag stream
        (data[i] = i + 1, exactly representable in f32 below 2^24):
        every stored slot then carries the index of the host non-zero it
        came from -- format conversions are pure gather/pad, so this is
        the whole layout in one array."""
        if e._val_map is not None:
            return e._val_map
        if m.nnz >= _MAP_EXACT_NNZ:
            return None
        from repro_torch.kernels import ops

        tags = np.arange(1, m.nnz + 1, dtype=np.float32)
        m_tag = dataclasses.replace(m, data=tags)
        sd = ops.as_device(m_tag, device=e.op.device, **e.build_kwargs)
        stored = sd.values.detach().cpu().numpy().astype(np.float64)
        vmap = np.rint(stored).astype(np.int64) - 1
        if vmap.shape != tuple(e.op.values.shape):
            return None                      # layout replay drifted: rebuild
        e._val_map = vmap
        return vmap
