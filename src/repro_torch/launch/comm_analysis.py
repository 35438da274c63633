"""Collective traffic, flops, bytes and peak memory of a step, recorded
as it runs.

Counterpart of ``repro/launch/hlo_analysis.py``.  The port has no HLO:
:class:`StepRecorder`, a ``TorchDispatchMode``, lets DTensor handle each
of its operations first (as ``CommDebugMode`` does), so that it sees
what DTensor runs underneath -- the local operations and the
collectives of every redistribution, implicit ones included -- and
records

* each ``_c10d_functional`` collective (what DTensor's redistributes and
  the model's explicit reductions issue): its op, the bytes of its
  result on this rank and its group's size;
* the flops of each local (non-DTensor) operation, by the formulas of
  ``torch.utils.flop_counter`` (``FlopCounterMode``'s registry), so a
  rank's flops are those of its shards (the global-shape runs of
  DTensor's sharding propagation, which a fake tensor mode lets through,
  are left out);
* the bytes of each local operation: every tensor input read once and
  every tensor output written once, at their local shapes -- the
  unfused traffic of the eager step, not a compiler's bytes after
  fusion.  An operation whose outputs all alias its inputs without
  writing them (a view) moves nothing;
* the peak of live storage on the rank: the step's argument storages
  (:meth:`StepRecorder.hold`) from the start, then each storage an
  operation reads or returns, counted once, until its last tensor dies.

Neither bytes nor memory counts the global-shape tensors of DTensor's
sharding propagation, nor a collective's traffic (its output storage is
live memory and counts toward the peak).  It runs on fake tensors (the
dry run) and on real ones alike.

:func:`collective_bytes` applies the reference's ring costs per rank to
the records (R = the result's bytes on one rank, G = the group's size)::

    all-gather          R * (G-1)/G    (receives the rest)
    all-reduce          2R * (G-1)/G   (reduce-scatter + all-gather)
    reduce-scatter      R * (G-1)      (input = R * G)
    all-to-all          R * (G-1)/G
    collective-permute  R              (one send)

and returns the reference's ``{"total", "per_op", "counts"}``.  The
reference's ``hlo_flops_bytes`` (XLA's post-fusion flops and bytes
accessed) has its counterpart in the recorder's ``flops`` and
``bytes``.
"""
from __future__ import annotations

import threading
import weakref
from collections import defaultdict
from collections.abc import Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["StepRecorder", "collective_bytes", "tree_tensors", "OP_NAMES"]

# _c10d_functional op -> the reference's (HLO) name
OP_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


# ``tensor.device`` on a tensor subclass: a query, not work
_DEVICE_QUERY = torch.ops.prim.device.default


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def _group_size(args, kwargs) -> int:
    """The group size of a functional collective: from its group name
    (the last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in list(args) + list(kwargs.values())
             if isinstance(a, str)]
    return _resolve_process_group(names[-1]).size()


def tree_tensors(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples (named ones too) and
    modules (their parameters and buffers); a DTensor as its local
    tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return tree_tensors([*tree.parameters(), *tree.buffers()])
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return []


def _flat(obj) -> list:
    """The tensors among an operation's arguments or results."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _flat(o)]
    if isinstance(obj, Mapping):
        return [t for o in obj.values() for t in _flat(o)]
    return []


def _storage(t):
    return t.untyped_storage() if t.layout == torch.strided else None


class StepRecorder(TorchDispatchMode):
    """``r = StepRecorder(); r.hold(args); with r: step(*args)``; then
    ``r.collectives`` (list of {"op", "bytes", "group"}), ``r.flops``,
    ``r.bytes`` (this rank's unfused traffic) and ``r.peak_bytes`` (the
    most live storage at once, the held arguments included)."""

    def __init__(self):
        super().__init__()
        self.collectives: list = []
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}           # id(storage) -> nbytes
        self._lock = threading.Lock()

    def hold(self, *trees) -> int:
        """Count the storages of ``trees`` (the step's arguments) as live
        from now on; returns the bytes newly counted."""
        before = self.live_bytes
        for t in tree_tensors(list(trees)):
            self._track(t)
        return self.live_bytes - before

    def _track(self, t) -> None:
        st = _storage(t)
        if st is None:
            return
        key = id(st)
        with self._lock:
            if key in self._live:
                return
            n = int(st.nbytes())
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0)

    def _account(self, func, args, kwargs, out) -> None:
        ins = _flat(args) + _flat(kwargs)
        outs = _flat(out)
        for t in ins + outs:
            self._track(t)
        if not outs:
            return
        in_keys = {id(st) for st in map(_storage, ins) if st is not None}
        writes = func._schema.is_mutable or any(
            (st := _storage(o)) is None or id(st) not in in_keys
            for o in outs)
        if writes:
            self.bytes += sum(_nbytes(t) for t in ins + outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: its local operations and the
            # collectives of its redistributions then come back here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE_QUERY:
            # about half the operations of a step: moves nothing
            return out
        ns, name = func.namespace, func._overloadpacket.__name__
        if ns.startswith("_c10d_functional") and name in OP_NAMES:
            self.collectives.append({"op": OP_NAMES[name],
                                     "bytes": _nbytes(out),
                                     "group": _group_size(args, kwargs)})
            for t in _flat(out):
                self._track(t)
            return out
        if _propagating():
            return out
        self._account(func, args, kwargs, out)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        return out


# DTensor's sharding propagation: below these frames an operation runs
# on global shapes, or on a one-rank fake mesh, to learn a sharding
_PROPAGATION = frozenset({"_propagate_tensor_meta_non_cached",
                          "propagate_op_sharding_non_cached"})


def _propagating(depth: int = 24) -> bool:
    """Whether DTensor's sharding propagation runs this operation to
    learn its output's sharding (under a fake tensor mode it reaches
    the recorder): not work of the rank.  It runs only on a miss of
    DTensor's cache, so counting it would make a trace's counts depend
    on what the process traced before.  Such frames lay at most 14
    below the operation in the train and decode steps measured."""
    import sys
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


def collective_bytes(records) -> dict:
    """Per-rank bytes moved by ``records`` (StepRecorder's), with the
    reference's ring costs.  A record may stand for ``count`` collectives
    of one op and group, ``bytes`` their results' sum.  Returns
    {"total", "per_op", "counts"}."""
    per_op = defaultdict(float)
    counts = defaultdict(int)
    for r in records:
        op, nb, g = r["op"], float(r["bytes"]), max(int(r["group"]), 1)
        if op == "all-gather":
            moved = nb * (g - 1) / g
        elif op == "all-reduce":
            moved = 2 * nb * (g - 1) / g
        elif op == "reduce-scatter":
            moved = nb * (g - 1)
        elif op == "all-to-all":
            moved = nb * (g - 1) / g
        else:  # collective-permute
            moved = nb
        per_op[op] += moved
        counts[op] += int(r.get("count", 1))
    return {"total": float(sum(per_op.values())),
            "per_op": dict(per_op), "counts": dict(counts)}
