"""Collective traffic and flops of a step, recorded as it runs.

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
  are left out).

:func:`collective_bytes` applies the reference's ring costs per rank to
the records (R = the result's bytes on one rank, G = the group's size)::

    all-gather          R * (G-1)/G    (receives the rest)
    all-reduce          2R * (G-1)/G   (reduce-scatter + all-gather)
    reduce-scatter      R * (G-1)      (input = R * G)
    all-to-all          R * (G-1)/G
    collective-permute  R              (one send)

and returns the reference's ``{"total", "per_op", "counts"}``.  The
reference's ``hlo_flops_bytes`` has no counterpart: flops come from the
recorder.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["StepRecorder", "collective_bytes", "OP_NAMES"]

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


class StepRecorder(TorchDispatchMode):
    """``with StepRecorder() as r: step(...)``; then ``r.collectives``
    (list of {"op", "bytes", "group"}) and ``r.flops`` (this rank's)."""

    def __init__(self):
        super().__init__()
        self.collectives: list = []
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: its local operations and the
            # collectives of its redistributions then come back here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._overloadpacket.__name__
        if ns.startswith("_c10d_functional") and name in OP_NAMES:
            self.collectives.append({"op": OP_NAMES[name],
                                     "bytes": _nbytes(out),
                                     "group": _group_size(args, kwargs)})
            return out
        packet = func._overloadpacket
        if packet in flop_registry and not _propagating():
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        return out


def _propagating(depth: int = 12) -> bool:
    """Whether DTensor's sharding propagation runs this operation on
    global shapes to learn its output's (under a fake tensor mode it
    reaches the recorder): not work of the rank."""
    import sys
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


def collective_bytes(records) -> dict:
    """Per-rank bytes moved by ``records`` (StepRecorder's), with the
    reference's ring costs.  Returns {"total", "per_op", "counts"}."""
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
        counts[op] += 1
    return {"total": float(sum(per_op.values())),
            "per_op": dict(per_op), "counts": dict(counts)}
