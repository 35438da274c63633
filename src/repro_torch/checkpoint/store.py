"""Fault-tolerant checkpointing with atomic commit and asynchronous save.

Port of ``repro/checkpoint/store.py``, in the reference's layout::

    <dir>/step_<N>/
        manifest.json     the leaves' names, shapes and dtypes, extra, and
                          the logical specs (``spec_tree``) when given
        leaf_<i>.npy      one file per leaf
        _COMMITTED        written last -> atomic visibility

* **Atomic commit** -- a save stages into ``step_N.tmp`` and renames it
  (``os.replace``); a crash mid-save never corrupts the latest
  checkpoint, and :func:`latest_step` counts committed directories only.
* **Async save** -- :class:`AsyncCheckpointer` copies every leaf to the
  host synchronously and writes in a background thread, so the train
  loop blocks only for the copy, not the I/O.
* Data-pipeline state and the step counter ride along in ``extra``
  -> exact resume.

A tree is a module (its ``named_parameters``), a mapping, a tuple or
list (a ``NamedTuple`` by its fields) or a tensor, nested; its leaves
are its tensors in that fixed named order.  :func:`restore` copies the
stored leaves into the target tree's tensors in place.  bfloat16 is
stored as its ``uint16`` bits, with ``"bfloat16"`` in the manifest, so
no numpy extension is needed.

Across cards, leaves are stored unsharded, as in the reference: a
DTensor leaf is gathered leaf by leaf (``full_tensor``, every rank
joins), rank 0 writes, and a synchronous save ends on a barrier.
**Elastic restore**: every rank reads each stored leaf and keeps its own
slice, so a target laid out on a mesh of another shape or size (a
restart after a node loss) is filled in place; with ``shardings`` (the
target's structure, placements at the leaves, ``train.step.
train_state_shardings``) and ``mesh``, each leaf is placed anew and the
target's leaves are replaced, so the target may be built on ``meta``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["leaves", "save", "AsyncCheckpointer", "latest_step", "manifest",
           "load_leaf", "restore"]


def _dist():
    """(rank, world) of the default process group, (0, 1) without."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def leaves(tree: Any, prefix: str = "") -> list:
    """(name, tensor) of every leaf of ``tree``, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        items = tree.named_parameters()
    elif isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        raise TypeError(f"not a checkpoint tree: {type(tree).__name__}")
    out = []
    for k, v in items:
        out += leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (bfloat16 as its uint16 bits)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host_leaves(tree) -> list:
    """(name, dtype, host array) of every leaf; a DTensor leaf gathered
    first (every rank joins).  Ranks other than 0 keep no array."""
    rank, _ = _dist()
    out = []
    for name, t in leaves(tree):
        dtype = str(t.dtype).removeprefix("torch.")
        if _is_dtensor(t):
            t = t.full_tensor()
        out.append((name, dtype, _host(t) if rank == 0 else None))
    return out


def _specs_json(spec_tree):
    if spec_tree is None:
        return None
    if isinstance(spec_tree, tuple):
        return list(spec_tree)
    if isinstance(spec_tree, Mapping):
        return {k: _specs_json(v) for k, v in spec_tree.items()}
    return [_specs_json(v) for v in spec_tree]


def save(path: str, step: int, tree: Any, extra: Optional[dict] = None,
         spec_tree: Any = None) -> str:
    """Synchronous atomic save; ``spec_tree`` (logical specs, e.g.
    ``Model.param_specs()``) goes into the manifest.  Returns the
    committed directory."""
    host = _host_leaves(tree)
    final = os.path.join(path, f"step_{step:010d}")
    rank, world = _dist()
    if rank == 0:
        _write(path, step, host, extra, spec_tree)
    if world > 1:
        import torch.distributed as dist
        dist.barrier()
    return final


def _write(path: str, step: int, host_leaves: list,
           extra: Optional[dict], spec_tree: Any = None) -> str:
    final = os.path.join(path, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "leaves": [{"name": name, "file": f"leaf_{i}.npy",
                    "shape": list(x.shape), "dtype": dtype}
                   for i, (name, dtype, x) in enumerate(host_leaves)],
        "extra": extra or {},
        "specs": _specs_json(spec_tree),
    }
    for i, (_, _, x) in enumerate(host_leaves):
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), x)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot synchronously (a sharded leaf gathered, every rank
    joining), write in a background thread (rank 0).  A failed write
    raises from the next :meth:`save` or :meth:`wait`."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, path: str, step: int, tree: Any,
             extra: Optional[dict] = None, spec_tree: Any = None) -> None:
        self.wait()
        host_leaves = _host_leaves(tree)
        if _dist()[0] != 0:
            return

        def write():
            try:
                _write(path, step, host_leaves, extra, spec_tree)
            except Exception as e:      # raised again by the caller's wait
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    best = None
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp"):
            full = os.path.join(path, d)
            if os.path.exists(os.path.join(full, "_COMMITTED")):
                best = max(best or -1, int(d[5:]))
    return best


def load_leaf(path: str, step: int, meta: dict) -> torch.Tensor:
    """One stored leaf as a CPU tensor of its stored dtype."""
    x = np.load(os.path.join(path, f"step_{step:010d}", meta["file"]))
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def manifest(path: str, step: int) -> dict:
    with open(os.path.join(path, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def _placements_by_name(tree, prefix: str = "") -> dict:
    """{leaf name: placements} of a shardings tree, named as
    :func:`leaves` names the target's leaves (a module's params by
    their names: a mapping keyed by those names stands for it)."""
    from torch.distributed.tensor import Placement
    if isinstance(tree, (list, tuple)) and tree and all(
            isinstance(p, Placement) for p in tree):
        return {prefix: list(tree)}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        raise TypeError(f"not a shardings tree: {type(tree).__name__}")
    out = {}
    for k, v in items:
        out.update(_placements_by_name(v, f"{prefix}/{k}" if prefix
                                       else str(k)))
    return out


def _replace_leaves(tree, fn, prefix: str = ""):
    """``tree`` with each leaf tensor replaced by ``fn(name, t)``: a
    module's params are swapped in place, mappings written, tuples and
    NamedTuples rebuilt."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if isinstance(tree, nn.Module):
        from repro_torch.models.common import replace_params
        return replace_params(tree, fn, f"{prefix}/" if prefix else "")
    if isinstance(tree, Mapping):
        for k in list(tree):
            tree[k] = _replace_leaves(tree[k], fn,
                                      f"{prefix}/{k}" if prefix else str(k))
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_replace_leaves(
            v, fn, f"{prefix}/{k}" if prefix else str(k))
            for k, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replace_leaves(
            v, fn, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    raise TypeError(f"not a checkpoint tree: {type(tree).__name__}")


def _device_of(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@torch.no_grad()
def restore(path: str, step: int, target_tree: Any, shardings: Any = None,
            mesh=None) -> tuple[Any, dict]:
    """Copy checkpoint ``step`` into the tensors of ``target_tree`` (in
    place, cast to each target's dtype; a DTensor leaf receives this
    rank's slice) and return (target_tree, extra).  Leaves pair by name
    when the names agree (a module whose params were made in another
    order), else by position.  With ``shardings``
    and ``mesh`` each leaf named there is instead placed anew on
    ``mesh`` with its placements and replaces the target's leaf (whose
    dtype it takes); the rebuilt tree is returned."""
    from repro_torch.models.sharding import local_part, place
    man = manifest(path, step)
    targets = leaves(target_tree)
    if len(targets) != len(man["leaves"]):
        raise ValueError(
            f"checkpoint has {len(man['leaves'])} leaves, "
            f"target expects {len(targets)}")
    by_name = {m["name"]: m for m in man["leaves"]}
    if set(by_name) == {name for name, _ in targets}:
        stored = [by_name[name] for name, _ in targets]   # by name
    else:
        stored = man["leaves"]                            # by position
    metas = {}
    for (name, t), meta in zip(targets, stored):
        if list(t.shape) != meta["shape"]:
            raise ValueError(f"leaf {name}: checkpoint shape "
                             f"{meta['shape']}, target {list(t.shape)}")
        metas[name] = meta
    if shardings is None:
        for name, t in targets:
            full = load_leaf(path, step, metas[name])
            if _is_dtensor(t):
                t.to_local().copy_(local_part(full, t.device_mesh,
                                               t.placements))
            else:
                t.copy_(full)
        return target_tree, man["extra"]
    if mesh is None:
        raise ValueError("restoring onto shardings needs their mesh")
    pls = _placements_by_name(shardings)
    dev = _device_of(mesh)

    def fill(name, t):
        full = load_leaf(path, step, metas[name]).to(dev, t.dtype)
        if t.dim() == 0 and not _is_dtensor(t):
            return full         # a scalar (the step) stays a plain tensor
        if name in pls:
            return place(full, mesh, pls[name])
        if _is_dtensor(t):
            return place(full, t.device_mesh, t.placements)
        return full

    return _replace_leaves(target_tree, fill), man["extra"]