"""Fault-tolerant checkpointing with atomic commit and asynchronous save.

Port of ``repro/checkpoint/store.py``, in the reference's layout::

    <dir>/step_<N>/
        manifest.json     the leaves' names, shapes and dtypes, and extra
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
no numpy extension is needed.  The reference's elastic restore onto
another mesh (``shardings``) comes with the model across cards (ROADMAP
1.28).
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
    return [(name, str(t.dtype).removeprefix("torch."), _host(t))
            for name, t in leaves(tree)]


def save(path: str, step: int, tree: Any,
         extra: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the committed directory."""
    return _write(path, step, _host_leaves(tree), extra)


def _write(path: str, step: int, host_leaves: list,
           extra: Optional[dict]) -> str:
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
    """Snapshot synchronously, write in a background thread.  A failed
    write raises from the next :meth:`save` or :meth:`wait`."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, path: str, step: int, tree: Any,
             extra: Optional[dict] = None) -> None:
        self.wait()
        host_leaves = _host_leaves(tree)

        def write():
            try:
                _write(path, step, host_leaves, extra)
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


@torch.no_grad()
def restore(path: str, step: int, target_tree: Any) -> tuple[Any, dict]:
    """Copy checkpoint ``step`` into the tensors of ``target_tree`` (in
    place, cast to each target's dtype) and return (target_tree,
    extra)."""
    man = manifest(path, step)
    targets = leaves(target_tree)
    if len(targets) != len(man["leaves"]):
        raise ValueError(
            f"checkpoint has {len(man['leaves'])} leaves, "
            f"target expects {len(targets)}")
    for (name, t), meta in zip(targets, man["leaves"]):
        if list(t.shape) != meta["shape"]:
            raise ValueError(f"leaf {name}: checkpoint shape "
                             f"{meta['shape']}, target {list(t.shape)}")
        t.copy_(load_leaf(path, step, meta))
    return target_tree, man["extra"]
