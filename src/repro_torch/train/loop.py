"""The train loop: the step, checkpoint and resume, a straggler watchdog.

Port of ``repro/train/loop.py``.  Fault-tolerance contract:

* auto-resume from the latest committed checkpoint (params, optimizer,
  data-pipeline state, step counter);
* periodic asynchronous checkpoints off the critical path, and a final
  save (skipped when the last periodic one was of the final step);
* straggler watchdog: records step times and flags steps slower than
  ``straggler_factor`` x the running median.

Each step reads the loss back to the host once, where the reference
blocks on it.  The history adds to the reference's ``losses`` and
``stragglers`` each step's seconds (``times``) and its ``grad_norms``
and ``lrs``, kept on the device and read once at the end.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.data.pipeline import SyntheticLM

__all__ = ["Watchdog", "train"]


@dataclasses.dataclass
class Watchdog:
    straggler_factor: float = 3.0
    times: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        med = float(np.median(self.times[-50:]))
        slow = len(self.times) > 5 and dt > self.straggler_factor * med
        if slow:
            self.stragglers.append((step, dt, med))
        return slow


def train(
    *,
    step_fn: Callable,          # (params, opt_state, batch) -> (p, s, metrics)
    params,
    opt_state,
    data: SyntheticLM,
    steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 100,
    resume: bool = True,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
):
    """Run ``step_fn`` from the latest committed step (or 0) to ``steps``
    on batches of ``data``, moved to the params' device before each
    step's clock starts.  Returns (params, opt_state, history)."""
    start = 0
    ckpt = store.AsyncCheckpointer()
    if ckpt_dir and resume:
        latest = store.latest_step(ckpt_dir)
        if latest is not None:
            (params, opt_state), extra = store.restore(
                ckpt_dir, latest, (params, opt_state))
            data.load_state_dict(extra["data"])
            start = latest
            log_fn(f"[resume] restored step {latest}")
    dev = next(params.parameters()).device
    wd = Watchdog()
    losses, kept = [], []
    saved = None
    for step in range(start, steps):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in data.next().items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        dt = time.perf_counter() - t0
        if wd.record(step, dt):
            log_fn(f"[watchdog] straggler step {step}: {dt:.2f}s")
        kept.append(torch.stack([metrics["grad_norm"], metrics["lr"]]))
        if step % log_every == 0:
            log_fn(f"step {step:5d} loss {losses[-1]:.4f} "
                   f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, (params, opt_state),
                      extra={"data": data.state_dict()})
            saved = step + 1
    ckpt.wait()
    if ckpt_dir and saved != steps:
        store.save(ckpt_dir, steps, (params, opt_state),
                   extra={"data": data.state_dict()})
    gl = torch.stack(kept).cpu().tolist() if kept else []
    return params, opt_state, {"losses": losses,
                               "stragglers": wd.stragglers,
                               "times": wd.times,
                               "grad_norms": [g for g, _ in gl],
                               "lrs": [lr for _, lr in gl]}
