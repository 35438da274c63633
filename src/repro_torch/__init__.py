"""repro_torch: the pJDS / SELL-C-sigma spMVM and Krylov solve of
``repro``, ported to PyTorch with hand-written CUDA kernels for Hopper.

Lazy top-level API (PEP 562) -- importing ``repro_torch`` loads nothing
heavy and builds no kernel::

    import repro_torch
    op = repro_torch.operator(m, format="sell")        # on CUDA
    op = repro_torch.operator(m, tune="auto")          # measured statics
    y = op @ x
    res = repro_torch.solve(m, b)                      # tuned CG
    res = repro_torch.solve(m, b, dtype=torch.bfloat16)   # bf16, refined
    op = repro_torch.dist_operator(m, repro_torch.GroupComm())  # one rank
    op = repro_torch.dist_operator(m, comm, tune="auto", grid="auto",
                                   halo="auto", mode="auto")  # measured
    res = repro_torch.solve(op, op.shard_vector(b))    # distributed CG
    z = op.T @ y                                       # A^T y (K7)
    m = repro_torch.load_mm("matrix.mtx")              # Matrix Market
    op = repro_torch.operator(m, reorder="rcm")        # RCM preprocessing

Solve serving lives in ``repro_torch.serve`` (``OperatorRegistry``,
``SolveScheduler``), the fault harness in ``repro_torch.testing``.

Entry points run on CUDA unless given ``device="cpu"``; with no CUDA
and no device they raise.  Tuned decisions are measured on that device
and kept in a JSON cache (``$REPRO_TORCH_TUNE_CACHE``, else
``~/.cache/repro-torch-spmv/tune_cache.json``; ``repro_torch.tune``).
The package imports neither JAX nor the ``repro`` package: ``core/``
holds its own copies of the host code.
"""
from __future__ import annotations

__all__ = ["solve", "SolveResult", "SolveFailure", "operator",
           "dist_operator", "DistOperator", "GroupComm", "ThreadComm",
           "load_mm", "save_mm", "preprocess"]

_LAZY = {
    "solve": "repro_torch.api",
    "SolveResult": "repro_torch.core.solvers",
    "SolveFailure": "repro_torch.api",
    "operator": "repro_torch.core.operator",
    "dist_operator": "repro_torch.core.operator",
    "DistOperator": "repro_torch.core.operator",
    "GroupComm": "repro_torch.core.dist_comm",
    "ThreadComm": "repro_torch.core.dist_comm",
    "load_mm": "repro_torch.core.io_mm",
    "save_mm": "repro_torch.core.io_mm",
    "preprocess": "repro_torch.core.reorder",
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(target), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
