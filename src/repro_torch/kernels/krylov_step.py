"""The fused Krylov loop's scalar step and vector updates on the card.

No Pallas kernel stands behind these: the reference runs each fused
solve inside ``jax.lax.while_loop`` (``repro/core/solvers.py``,
``_fused_cg`` and ``_fused_bicgstab``), where XLA fuses the scalar
recurrences and the axpys around each K3 pass into the device loop.
The port gets the same structure from two hand-written CUDA kernels
(``csrc/krylov_step.cu``), so that ``core.solvers`` can capture a chunk
of iterations -- K3, step, update -- as one CUDA graph and read the
device once per chunk:

* :func:`step_kernel_call` -- one thread: the subnormal flush of K3's
  dots, alpha / beta / omega, the clamped look-ahead residual, the
  failure latch and the exit test, ``k`` and ``done``.  Its f32
  operations are round-to-nearest intrinsics in the plain version's
  order, so it gives the plain version's bits.  Bound: one launch's
  latency.
* :func:`update_kernel_call` -- the vector updates of an iteration, the
  scalars read from device memory.  Bound: bytes, every vector read
  once and written once, at 3.35 TB/s.

Both honour the loop's ``done`` latch: once it is set they return
before touching memory.  The scalar state is two small tensors, ``fs``
(float32) and ``is_`` (int32), at the slots :mod:`.ref` names
(:func:`new_state`).  :func:`krylov_step` and :func:`krylov_update`
take the kernels for CUDA tensors and the plain versions
(``ref.krylov_step_ref`` / ``ref.krylov_update_ref``) for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as R
from ._backend import resolve_backend, stream_of

__all__ = ["step_kernel_call", "update_kernel_call", "krylov_step",
           "krylov_update", "new_state"]


def new_state(device) -> tuple:
    """Fresh ``(fs, is_)`` scalar state of one fused loop on ``device``."""
    return (torch.zeros(R.FS_SIZE, dtype=torch.float32, device=device),
            torch.zeros(R.IS_SIZE, dtype=torch.int32, device=device))


def _lib():
    lib = _build.load("krylov_step")
    if not lib.krylov_step.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.krylov_step.argtypes = [i, p, p, p, ctypes.c_float, i, p]
        lib.krylov_step.restype = ctypes.c_int
        lib.krylov_update.argtypes = [i, p, p, p, p, p, p, p, p, i, p]
        lib.krylov_update.restype = ctypes.c_int
    return lib


def _check_state(fs: torch.Tensor, is_: torch.Tensor) -> None:
    if fs.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors; fs is on "
                         f"{fs.device}")
    if (fs.dtype != torch.float32 or fs.shape != (R.FS_SIZE,)
            or is_.dtype != torch.int32 or is_.shape != (R.IS_SIZE,)):
        raise ValueError(f"fs must be float32 ({R.FS_SIZE},) and is_ int32 "
                         f"({R.IS_SIZE},)")
    if is_.device != fs.device or not (fs.is_contiguous()
                                       and is_.is_contiguous()):
        raise ValueError("fs and is_ must be contiguous on one card")


def step_kernel_call(kind: int, fs: torch.Tensor, is_: torch.Tensor,
                     dots: torch.Tensor, *, tol: float = 0.0,
                     maxiter: int = 0) -> None:
    """One scalar step of the fused loop, in place on ``fs`` / ``is_``.

    ``kind``: ``ref.STEP_INIT`` (``dots`` = [<r,r>, <b,b>] of a
    (re)start; sets ``tol`` and ``maxiter``), ``STEP_CG`` (K3's five
    dots of a CG pass), ``STEP_BICG1`` / ``STEP_BICG2`` (after
    BiCGStab's first / second K3 pass).  Raises on operands the kernel
    does not take and on a refused launch."""
    _check_state(fs, is_)
    need = 2 if kind == R.STEP_INIT else 5
    if (dots.dtype != torch.float32 or dots.device != fs.device
            or dots.numel() < need or not dots.is_contiguous()):
        raise ValueError(f"dots must be {need} contiguous float32 on "
                         f"{fs.device}")
    if kind not in (R.STEP_INIT, R.STEP_CG, R.STEP_BICG1, R.STEP_BICG2):
        raise ValueError(f"unknown step kind {kind}")
    rc = _lib().krylov_step(kind, fs.data_ptr(), is_.data_ptr(),
                            dots.data_ptr(), float(tol), int(maxiter),
                            stream_of(fs))
    _build.check("krylov_step", rc, "krylov_step launch")
    _build.count_launch(step_kernel_call)


step_kernel_call.launches = 0

# vectors each update kind writes (u) and reads only (v)
_UPDATE_ARITY = {R.UPDATE_CG: (3, 1), R.UPDATE_BICG_P: (1, 2),
                 R.UPDATE_BICG_S: (1, 2), R.UPDATE_BICG_XR: (2, 3)}


def update_kernel_call(kind: int, flag: torch.Tensor, fs: torch.Tensor,
                       us, vs) -> None:
    """The vector update ``kind`` of one iteration, in place on the
    vectors ``us``, reading ``vs`` and the scalars in ``fs``; nothing
    happens when ``flag`` (a one-element int32 view of the loop's
    ``done`` or ``skip`` slot) is set.  ``ref.krylov_update_ref`` says
    what each kind computes.  Every vector: float32, contiguous, one
    length, a multiple of 4, 16-byte aligned, on the same card."""
    if kind not in _UPDATE_ARITY:
        raise ValueError(f"unknown update kind {kind}")
    nu, nv = _UPDATE_ARITY[kind]
    if len(us) != nu or len(vs) != nv:
        raise ValueError(f"update kind {kind} takes {nu} written and {nv} "
                         f"read vectors")
    if fs.device.type != "cuda" or fs.dtype != torch.float32:
        raise ValueError("fs must be float32 on a CUDA card")
    if (flag.dtype != torch.int32 or flag.numel() != 1
            or flag.device != fs.device):
        raise ValueError("flag must be one int32 on the card of fs")
    n = us[0].shape[0]
    for t in (*us, *vs):
        if (t.dtype != torch.float32 or t.dim() != 1 or t.shape[0] != n
                or t.device != fs.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("update vectors must be contiguous 16-byte "
                             "aligned float32 of one length on the card "
                             "of fs")
    if n % 4:
        raise ValueError(f"update vectors need a length that is a multiple "
                         f"of 4; got {n}")
    ptrs = [t.data_ptr() for t in us] + [None] * (3 - nu)
    ptrs += [t.data_ptr() for t in vs] + [None] * (3 - nv)
    rc = _lib().krylov_update(kind, flag.data_ptr(), fs.data_ptr(), *ptrs,
                              n, stream_of(fs))
    _build.check("krylov_step", rc, "krylov_update launch")
    _build.count_launch(update_kernel_call)


update_kernel_call.launches = 0


def krylov_step(kind, fs, is_, dots, *, tol=0.0, maxiter=0) -> None:
    """The scalar step: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if resolve_backend(fs) == "kernel":
        step_kernel_call(kind, fs, is_, dots, tol=tol, maxiter=maxiter)
    else:
        R.krylov_step_ref(kind, fs, is_, dots, tol=tol, maxiter=maxiter)


def krylov_update(kind, flag, fs, us, vs) -> None:
    """The vector update: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if resolve_backend(fs) == "kernel":
        update_kernel_call(kind, flag, fs, us, vs)
    else:
        R.krylov_update_ref(kind, flag, fs, us, vs)
