"""The ``SparseOperator`` protocol over the single-device dispatch layer.

Port of ``repro/core/operator.py`` for this slice: callers see
``y = A x`` in the ORIGINAL basis while the storage format, the row
permutation and the padding stay inside.  ``op @ x`` dispatches a 1-D
``x`` to ``matvec`` and a 2-D ``X`` (``shape[1]`` rows, one column per
right-hand side) to ``matmat``.  Transposes, the distributed operator
and gradients are not ported yet: they raise ``NotImplementedError``
naming their ROADMAP item, so nothing degrades silently (in particular a
tensor that requires grad is refused rather than detached).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch._todo import not_ported
from repro_torch.core import formats as F
from repro_torch.kernels import ops
from repro_torch.kernels._backend import host_tensor

__all__ = ["SparseOperator", "DeviceOperator", "operator"]


class SparseOperator:
    """Abstract linear operator y = A x in the original basis."""

    shape: tuple

    @property
    def dtype(self):
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x: x (shape[1],) -> y (shape[0],)."""
        raise NotImplementedError

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A X: X (shape[1], k) -> Y (shape[0], k)."""
        raise NotImplementedError

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        raise not_ported("rmatvec", "transpose")

    def rmatmat(self, y: torch.Tensor) -> torch.Tensor:
        raise not_ported("rmatmat", "transpose")

    def diagonal(self) -> torch.Tensor:
        raise not_ported("diagonal()", "precond")

    @property
    def T(self) -> "SparseOperator":
        raise not_ported("the transpose view .T", "transpose")

    def __matmul__(self, x):
        if not isinstance(x, torch.Tensor):
            x = host_tensor(np.asarray(x), self.device)
        if x.dim() == 1:
            return self.matvec(x)
        if x.dim() == 2:
            return self.matmat(x)
        raise ValueError(f"operator @ x expects 1-D or 2-D x; got "
                         f"{tuple(x.shape)}")


class DeviceOperator(SparseOperator):
    """Single-device :class:`SparseOperator` over a dispatch-layer
    ``SparseDevice`` (format chosen once, conversion cached).
    ``backend="auto"`` resolves per call from the tensor's device: the
    kernels on a CUDA card, the plain versions on the CPU."""

    def __init__(self, dev: ops.SparseDevice, backend: str = "auto"):
        self.dev = dev
        self.backend = backend

    @property
    def shape(self):
        return self.dev.shape

    @property
    def fmt(self) -> str:
        return self.dev.fmt

    @property
    def dtype(self) -> torch.dtype:
        return self.dev.values.dtype

    @property
    def device(self) -> torch.device:
        return self.dev.device

    @property
    def values(self) -> torch.Tensor:
        """The stored value stream."""
        return self.dev.values

    def matvec(self, x, backend: Optional[str] = None):
        _refuse_grad(x)
        return self.dev.matvec(x, backend or self.backend)

    def matmat(self, x, backend: Optional[str] = None):
        _refuse_grad(x)
        return self.dev.matmat(x, backend or self.backend)


def _refuse_grad(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise not_ported("gradients through the operator", "autograd")


def operator(
    a: Union[F.CSRMatrix, np.ndarray, ops.SparseDevice, SparseOperator],
    format: str = "auto",
    *,
    backend: str = "auto",
    transpose: str = "ref",
    device=None,
    **convert_kwargs,
) -> SparseOperator:
    """Wrap ``a`` as a single-device :class:`SparseOperator`.

    ``a`` may be a host CSRMatrix, a dense ndarray, an existing
    ``SparseDevice``, or already an operator (returned unchanged).
    Conversion and caching ride :func:`kernels.ops.as_device`, which
    takes ``format``, ``device`` and the ``convert_kwargs`` (b_r,
    diag_align, sigma, chunk_l, dtype, index_dtype, x_tiles, tune,
    validate, reorder).  ``device`` defaults to the current CUDA card
    and raises when there is none.  ``transpose="device"`` is not ported
    yet; the default ``"ref"`` builds no transposed operand.
    """
    if transpose not in ("ref", "device"):
        raise ValueError(f"transpose must be 'ref' or 'device'; "
                         f"got {transpose!r}")
    if isinstance(a, SparseOperator):
        return a
    if transpose == "device":
        raise not_ported("transpose='device'", "transpose")
    if isinstance(a, ops.SparseDevice):
        return DeviceOperator(ops.as_device(a, format, device=device),
                              backend=backend)
    if isinstance(a, np.ndarray):
        a = ops._dense_to_csr_cached(a)
    if not isinstance(a, F.CSRMatrix):
        raise TypeError(f"cannot build an operator from {type(a)}")
    dev = ops.as_device(a, format, device=device, **convert_kwargs)
    return DeviceOperator(dev, backend=backend)
