"""The ``SparseOperator`` protocol over the single-device dispatch layer.

Port of ``repro/core/operator.py`` for this slice: callers see
``y = A x`` in the ORIGINAL basis while the storage format, the row
permutation and the padding stay inside.  ``op @ x`` dispatches a 1-D
``x`` to ``matvec`` and a 2-D ``X`` (``shape[1]`` rows, one column per
right-hand side) to ``matmat``; ``diagonal()`` reads diag(A) straight
from the device layout (the Jacobi preconditioner).  Transposes, the distributed operator
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
        """diag(A) for square operators (the Jacobi preconditioner)."""
        raise NotImplementedError

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
        self._diag = None

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

    def diagonal(self) -> torch.Tensor:
        """diag(A), (shape[0],) in the stored value dtype, computed once
        from the device layout and cached."""
        if self.shape[0] != self.shape[1]:
            raise ValueError("diagonal requires a square operator")
        if self._diag is None:
            self._diag = _device_diagonal(self.dev)
        return self._diag


def _row_sums(rows: torch.Tensor, vals: torch.Tensor,
              n_out: int) -> torch.Tensor:
    """``out[i] = sum of vals where rows == i`` in storage order, without
    float atomics: the entries are grouped by row (a stable sort) and
    added rank by rank, each rank scattering into distinct rows.  So the
    sum repeats bit for bit on the card, where ``index_add_`` orders its
    atomics at random, and equals the reference's ``segment_sum`` of a
    masked stream (zeros added to a sum change nothing)."""
    out = torch.zeros(n_out, dtype=vals.dtype, device=vals.device)
    if rows.numel() == 0:
        return out
    rows, order = torch.sort(rows, stable=True)
    vals = vals[order]
    idx = torch.arange(rows.numel(), device=rows.device)
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    start = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)),
                         dim=0).values
    rank = idx - start
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        r = rows[sel]
        out[r] = out[r] + vals[sel]
    return out


def _device_diagonal(sd: ops.SparseDevice) -> torch.Tensor:
    """diag(A) straight from the device layout (the reference's
    ``_device_diagonal_stored``): keep each stored entry whose column is
    its original row, and sum per row with :func:`_row_sums`."""
    n = sd.shape[0]
    d = sd.dev
    if sd.fmt == "csr":
        mask = d.indices == d.row_ids
        return _row_sums(d.row_ids[mask].long(), d.data[mask], n)
    if sd.fmt == "ellpack_r":
        rows = torch.arange(d.val.shape[1], device=d.val.device)
        j = torch.arange(d.val.shape[0], device=d.val.device)[:, None]
        mask = (d.col_idx.long() == rows[None, :]) & (j < d.rowlen[None, :])
        rows = rows.expand_as(mask)
        return _row_sums(rows[mask], d.val[mask], d.val.shape[1])[:n]
    if sd.fmt in ("sell", "pjds"):
        # the original row of each stored (block, lane) slot
        orig = sd.row_map().long()
        b_r = d.val.shape[1]
        pos = (d.row_block.long()[:, None] * b_r
               + torch.arange(b_r, device=d.val.device)[None, :])
        rows = orig[pos]
        mask = (d.col_idx.long() == rows) & (rows >= 0)
        return _row_sums(rows[mask], d.val[mask], n)
    if sd.fmt == "cmrs":
        b_r = d.val.shape[1]
        rows = d.strip_map.long()[:, None] * b_r + d.row_in_strip.long()
        mask = d.col_idx.long() == rows
        return _row_sums(rows[mask], d.val[mask], d.n_rows_pad)[:n]
    raise ValueError(f"unknown format {sd.fmt!r}")


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
