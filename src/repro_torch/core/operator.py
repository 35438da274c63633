"""The ``SparseOperator`` protocol over the single-device dispatch layer
and the distributed layer.

Port of ``repro/core/operator.py``: callers see ``y = A x`` in the
ORIGINAL basis while the storage format, the row permutations, the
padding and any preprocessing permutation stay inside.  Every operator
offers

* ``shape`` / ``dtype`` / ``device`` and ``op @ x``, which dispatches a
  1-D ``x`` to ``matvec`` and a 2-D ``X`` (``shape[1]`` rows, one
  column per right-hand side) to ``matmat``;
* the transposes ``rmatvec`` / ``rmatmat`` and the view ``op.T`` (a
  :class:`TransposeOperator`, memoized, with ``op.T.T is op``): on a
  single device K7 (``kernels/transpose_spmv.py``) over the stored
  layout, or the forward kernels on a second operand built from A^T
  (``operator(a, transpose="device")``);
* gradients: ``torch.autograd.grad`` through ``op @ x`` with respect to
  ``x`` (A^T g, through the transposes above) and to the stored values
  (``op.with_values(v) @ x``: ``g[row] * x[col]`` for every stored
  slot, padding included, as the reference's rule gives it), and
  forward mode through ``torch.func.jvp`` (``A(v') x + A x'``, both
  through the forward kernel);
* ``diagonal()``, read straight from the device layout (the Jacobi
  preconditioner).

:class:`DistOperator` / :func:`dist_operator` run the distributed layer
(``core.dist_spmv``, paper §3) on one rank: its vectors are the rank's
slice of the padded global vector, and ``rmatvec`` / ``.T`` and its
x-gradients run the forward body on the partition of A^T.
"""
from __future__ import annotations

import copy
import weakref
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import dist_spmv as D
from repro_torch.core import formats as F
from repro_torch.core import perf_model as PM
from repro_torch.kernels import ops
from repro_torch.kernels._backend import (acc_dtype, host_tensor,
                                          resolve_device)

__all__ = ["SparseOperator", "DeviceOperator", "TransposeOperator",
           "DistOperator", "operator", "dist_operator"]


class SparseOperator:
    """Abstract linear operator y = A x in the original basis.

    Implementations provide ``shape``, ``dtype``, ``device``,
    ``matvec``, ``matmat``, ``rmatvec``, ``rmatmat`` and (square
    operators) ``diagonal``; the base class supplies ``@`` and the
    transpose view."""

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
        """x = A^T y: y (shape[0],) -> x (shape[1],)."""
        raise NotImplementedError

    def rmatmat(self, y: torch.Tensor) -> torch.Tensor:
        """X = A^T Y: Y (shape[0], k) -> X (shape[1], k)."""
        raise NotImplementedError

    def diagonal(self) -> torch.Tensor:
        """diag(A) for square operators (the Jacobi preconditioner)."""
        raise NotImplementedError

    @property
    def T(self) -> "SparseOperator":
        """The transpose view, memoized so ``op.T is op.T`` and
        ``op.T.T is op``."""
        t = getattr(self, "_T", None)
        if t is None:
            t = TransposeOperator(self)
            self._T = t
        return t

    def __matmul__(self, x):
        if not isinstance(x, torch.Tensor):
            x = host_tensor(np.asarray(x), self.device)
        if x.dim() == 1:
            return self.matvec(x)
        if x.dim() == 2:
            return self.matmat(x)
        raise ValueError(f"operator @ x expects 1-D or 2-D x; got "
                         f"{tuple(x.shape)}")


class TransposeOperator(SparseOperator):
    """``A^T`` as an operator: forwards to the base operator's
    transposes, and back."""

    def __init__(self, base: SparseOperator):
        self.base = base

    @property
    def shape(self):
        s = self.base.shape
        return (s[1], s[0])

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self) -> torch.device:
        return self.base.device

    def matvec(self, x):
        return self.base.rmatvec(x)

    def matmat(self, x):
        return self.base.rmatmat(x)

    def rmatvec(self, y):
        return self.base.matvec(y)

    def rmatmat(self, y):
        return self.base.matmat(y)

    def diagonal(self):
        return self.base.diagonal()      # diag(A^T) == diag(A)

    @property
    def T(self):
        return self.base


# --------------------------------------------------------------------------
# Differentiable application
# --------------------------------------------------------------------------
def _tracked(*ts) -> bool:
    """Whether a product must record its derivative: an input that
    requires grad, or one that carries a forward-mode tangent
    (``torch.func`` wraps such tensors; ``torch.autograd.forward_ad``
    pairs them with a dual)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return True
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t)
               or torch.autograd.forward_ad.unpack_dual(t).tangent
               is not None for t in ts)


def _slot_rows(sd: ops.SparseDevice) -> tuple:
    """The row of every stored slot (the value array's shape, int64) in
    the stored basis, ``shape[0]`` for a slot in a padded row, and the
    mask of the slots the product reads (ELLPACK-R: below ``rowlen``;
    None where it reads them all)."""
    n = sd.shape[0]
    d = sd.dev
    if sd.fmt == "csr":
        return d.row_ids.long(), None
    dev = d.val.device
    if sd.fmt == "ellpack_r":
        max_nzr, n_pad = d.val.shape
        rows = torch.arange(n_pad, device=dev).expand(max_nzr, n_pad)
        j = torch.arange(max_nzr, device=dev)[:, None]
        return rows.clamp(max=n), j < d.rowlen[None, :]
    b_r = d.val.shape[1]
    if sd.fmt == "cmrs":
        rows = d.strip_map.long()[:, None] * b_r + d.row_in_strip.long()
        return rows.clamp(max=n), None
    pos = (d.row_block.long()[:, None] * b_r
           + torch.arange(b_r, device=dev)[None, :])
    rows = sd.row_map().long()[pos]
    return torch.where(rows >= 0, rows, n), None


def _value_grad(sd: ops.SparseDevice, at_rows: torch.Tensor,
                at_cols: torch.Tensor) -> torch.Tensor:
    """The gradient with respect to the stored values of ``<g, A x>``:
    ``at_rows[row(slot)] * at_cols[col(slot)]`` for every stored slot
    (for A^T y the roles swap), summed over the columns of a block.  A
    padded slot of a real row has column 0 and so gets
    ``at_rows[row] * at_cols[0]``, as the reference's rule gives it; a
    slot of a padded row, and an ELLPACK-R slot past ``rowlen``, gets 0.
    A gather and a product, outside any kernel, as in the reference."""
    vals = sd.values
    n, n_cols = sd.shape
    dt = acc_dtype(vals.dtype, at_rows.dtype, at_cols.dtype)
    gr = sd._into_stored(at_rows[:n]).to(dt)
    gc = sd._into_stored(at_cols[:n_cols]).to(dt)
    rows, mask = _slot_rows(sd)
    cols = (sd.dev.indices if sd.fmt == "csr" else sd.dev.col_idx).long()
    g_ext = torch.cat([gr, gr.new_zeros((1,) + tuple(gr.shape[1:]))])
    prod = g_ext[rows] * gc[cols]
    if prod.dim() > vals.dim():
        prod = prod.sum(dim=-1)
    if mask is not None:
        prod = prod.masked_fill(~mask, 0)
    return prod.to(vals.dtype)


class _Apply(torch.autograd.Function):
    """y = A v (``transpose`` False) or A^T v through a
    :class:`DeviceOperator`'s kernels, with the reference's derivative
    rules: the x-gradient is the other product (A^T g through K7 or the
    transposed operand, A g through the forward kernel), the value
    gradient :func:`_value_grad`, and the tangent ``A(v') x + A x'``.
    ``values`` is the operator's stored value tensor itself."""

    @staticmethod
    def forward(values, v, op, transpose, backend):
        return op._stored_as(values)._raw(v, transpose, backend)

    @staticmethod
    def setup_context(ctx, inputs, output):
        values, v, op, transpose, backend = inputs
        ctx.op = op._stored_as(values)
        ctx.transpose, ctx.backend = transpose, backend
        ctx.save_for_backward(v)
        ctx.save_for_forward(v)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        op, tr, be = ctx.op, ctx.transpose, ctx.backend
        g_values = g_v = None
        if ctx.needs_input_grad[1]:
            g_v = op.matvec(g, be) if tr else op.rmatvec(g, be)
        if ctx.needs_input_grad[0]:
            g_values = (_value_grad(op.dev, v, g) if tr
                        else _value_grad(op.dev, g, v))
        return g_values, g_v, None, None, None

    @staticmethod
    def jvp(ctx, d_values, d_v, _op, _transpose, _backend):
        # Under torch.func the tangents and saved tensors arrive wrapped,
        # so both products go through this Function again: its forward
        # gets them unwrapped.
        (v,) = ctx.saved_tensors
        op, tr, be = ctx.op, ctx.transpose, ctx.backend
        out = None
        if d_values is not None:
            out = op.with_values(d_values)._apply(v, tr, be)
        if d_v is not None:
            t = op._apply(d_v, tr, be)
            out = t if out is None else out + t
        return out


class DeviceOperator(SparseOperator):
    """Single-device :class:`SparseOperator` over a dispatch-layer
    ``SparseDevice`` (format chosen once, conversion cached).
    ``t_dev``, when present, is the operand of A^T
    (``operator(a, transpose="device")``): ``rmatvec`` then runs the
    forward kernels on it instead of K7.  ``backend="auto"`` resolves
    per call from the tensor's device: the kernels on a CUDA card, the
    plain versions on the CPU."""

    def __init__(self, dev: ops.SparseDevice,
                 t_dev: Optional[ops.SparseDevice] = None,
                 backend: str = "auto"):
        self.dev = dev
        self.t_dev = t_dev
        self.backend = backend
        self._diag = None
        self._t_op = None

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
        """The stored value tensor (the differentiable parameters)."""
        return self.dev.values

    def with_values(self, values: torch.Tensor) -> "DeviceOperator":
        """The same structure with new stored values -- the handle for
        gradients with respect to them::

            v = op.values.clone().requires_grad_()
            (g,) = torch.autograd.grad(loss(op.with_values(v) @ x), v)

        ``t_dev`` is dropped (its values are in transposed order)."""
        return DeviceOperator(self.dev.with_values(values),
                              backend=self.backend)

    def _stored_as(self, values: torch.Tensor) -> "DeviceOperator":
        """This operator over ``values``, the tensor an autograd Function
        hands its forward.  It is the stored value tensor itself, except
        under ``torch.func``, where the stored one (and what was derived
        from it: the walk lengths) is a wrapper whose data no kernel can
        read and ``values`` the unwrapped tensor: the operand is then
        rebuilt over it."""
        if values is self.values:
            return self
        return DeviceOperator(self.dev.with_values(values), t_dev=self.t_dev,
                              backend=self.backend)

    def _raw(self, v, transpose: bool, backend=None):
        be = backend or self.backend
        if not transpose:
            return self.dev.matvec(v, be)
        return self.dev.rmatmat(v, be)

    def _apply(self, v, transpose: bool, backend=None):
        if _tracked(v, self.values):
            return _Apply.apply(self.values, v, self, transpose, backend)
        return self._raw(v, transpose, backend)

    def matvec(self, x, backend: Optional[str] = None):
        return self._apply(x, False, backend)

    def matmat(self, x, backend: Optional[str] = None):
        return self._apply(x, False, backend)

    def _transposed(self) -> "DeviceOperator":
        if self._t_op is None:
            self._t_op = DeviceOperator(self.t_dev, backend=self.backend)
        return self._t_op

    def rmatvec(self, y, backend: Optional[str] = None):
        if self.t_dev is not None:
            return self._transposed()._apply(y, False, backend)
        return self._apply(y, True, backend)

    def rmatmat(self, y, backend: Optional[str] = None):
        return self.rmatvec(y, backend)

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
    """diag(A) straight from the device layout.  A preprocessing
    permutation stores B = P A P^T, whose diagonal is diag(A) permuted:
    ``diag(A) = diag(B)[pre_inv]``."""
    return sd._out_of_stored(_stored_diagonal(sd))


def _stored_diagonal(sd: ops.SparseDevice) -> torch.Tensor:
    """diag of the stored matrix (the reference's
    ``_device_diagonal_stored``): keep each stored entry whose column is
    its stored row, and sum per row with :func:`_row_sums`."""
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
    validate, reorder); in particular ``reorder="auto"|"rcm"`` runs the
    priced RCM preprocessing stage and records the permutation on the
    operand, so every product stays in the original basis.  ``device``
    defaults to the current CUDA card and raises when there is none.

    ``transpose="device"`` also converts A^T (``formats.csr_transpose``)
    with the same keywords -- with ``tune`` or ``reorder`` that operand
    is priced, reordered and tuned on its own -- so ``op.T @ y`` runs
    the forward kernels on it; the default ``"ref"`` serves transposes
    from the stored operand itself (K7 on the card), with no second
    copy of the matrix.
    """
    if transpose not in ("ref", "device"):
        raise ValueError(f"transpose must be 'ref' or 'device'; "
                         f"got {transpose!r}")
    if isinstance(a, SparseOperator):
        return a
    if isinstance(a, ops.SparseDevice):
        if transpose == "device":
            raise ValueError(
                "transpose='device' needs the host matrix to build the "
                "transposed operand; pass the CSRMatrix (or ndarray) "
                "instead of a SparseDevice")
        return DeviceOperator(ops.as_device(a, format, device=device),
                              backend=backend)
    if isinstance(a, np.ndarray):
        a = ops._dense_to_csr_cached(a)
    if not isinstance(a, F.CSRMatrix):
        raise TypeError(f"cannot build an operator from {type(a)}")
    dev = ops.as_device(a, format, device=device, **convert_kwargs)
    t_dev = None
    if transpose == "device":
        t_dev = ops.as_device(F.csr_transpose(a), format, device=device,
                              **convert_kwargs)
    return DeviceOperator(dev, t_dev=t_dev, backend=backend)


class _DistApply(torch.autograd.Function):
    """A :class:`DistOperator`'s product (``transpose`` False: A v, True:
    A^T v) with its x-gradient through the other partition -- the
    reference's ``_linear_with_transpose``.  Every rank takes the
    gradient together, as it applies the operator together."""

    @staticmethod
    def forward(v, op, transpose):
        return op._raw(v, transpose)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _v, op, transpose = inputs
        ctx.op, ctx.transpose = op, transpose

    @staticmethod
    def backward(ctx, g):
        return ctx.op._apply(g.contiguous(), not ctx.transpose), None, None


class DistOperator(SparseOperator):
    """One rank's view of a :class:`core.dist_spmv.DistPJDS` partition.

    Vectors are the rank's ``(n_loc,)`` or ``(n_loc, k)`` slice of the
    padded global vector (:meth:`shard_vector` cuts one, and
    :meth:`gather_vector` puts the slices back together); ``shape`` is
    the padded global shape and ``n_rows`` the unpadded count.  ``comm``
    is the rank's communicator (``core.dist_comm``); every rank of the
    partition applies the operator together.  ``t_dist``, when present,
    is the partition of A^T and serves ``rmatvec`` / ``rmatmat`` /
    ``.T`` and the x-gradients; ``diag`` is the padded global diagonal,
    of which ``diagonal()`` returns the rank's slice.  ``all_reduce_sum``
    sums a small tensor over the ranks: the solvers reduce their dots
    through it, so every rank sees the same scalars.

    ``pre_perm`` / ``pre_inv`` (padded global length, identity on the
    pad tail) are a preprocessing permutation (``reorder=``): the
    partition holds B = P A P^T, and the slices are in B's basis.
    :meth:`shard_vector` permutes a global vector into it and
    :meth:`gather_vector` back out, so every product, transpose,
    gradient and solve between the two runs in the stored basis with no
    exchange of its own; ``diag`` is given in that basis too."""

    def __init__(self, dist: D.DistPJDS, comm, *,
                 t_dist: Optional[D.DistPJDS] = None,
                 diag: Optional[np.ndarray] = None, mode: str = "overlap",
                 backend: str = "auto", halo: str = "gathered",
                 pre_perm: Optional[np.ndarray] = None,
                 pre_inv: Optional[np.ndarray] = None,
                 device=None):
        if comm.size != dist.n_dev:
            raise ValueError(f"the partition has {dist.n_dev} ranks; the "
                             f"communicator {comm.size}")
        if mode not in D.MODES:
            raise ValueError(f"mode must be one of {D.MODES}; got {mode!r}")
        if halo not in D.HALOS:
            raise ValueError(f"halo must be one of {D.HALOS}; got {halo!r}")
        dev = resolve_device(device)
        self.dist, self.t_dist, self.comm = dist, t_dist, comm
        self.mode, self.backend, self.halo = mode, backend, halo
        self.pre_perm, self.pre_inv = pre_perm, pre_inv
        self._pre_inv_t = (None if pre_inv is None
                           else host_tensor(pre_inv, dev))
        self.shard = dist.shard(comm.rank, dev)
        self.t_shard = (None if t_dist is None
                        else t_dist.shard(comm.rank, dev))
        self._diag = None
        if diag is not None:
            lo = comm.rank * dist.n_loc
            self._diag = host_tensor(diag[lo:lo + dist.n_loc], dev)

    @property
    def shape(self):
        n = self.dist.n_global_pad
        return (n, n)

    @property
    def n_rows(self) -> int:
        """Unpadded global row count (rows past it are zero)."""
        return self.dist.n_rows

    @property
    def n_loc(self) -> int:
        """Rows of x and y this rank owns."""
        return self.dist.n_loc

    @property
    def dtype(self) -> torch.dtype:
        return self.shard.loc.val.dtype

    @property
    def device(self) -> torch.device:
        return self.shard.device

    def _raw(self, v, transpose: bool):
        shard = self._t_shard() if transpose else self.shard
        fn = D.dist_matmat if v.dim() == 2 else D.dist_matvec
        return fn(shard, v, self.comm, mode=self.mode, halo=self.halo,
                  backend=self.backend)

    def _apply(self, v, transpose: bool):
        if _tracked(v):
            if self.t_shard is None:
                raise ValueError(
                    "a gradient through this DistOperator needs the "
                    "transpose partition; use dist_operator(m, comm, "
                    "transpose='device')")
            return _DistApply.apply(v, self, transpose)
        return self._raw(v, transpose)

    def matvec(self, x):
        """y = A x on this rank's slice; a 2-D x goes through K5."""
        return self._apply(x, False)

    def matmat(self, x):
        return self._apply(x, False)

    def _t_shard(self):
        if self.t_shard is None:
            raise ValueError(
                "this DistOperator was built without a transpose partition; "
                "use dist_operator(m, comm, transpose='device')")
        return self.t_shard

    def rmatvec(self, y):
        self._t_shard()
        return self._apply(y, True)

    def rmatmat(self, y):
        return self.rmatvec(y)

    @property
    def T(self) -> "DistOperator":
        """A^T as an operator: the two partitions swapped (shared, not
        rebuilt); the sandwich is the same (B = P A P^T)."""
        self._t_shard()
        t = copy.copy(self)
        t.dist, t.t_dist = self.t_dist, self.dist
        t.shard, t.t_shard = self.t_shard, self.shard
        return t

    def diagonal(self) -> torch.Tensor:
        """The rank's slice of diag(A) (in the stored basis)."""
        if self._diag is None:
            raise ValueError("this DistOperator carries no diagonal; "
                             "build it with dist_operator(m, comm)")
        return self._diag

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce_sum(t)

    def shard_vector(self, v) -> torch.Tensor:
        """This rank's slice of a global vector (``(n_rows,)`` or padded
        ``(n_global_pad,)``, optionally with a trailing k), zero-padded,
        in the stored basis, on the operator's device."""
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        n, n_pad = self.n_rows, self.shape[0]
        if v.shape[0] not in (n, n_pad):
            raise ValueError(f"a global vector has {n} or {n_pad} rows; "
                             f"got {v.shape[0]}")
        if self.pre_perm is not None:
            full = np.zeros((n_pad,) + v.shape[1:], v.dtype)
            full[: v.shape[0]] = v
            v = full[self.pre_perm]
        lo = self.comm.rank * self.n_loc
        out = np.zeros((self.n_loc,) + v.shape[1:], v.dtype)
        part = v[lo:min(lo + self.n_loc, v.shape[0])]
        out[:part.shape[0]] = part
        return host_tensor(out, self.device)

    def gather_vector(self, v_local: torch.Tensor) -> torch.Tensor:
        """The padded global vector, in the ORIGINAL basis, from every
        rank's slice, on every rank (one ``all_reduce_sum`` of a vector
        of global length)."""
        if v_local.shape[0] != self.n_loc:
            raise ValueError(f"expected this rank's {self.n_loc} rows; got "
                             f"{v_local.shape[0]}")
        full = v_local.new_zeros((self.shape[0],) + v_local.shape[1:])
        lo = self.comm.rank * self.n_loc
        full[lo:lo + self.n_loc] = v_local
        full = self.comm.all_reduce_sum(full)
        if self._pre_inv_t is not None:
            full = full.index_select(0, self._pre_inv_t)
        return full


def _shared_plan(comm, m, key: tuple, build):
    """``build()``, once for all ranks that run as threads of this
    process (``ThreadComm``): they share the host plan built from the
    same matrix, keyed by ``m``'s identity and the build keywords.
    Processes (``GroupComm``) each build their own."""
    world = getattr(comm, "world", None)
    if world is None:
        return build()
    with world.plan_lock:
        hit = world.plans.get((id(m), key))
        if hit is None or hit[0]() is not m:
            hit = (weakref.ref(m), build())
            world.plans[(id(m), key)] = hit
    return hit[1]


def dist_operator(
    m: Union[F.CSRMatrix, D.DistPJDS],
    comm=None,
    *,
    mode: str = "overlap",
    backend: str = "auto",
    halo: str = "gathered",
    transpose: Optional[str] = "device",
    b_r: int = 128,
    diag_align: int = 8,
    chunk_l: int = 8,
    halo_w: Optional[int] = None,
    sigma: Optional[int] = None,
    index_dtype="auto",
    tune: str = "off",
    grid=None,
    build_stages: bool = True,
    reorder: str = "off",
    device=None,
) -> DistOperator:
    """Partition ``m`` over ``comm``'s ranks and return this rank's
    :class:`DistOperator` (every rank calls it with the same ``m``;
    ranks run as threads of one process share one host plan).

    ``comm`` defaults to :class:`core.dist_comm.GroupComm` on the
    default process group; a :class:`core.dist_comm.ThreadComm` rank
    works the same.  ``device`` defaults to the current CUDA card.  With
    a host CSR the partition of A^T (``transpose="device"``, the
    default; ``None`` skips it) and the diagonal are built alongside;
    an existing ``DistPJDS`` is wrapped as it is (no transpose, no
    diagonal), so threaded ranks can share one partition.

    ``grid=(gr, gc)`` partitions over a 2-D grid, and the transpose
    partition uses ``(gc, gr)``; ``grid="auto"`` takes the shape the
    tuner measured fastest when ``tune`` is on, otherwise the shape of
    ``dist_spmv.grid_shapes`` that ``perf_model.
    predicted_dist_spmv_seconds`` prices cheapest.  ``halo="auto"``
    takes the tuner's measured flavour, otherwise decides gathered or
    full by ``perf_model.choose_halo`` (fit its per-message costs with
    ``tune.fit_link_calibration`` first); ``mode="auto"`` takes the
    tuner's measured mode, otherwise ``"overlap"``.

    ``tune="auto"|"force"`` measures the best tile height of the LOCAL
    and REMOTE operands independently (``tune.tune_partition``, cached
    persistently like the single-device tuner; ``"force"`` re-measures)
    and partitions with the winners; when any of ``grid`` / ``halo`` /
    ``mode`` is ``"auto"`` the tuner also sweeps the communication
    configuration over ``comm`` (one timed distributed product per
    candidate) and the measured winners fill the auto slots.  The
    transpose partition is tuned separately, with the tile-height sweep
    only.  Tuning is collective: rank 0 decides and every rank builds
    the same partition.

    ``reorder="auto"|"rcm"`` runs the priced RCM preprocessing stage
    (``core.reorder.preprocess``, H100 spec) on the host CSR before
    tuning and partitioning, with the halo term at this communicator's
    rank count: ``"auto"`` applies the permutation only when the model
    predicts a gain (the smaller halo; no per-product sandwich is
    charged, since none runs), ``"rcm"`` forces it.
    The partition is then built from the permuted matrix and the
    operator keeps the permutation: :meth:`DistOperator.shard_vector`
    and :meth:`DistOperator.gather_vector` apply it, so a global vector
    goes in and comes out in the original basis while every product and
    solve in between runs in the stored one (the reference permutes
    around every product instead).
    """
    if tune not in ("off", "auto", "force"):
        raise ValueError(f"tune must be 'off', 'auto' or 'force'; "
                         f"got {tune!r}")
    if reorder not in ("off", "auto", "rcm"):
        raise ValueError(f"reorder must be 'off', 'auto' or 'rcm'; "
                         f"got {reorder!r}")
    if comm is None:
        from repro_torch.core.dist_comm import GroupComm
        comm = GroupComm()
    if isinstance(m, D.DistPJDS):
        if grid not in (None, "auto"):
            raise ValueError("grid cannot be changed on an existing "
                             "DistPJDS; partition the host CSR instead")
        if mode == "auto":
            mode = "overlap"
        if halo == "auto":
            halo = PM.choose_halo(m, mode=mode,
                                  value_bytes=m.loc_val.dtype.itemsize)
        return DistOperator(m, comm, halo=halo, mode=mode, backend=backend,
                            device=device)
    if not isinstance(m, F.CSRMatrix):
        raise TypeError(f"cannot partition {type(m)}")
    if transpose not in ("device", None):
        raise ValueError(f"transpose must be 'device' or None; "
                         f"got {transpose!r}")
    n_dev = comm.size

    pp = None
    if reorder != "off":
        from repro_torch.core import reorder as RO
        # priced without the per-product sandwich: this operator
        # permutes at shard / gather time (ROADMAP.md, queue 3)
        pp = _shared_plan(comm, m, ("reorder", n_dev, reorder),
                          lambda: RO.preprocess(
                              m, reorder=reorder, n_dev=n_dev,
                              value_bytes=m.data.dtype.itemsize,
                              sandwich=False))
    mm = pp.matrix if pp is not None and pp.applied else m

    rem_chunk_l = t_chunks = None
    if tune != "off":
        from repro_torch import tune as T   # deferred: tune imports ops
        sweep = "auto" in (grid, halo, mode)
        kw = dict(b_r=b_r, diag_align=diag_align, sigma=sigma,
                  index_dtype=index_dtype, force=(tune == "force"),
                  comm=comm, device=device)
        tp = T.tune_partition(mm, n_dev, comm_candidates=None if sweep
                              else (), **kw)
        chunk_l, rem_chunk_l = tp.chunk_l, tp.rem_chunk_l
        if sweep:
            if grid == "auto":
                grid = tp.grid
            if halo == "auto" and tp.halo:
                halo = tp.halo
            if mode == "auto" and tp.mode:
                mode = tp.mode
        if transpose == "device":
            mt = _shared_plan(comm, mm, ("transpose",),
                              lambda: F.csr_transpose(mm))
            tpt = T.tune_partition(mt, n_dev, comm_candidates=(), **kw)
            t_chunks = (tpt.chunk_l, tpt.rem_chunk_l)
    if mode == "auto":
        mode = "overlap"
    key = (n_dev, mode, halo, transpose, b_r, diag_align, chunk_l,
           rem_chunk_l, t_chunks, halo_w, sigma, str(index_dtype), grid,
           build_stages, reorder)
    plan = _shared_plan(comm, m, key, lambda: _dist_plan(
        m, n_dev, pp=pp, mode=mode, halo=halo, transpose=transpose,
        b_r=b_r, diag_align=diag_align, chunk_l=chunk_l,
        rem_chunk_l=rem_chunk_l, t_chunks=t_chunks, halo_w=halo_w,
        sigma=sigma, index_dtype=index_dtype, grid=grid,
        build_stages=build_stages))
    return DistOperator(comm=comm, mode=mode, backend=backend,
                        device=device, **plan)


def _dist_plan(m: F.CSRMatrix, n_dev: int, *, pp, mode, halo, transpose,
               b_r, diag_align, chunk_l, rem_chunk_l, t_chunks, halo_w,
               sigma, index_dtype, grid, build_stages) -> dict:
    """The host half of :func:`dist_operator`: the partitions of A (and
    A^T) with their tile heights (``t_chunks``: A^T's tuned pair, or
    None for ``chunk_l`` alone), the halo decision, the diagonal and
    the preprocessing permutation ``pp`` over the padded global
    space."""
    diag_host = F.csr_diagonal(m)          # original basis, pre-reorder
    perm_host = inv_host = None
    if pp is not None and pp.applied:
        m = pp.matrix
        perm_host, inv_host = pp.perm, pp.inv_perm

    def _build(mm, g, hw, cl, rcl):
        return D.partition_csr(mm, n_dev, b_r=b_r, diag_align=diag_align,
                               chunk_l=cl, halo_w=hw, sigma=sigma,
                               index_dtype=index_dtype, rem_chunk_l=rcl,
                               grid=g, build_stages=build_stages)

    if grid == "auto":
        # price every grid shape with the perf model, keep the cheapest
        cands = [_build(m, g if g != (n_dev, 1) else None, halo_w,
                        chunk_l, rem_chunk_l)
                 for g in D.grid_shapes(n_dev)]
        hs = ("gathered", "full") if halo == "auto" else (halo,)
        cost = [min(PM.predicted_dist_spmv_seconds(
                        d, halo=h, mode=mode,
                        value_bytes=d.loc_val.dtype.itemsize)
                    for h in hs) for d in cands]
        dist = cands[int(np.argmin(cost))]
    else:
        dist = _build(m, grid, halo_w, chunk_l, rem_chunk_l)
    if halo == "auto":
        halo = PM.choose_halo(dist, mode=mode,
                              value_bytes=dist.loc_val.dtype.itemsize)
    t_dist = None
    if transpose == "device":
        g = dist.grid
        cl_t, rcl_t = t_chunks if t_chunks is not None else (chunk_l, None)
        t_dist = _build(F.csr_transpose(m), (g[1], g[0]) if g else None,
                        None, cl_t, rcl_t)
    n_pad = dist.n_global_pad
    dg = np.zeros(n_pad, dtype=m.data.dtype)
    dg[: m.n_rows] = diag_host
    pre_perm = pre_inv = None
    if perm_host is not None:
        # identity on the pad tail, so the permutation commutes with the
        # partition's padding; the diagonal goes into the stored basis
        tail = np.arange(m.n_rows, n_pad)
        pre_perm = np.concatenate([perm_host, tail])
        pre_inv = np.concatenate([inv_host, tail])
        dg = dg[pre_perm]
    return dict(dist=dist, t_dist=t_dist, diag=dg, halo=halo,
                pre_perm=pre_perm, pre_inv=pre_inv)
