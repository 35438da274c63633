"""The ``SparseOperator`` protocol over the single-device dispatch layer.

Port of ``repro/core/operator.py`` for this slice: callers see
``y = A x`` in the ORIGINAL basis while the storage format, the row
permutation and the padding stay inside.  ``op @ x`` dispatches a 1-D
``x`` to ``matvec`` and a 2-D ``X`` (``shape[1]`` rows, one column per
right-hand side) to ``matmat``; ``diagonal()`` reads diag(A) straight
from the device layout (the Jacobi preconditioner).

:class:`DistOperator` / :func:`dist_operator` run the distributed layer
(``core.dist_spmv``, paper §3) on one rank: its vectors are the rank's
slice of the padded global vector, and ``rmatvec`` / ``.T`` run the
forward body on the partition of A^T.  Single-device transposes and
gradients are not ported yet: they raise ``NotImplementedError`` naming
their ROADMAP item, so nothing degrades silently (in particular a
tensor that requires grad is refused rather than detached).
"""
from __future__ import annotations

import copy
from typing import Optional, Union

import numpy as np
import torch

from repro_torch._todo import not_ported
from repro_torch.core import dist_spmv as D
from repro_torch.core import formats as F
from repro_torch.core import perf_model as PM
from repro_torch.kernels import ops
from repro_torch.kernels._backend import host_tensor, resolve_device

__all__ = ["SparseOperator", "DeviceOperator", "DistOperator", "operator",
           "dist_operator"]


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


class DistOperator(SparseOperator):
    """One rank's view of a :class:`core.dist_spmv.DistPJDS` partition.

    Vectors are the rank's ``(n_loc,)`` or ``(n_loc, k)`` slice of the
    padded global vector (:meth:`shard_vector` cuts one, and
    :meth:`gather_vector` puts the slices back together); ``shape`` is
    the padded global shape and ``n_rows`` the unpadded count.  ``comm``
    is the rank's communicator (``core.dist_comm``); every rank of the
    partition applies the operator together.  ``t_dist``, when present,
    is the partition of A^T and serves ``rmatvec`` / ``rmatmat`` /
    ``.T``; ``diag`` is the padded global diagonal, of which
    ``diagonal()`` returns the rank's slice.  ``all_reduce_sum`` sums a
    small tensor over the ranks: the solvers reduce their dots through
    it, so every rank sees the same scalars."""

    def __init__(self, dist: D.DistPJDS, comm, *,
                 t_dist: Optional[D.DistPJDS] = None,
                 diag: Optional[np.ndarray] = None, mode: str = "overlap",
                 backend: str = "auto", halo: str = "gathered",
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

    def _apply(self, shard, x, fn):
        _refuse_grad(x)
        return fn(shard, x, self.comm, mode=self.mode, halo=self.halo,
                  backend=self.backend)

    def matvec(self, x):
        """y = A x on this rank's slice; a 2-D x goes to :meth:`matmat`."""
        if x.dim() == 2:
            return self.matmat(x)
        return self._apply(self.shard, x, D.dist_matvec)

    def matmat(self, x):
        return self._apply(self.shard, x, D.dist_matmat)

    def _t_shard(self):
        if self.t_shard is None:
            raise ValueError(
                "this DistOperator was built without a transpose partition; "
                "use dist_operator(m, comm, transpose='device')")
        return self.t_shard

    def rmatvec(self, y):
        return self._apply(self._t_shard(), y, D.dist_matvec)

    def rmatmat(self, y):
        return self._apply(self._t_shard(), y, D.dist_matmat)

    @property
    def T(self) -> "DistOperator":
        """A^T as an operator: the two partitions swapped (shared, not
        rebuilt)."""
        self._t_shard()
        t = copy.copy(self)
        t.dist, t.t_dist = self.t_dist, self.dist
        t.shard, t.t_shard = self.t_shard, self.shard
        return t

    def diagonal(self) -> torch.Tensor:
        """The rank's slice of diag(A)."""
        if self._diag is None:
            raise ValueError("this DistOperator carries no diagonal; "
                             "build it with dist_operator(m, comm)")
        return self._diag

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce_sum(t)

    def shard_vector(self, v) -> torch.Tensor:
        """This rank's slice of a global vector (``(n_rows,)`` or padded
        ``(n_global_pad,)``, optionally with a trailing k), zero-padded,
        on the operator's device."""
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        n, n_pad = self.n_rows, self.shape[0]
        if v.shape[0] not in (n, n_pad):
            raise ValueError(f"a global vector has {n} or {n_pad} rows; "
                             f"got {v.shape[0]}")
        lo = self.comm.rank * self.n_loc
        out = np.zeros((self.n_loc,) + v.shape[1:], v.dtype)
        part = v[lo:min(lo + self.n_loc, v.shape[0])]
        out[:part.shape[0]] = part
        return host_tensor(out, self.device)

    def gather_vector(self, v_local: torch.Tensor) -> torch.Tensor:
        """The padded global vector from every rank's slice, on every
        rank (one ``all_reduce_sum`` of a vector of global length)."""
        if v_local.shape[0] != self.n_loc:
            raise ValueError(f"expected this rank's {self.n_loc} rows; got "
                             f"{v_local.shape[0]}")
        full = v_local.new_zeros((self.shape[0],) + v_local.shape[1:])
        lo = self.comm.rank * self.n_loc
        full[lo:lo + self.n_loc] = v_local
        return self.comm.all_reduce_sum(full)


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
    :class:`DistOperator` (every rank calls it with the same ``m``).

    ``comm`` defaults to :class:`core.dist_comm.GroupComm` on the
    default process group; a :class:`core.dist_comm.ThreadComm` rank
    works the same.  ``device`` defaults to the current CUDA card.  With
    a host CSR the partition of A^T (``transpose="device"``, the
    default; ``None`` skips it) and the diagonal are built alongside;
    an existing ``DistPJDS`` is wrapped as it is (no transpose, no
    diagonal), so threaded ranks can share one partition.

    ``grid=(gr, gc)`` partitions over a 2-D grid, and the transpose
    partition uses ``(gc, gr)``; ``grid="auto"`` takes the shape of
    ``dist_spmv.grid_shapes`` that ``perf_model.
    predicted_dist_spmv_seconds`` prices cheapest.  ``halo="auto"``
    decides gathered or full by ``perf_model.choose_halo``, and
    ``mode="auto"`` is ``"overlap"``.  ``tune="auto"|"force"`` and
    ``reorder`` other than ``"off"`` are not ported yet and raise.
    """
    if tune not in ("off", "auto", "force"):
        raise ValueError(f"tune must be 'off', 'auto' or 'force'; "
                         f"got {tune!r}")
    if reorder not in ("off", "auto", "rcm"):
        raise ValueError(f"reorder must be 'off', 'auto' or 'rcm'; "
                         f"got {reorder!r}")
    if tune != "off":
        raise not_ported(f"dist_operator(tune={tune!r})", "dist_tune")
    if reorder != "off":
        raise not_ported(f"dist_operator(reorder={reorder!r})", "reorder")
    if comm is None:
        from repro_torch.core.dist_comm import GroupComm
        comm = GroupComm()
    if mode == "auto":
        mode = "overlap"
    kw = dict(mode=mode, backend=backend, device=device)
    if isinstance(m, D.DistPJDS):
        if grid not in (None, "auto"):
            raise ValueError("grid cannot be changed on an existing "
                             "DistPJDS; partition the host CSR instead")
        if halo == "auto":
            halo = PM.choose_halo(m, mode=mode,
                                  value_bytes=m.loc_val.dtype.itemsize)
        return DistOperator(m, comm, halo=halo, **kw)
    if not isinstance(m, F.CSRMatrix):
        raise TypeError(f"cannot partition {type(m)}")
    if transpose not in ("device", None):
        raise ValueError(f"transpose must be 'device' or None; "
                         f"got {transpose!r}")
    n_dev = comm.size

    def _build(mm, g, hw):
        return D.partition_csr(mm, n_dev, b_r=b_r, diag_align=diag_align,
                               chunk_l=chunk_l, halo_w=hw, sigma=sigma,
                               index_dtype=index_dtype, grid=g,
                               build_stages=build_stages)

    if grid == "auto":
        # price every grid shape with the perf model, keep the cheapest
        cands = [_build(m, g if g != (n_dev, 1) else None, halo_w)
                 for g in D.grid_shapes(n_dev)]
        hs = ("gathered", "full") if halo == "auto" else (halo,)
        cost = [min(PM.predicted_dist_spmv_seconds(
                        d, halo=h, mode=mode,
                        value_bytes=d.loc_val.dtype.itemsize)
                    for h in hs) for d in cands]
        dist = cands[int(np.argmin(cost))]
    else:
        dist = _build(m, grid, halo_w)
    if halo == "auto":
        halo = PM.choose_halo(dist, mode=mode,
                              value_bytes=dist.loc_val.dtype.itemsize)
    t_dist = None
    if transpose == "device":
        g = dist.grid
        t_dist = _build(F.csr_transpose(m), (g[1], g[0]) if g else None,
                        None)
    dg = np.zeros(dist.n_global_pad, dtype=m.data.dtype)
    dg[: m.n_rows] = F.csr_diagonal(m)
    return DistOperator(dist, comm, t_dist=t_dist, diag=dg, halo=halo, **kw)
