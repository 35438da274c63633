"""K3: the fused Krylov iteration -- SELL-C-sigma spMV plus the five dot
products of a CG/BiCGStab step in one pass, hand-written for Hopper.

Replaces ``repro/kernels/fused_iter.py::fused_spmv_dots_kernel_call``
(the Pallas TPU kernel).  The CUDA source is ``csrc/fused_iter.cu``:
K2's window kernel plus an epilogue.  The same sigma-window CTA (128
threads, more when too few windows would leave the card idle) runs K2's
walk (``repro::window_spmv``: each warp walks its derived ``warp_len``
diagonals and adds the skipped padding's ``0 * x[0]`` once), so y is
K2's y bit for bit; while the unpermuted slab is still in shared memory
it multiplies each row it writes by ``w1[i]`` / ``w2[i]`` and reduces
the CTA's partials of

    <y,w1>   <y,w2>   <y,y>   <w2,w2>   <w1,w2>

into one row of an ``(n_win, 5)`` buffer; a second stage sums the rows
in a fixed order.  No float atomics, so solves are deterministic.  Every
window stores at least one chunk, so all five dots cover every row (the
reference kernel's empty-window caveat never arises).

What bounds it on an H100: bytes -- K2's traffic (the walked slots,
1.05 x nnz on the 3.4 M-row sAMG, where every stored slot would be 2.70
x) plus w1 and w2 read once and the partials written and read once.

The port's fused pass (:class:`MatVecDots`) returns ``(y, dots)`` with
``dots`` one (5,) float32 tensor in the order above (the reference
returns the five as separate scalars).  For the fused solvers' device
loop it also writes into given buffers and takes the loop's ``done``
latch: while it is set every CTA returns before touching memory, and
while it is clear y and the dots keep their bits.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as R
from ._backend import check_blocked, kind_codes, resolve_backend, stream_of
from .sell_spmv import slab_fits, window_blocks

__all__ = ["fused_spmv_dots_kernel_call", "fused_matvec_dots",
           "MatVecDots", "make_matvec_dots"]


def _fn():
    lib = _build.load("fused_iter")
    fn = lib.fused_spmv_dots
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i] + [p] * 11 + [i, i, i, p]
        fn.restype = ctypes.c_int
        lib.fused_iter_gather_rows.argtypes = []
        lib.fused_iter_gather_rows.restype = ctypes.c_int
    return fn, lib.fused_iter_gather_rows


def _work_shapes(n_blocks: int, b_r: int, sigma: int, gather_rows) -> tuple:
    """(w_b, rows of the partials buffer, whether a scratch vector is
    needed) of one K3 launch."""
    w_b = window_blocks(sigma, b_r, n_blocks)
    if slab_fits(w_b, b_r):
        return w_b, -(-n_blocks // w_b), False
    return w_b, -(-n_blocks * b_r // gather_rows()), True


def _check_out(name, t, shape, dev):
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 of shape "
                         f"{shape} on {dev}")


def fused_spmv_dots_kernel_call(val: torch.Tensor, col_idx: torch.Tensor,
                                block_start: torch.Tensor,
                                inv_perm: torch.Tensor,
                                warp_len: torch.Tensor, x: torch.Tensor,
                                w1: torch.Tensor, w2: torch.Tensor, *,
                                n_blocks: int, sigma: int, max_col: int,
                                y=None, dots=None, part=None, scratch=None,
                                done=None):
    """(y, dots) through K3: y = A_sell @ x in ORIGINAL row order,
    (n_blocks * b_r,) float32, and dots = [<y,w1>, <y,w2>, <y,y>,
    <w2,w2>, <w1,w2>] as a (5,) float32 tensor.  Operands as for K2
    (``warp_len``: (n_blocks * b_r / 32,) int32, the diagonals each warp
    walks; ``ops.stored_warp_len`` walks them all); ``w1``/``w2`` are
    (n_blocks * b_r,) float32 carriers, zero past the real rows.

    ``y`` / ``dots``, and the launch's work buffers ``part`` /
    ``scratch`` (:meth:`MatVecDots.work`), may be given so that nothing
    is allocated (a CUDA graph captures the launch); ``done``, a
    one-element int32 tensor on the card, makes every CTA return before
    touching memory while it is set."""
    b_r = val.shape[1]
    n_pad = n_blocks * b_r
    x = check_blocked(val, col_idx, block_start, x, n_blocks, max_col,
                      vectors=[("inv_perm", inv_perm, n_pad),
                               ("warp_len", warp_len, n_pad // 32),
                               ("w1", w1, n_pad), ("w2", w2, n_pad)])
    if inv_perm.dtype != torch.int32 or warp_len.dtype != torch.int32:
        raise TypeError("inv_perm and warp_len must be int32")
    if w1.dtype != torch.float32 or w2.dtype != torch.float32:
        raise TypeError("w1 and w2 must be float32")
    if n_blocks < 1:
        raise ValueError("the fused pass needs at least one row block")
    fn, gather_rows = _fn()
    w_b, n_part, needs_scratch = _work_shapes(n_blocks, b_r, sigma,
                                              gather_rows)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty(n_pad, **f32) if y is None else y
    dots = torch.empty(5, **f32) if dots is None else dots
    part = torch.empty((n_part, 5), **f32) if part is None else part
    if needs_scratch and scratch is None:
        scratch = torch.empty(n_pad, **f32)
    _check_out("y", y, (n_pad,), dev)
    _check_out("dots", dots, (5,), dev)
    _check_out("part", part, (n_part, 5), dev)
    if needs_scratch:
        _check_out("scratch", scratch, (n_pad,), dev)
    if done is not None and (done.dtype != torch.int32 or done.numel() != 1
                             or done.device != dev):
        raise ValueError("done must be one int32 on the card of x")
    vk, ik = kind_codes(val, col_idx)
    rc = fn(val.data_ptr(), vk, col_idx.data_ptr(), ik,
            block_start.data_ptr(), inv_perm.data_ptr(), warp_len.data_ptr(),
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr(),
            part.data_ptr(), dots.data_ptr(),
            scratch.data_ptr() if needs_scratch else None,
            None if done is None else done.data_ptr(),
            n_blocks, b_r, w_b, stream_of(x))
    _build.check("fused_iter", rc, "fused_iter launch")
    _build.count_launch(fused_spmv_dots_kernel_call)
    return y, dots


fused_spmv_dots_kernel_call.launches = 0


def fused_matvec_dots(a, x, w1, w2, *, backend: str = "auto", y=None,
                      dots=None, done=None, work=(None, None)):
    """(y, dots) over a ``SELLDevice``: K3 for CUDA tensors, the plain
    version for CPU tensors.  Carriers live at the padded length
    ``a.n_rows_pad``; ``y`` / ``dots`` / ``done`` / ``work`` (part,
    scratch) as for :func:`fused_spmv_dots_kernel_call`."""
    if resolve_backend(x, backend) == "kernel":
        part, scratch = work
        return fused_spmv_dots_kernel_call(
            a.val, a.col_idx, a.block_start, a.inv_perm, a.warp_len, x, w1,
            w2, n_blocks=a.n_blocks, sigma=a.sigma, max_col=a.max_col,
            y=y, dots=dots, part=part, scratch=scratch, done=done)
    return R.fused_matvec_dots_ref(a.val, a.col_idx, a.row_block,
                                   a.inv_perm, x, w1, w2, a.n_blocks, y=y,
                                   dots=dots, done=done)


class MatVecDots:
    """The fused pass over one ``SELLDevice``, for the fused solvers
    (``core.solvers.fused_cg`` / ``fused_bicgstab``); build it once per
    operand (``make_matvec_dots``).  ``mvd(v, w1, w2)`` returns a fresh
    ``(Av, dots)``; :meth:`into` writes into given buffers and honours
    the loop's ``done`` latch.  ``loops`` holds the solvers' device
    loops (carriers, scalar state, CUDA graphs) for this operand."""

    def __init__(self, a, backend: str = "auto"):
        self.a = a
        self.backend = backend
        self.loops: dict = {}
        self._work = None

    @property
    def n_pad(self) -> int:
        return self.a.n_rows_pad

    def __call__(self, v, w1, w2):
        return fused_matvec_dots(self.a, v, w1, w2, backend=self.backend)

    def work(self, device) -> tuple:
        """K3's (part, scratch) work buffers on ``device``, allocated
        once (scratch is None on the shared-memory path; both are None
        on the CPU)."""
        if device.type != "cuda":
            return None, None
        if self._work is None:
            a = self.a
            _, gather_rows = _fn()
            _, n_part, needs = _work_shapes(a.n_blocks, a.b_r, a.sigma,
                                            gather_rows)
            f32 = dict(dtype=torch.float32, device=device)
            self._work = (torch.empty((n_part, 5), **f32),
                          torch.empty(a.n_rows_pad, **f32) if needs
                          else None)
        return self._work

    def into(self, v, w1, w2, y, dots, done) -> None:
        """K3 (or its plain version) into ``y`` / ``dots``, nothing at
        all while ``done`` is set."""
        fused_matvec_dots(self.a, v, w1, w2, backend=self.backend, y=y,
                          dots=dots, done=done, work=self.work(v.device))


def make_matvec_dots(a, *, backend: str = "auto") -> MatVecDots:
    """The fused pass over one ``SELLDevice`` for the fused solvers;
    build it once per operand."""
    return MatVecDots(a, backend=backend)
