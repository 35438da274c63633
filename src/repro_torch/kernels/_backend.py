"""Shared backend plumbing: the accumulator rule, the backend and device
decisions, and the one rule that turns host arrays into tensors.

Counterpart of the reference's ``repro.kernels._backend`` plus
``ops.resolve_backend``.  There is no interpret mode on a GPU, so the
decision is made per tensor: a CUDA tensor on a Hopper-class card
(compute capability >= 9.0) goes to the hand-written kernels, a CPU
tensor to the plain PyTorch versions, and anything else raises.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["acc_dtype", "pad_x_to_tiles", "resolve_backend",
           "resolve_device", "host_tensor", "value_dtype",
           "VALUE_DTYPES", "INDEX_DTYPES"]

# Storage dtypes the kernels take: values f32/bf16, indices int32/int16.
VALUE_DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int16)


def acc_dtype(*dts) -> torch.dtype:
    """Accumulator dtype rule shared by every kernel and plain version:
    sub-f32 value/RHS streams (bf16/f16 storage) accumulate -- and
    return -- in f32; f32/f64 stay put."""
    r = dts[0]
    for d in dts[1:]:
        r = torch.promote_types(r, d)
    if r in (torch.bfloat16, torch.float16):
        return torch.float32
    return r


def pad_x_to_tiles(x: torch.Tensor, x_tiles: int):
    """Zero-pad a 1-D RHS to a multiple of ``x_tiles``.  Returns
    (padded x, tile length).  Kept for parity with the reference's
    column-blocked grid; the CUDA kernels read x whole through L2 and
    never tile it."""
    n = x.shape[0]
    rem = n % x_tiles
    if rem:
        x = torch.nn.functional.pad(x, (0, x_tiles - rem))
    return x, x.shape[0] // x_tiles


def resolve_backend(x: torch.Tensor, backend: str = "auto") -> str:
    """``"kernel"`` for a CUDA tensor on compute capability >= 9.0,
    ``"ref"`` for a CPU tensor; anything else raises.  An explicit
    ``backend`` must agree with that decision -- the port never runs a
    kernel's plain version on the card behind the caller's back, and
    has no interpret mode to run a kernel on the CPU."""
    if backend not in ("auto", "kernel", "ref"):
        raise ValueError(f"unknown backend {backend!r}")
    if x.device.type == "cpu":
        chosen = "ref"
    elif x.device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(x.device)
        if major < 9:
            raise RuntimeError(
                f"the repro_torch kernels are built for sm_90a; "
                f"{torch.cuda.get_device_name(x.device)} is sm_{major}{minor}")
        chosen = "kernel"
    else:
        raise RuntimeError(f"no backend for device {x.device}")
    if backend != "auto" and backend != chosen:
        raise ValueError(
            f"backend={backend!r} is not available for a tensor on "
            f"{x.device.type} (only {chosen!r} is)")
    return chosen


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: CUDA unless the caller names a
    device.  With no device given and no CUDA present this raises -- the
    port never quietly runs on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def value_dtype(dtype) -> torch.dtype | None:
    """Resolve a stored-value ``dtype=`` argument (a torch dtype, a numpy
    dtype or its name, e.g. ``"bfloat16"``) to f32 or bf16; ``None``
    keeps the host width policy (f32).  Anything else raises."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        dt = dtype
    else:
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(name)
        if dt is None:
            raise ValueError(f"unsupported value dtype {dtype!r}")
    if dt not in VALUE_DTYPES:
        raise ValueError(f"stored values must be float32 or bfloat16; "
                         f"got {dt}")
    return dt


def _check_streams(val: torch.Tensor, col_idx: torch.Tensor) -> None:
    if val.dim() != 2 or val.shape != col_idx.shape:
        raise ValueError(f"val {tuple(val.shape)} and col_idx "
                         f"{tuple(col_idx.shape)} must be equal 2-D shapes")
    if val.dtype not in VALUE_DTYPES:
        raise TypeError(f"stored values must be float32 or bfloat16; got "
                        f"{val.dtype}")
    if col_idx.dtype not in INDEX_DTYPES:
        raise TypeError(f"column indices must be int32 or int16; got "
                        f"{col_idx.dtype}")


def _check_x(x: torch.Tensor, max_col: int, x_dim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor; x is on "
                         f"{x.device}")
    if x.dim() != x_dim:
        raise ValueError(f"x must be {x_dim}-D; got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    if x.shape[0] <= max_col:
        raise ValueError(f"x has {x.shape[0]} rows; the operand reads "
                         f"column {max_col}")


def _check_placement(x: torch.Tensor, tensors) -> torch.Tensor:
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # a bf16 RHS widens exactly; a strided one is copied, never read
    # with the wrong strides
    return x.float().contiguous()


def check_blocked(val: torch.Tensor, col_idx: torch.Tensor,
                  block_start: torch.Tensor, x: torch.Tensor, n_blocks: int,
                  max_col: int, vectors=(), x_dim: int = 1) -> torch.Tensor:
    """Validate a blocked (pJDS / SELL / CMRS) operand and its RHS before
    their pointers reach a kernel; returns x as contiguous float32.
    ``block_start`` is the (n_blocks + 1,) int32 offset array (CMRS: the
    strip offsets); ``vectors`` are further (name, tensor, length)
    operands that must be contiguous int32/float32 on the same card;
    ``x_dim`` is 2 for a block of right-hand sides (rows = columns of
    the matrix)."""
    _check_x(x, max_col, x_dim)
    _check_streams(val, col_idx)
    b_r = val.shape[1]
    if b_r % 32 or not 32 <= b_r <= 1024:
        raise ValueError(f"the kernels take b_r in 32..1024, a multiple of "
                         f"32 (one CTA of row lanes); got {b_r}")
    if block_start.dtype != torch.int32 or block_start.shape != (
            n_blocks + 1,):
        raise ValueError(f"block_start must be int32 of shape "
                         f"({n_blocks + 1},)")
    tensors = [("val", val), ("col_idx", col_idx),
               ("block_start", block_start)]
    for name, t, n in vectors:
        if t.dtype not in (torch.int32, torch.float32) or t.shape != (n,):
            raise ValueError(f"{name} must be int32/float32 of shape ({n},);"
                             f" got {t.dtype} {tuple(t.shape)}")
        tensors.append((name, t))
    return _check_placement(x, tensors)


def check_ell(val: torch.Tensor, col_idx: torch.Tensor,
              rowlen: torch.Tensor, x: torch.Tensor,
              max_col: int) -> torch.Tensor:
    """Validate an ELLPACK-R operand -- val/col_idx (max_nzr, n_pad),
    rowlen (n_pad,) int32 -- and its 1-D RHS; returns x as contiguous
    float32.  ``rowlen <= max_nzr`` is checked once at conversion
    (``ops.to_device_ell``)."""
    _check_x(x, max_col, 1)
    _check_streams(val, col_idx)
    if rowlen.dtype != torch.int32 or rowlen.shape != (val.shape[1],):
        raise ValueError(f"rowlen must be int32 of shape ({val.shape[1]},)")
    return _check_placement(x, [("val", val), ("col_idx", col_idx),
                                ("rowlen", rowlen)])


def kind_codes(val: torch.Tensor, col_idx: torch.Tensor) -> tuple:
    """The C interface's (value kind, index kind): f32 0 / bf16 1,
    int32 0 / int16 1."""
    return (VALUE_DTYPES.index(val.dtype), INDEX_DTYPES.index(col_idx.dtype))


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream


def host_tensor(a: np.ndarray, device, dtype: torch.dtype | None = None
                ) -> torch.Tensor:
    """Host array -> tensor on ``device`` under the port's width rule.

    The generators leave float64 data and int64 indices; the reference
    stores them as f32 / int32 because JAX runs with x64 off.  So does
    this: float64 -> float32, int64 -> int32, narrower types unchanged.
    ``dtype=torch.bfloat16`` rounds through f32 (f64 -> f32 -> bf16,
    round-to-nearest-even), which gives the same bits as the
    reference's numpy cast."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device)
