"""SparseFFN: pruned FFN weights stored blocked-sparse, applied as
``op @ X``.

Port of ``repro/sparse/sparse_ffn.py``: magnitude-prune an FFN weight to
``density``, store the survivors of Wᵀ (one row per output feature) as
SELL-C-σ or pJDS (``format="auto"`` keeps SELL's window only when it
pads no worse than pJDS), and run the forward pass as a multi-RHS
product through the port's :class:`~repro_torch.core.operator.
DeviceOperator` -- K5 (``kernels/csrc/pjds_spmm.cu``) on the card, its
plain version on the CPU.  :class:`SparseLinear` is an ``nn.Module``;
gradients reach the stored values through ``with_values``::

    v = sl.values.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(sl.with_values(v)(x)), v)

Two deliberate differences from the reference:

* The token count T is padded to a multiple of 4 (:data:`T_PAD`), the
  width of K5's 16-byte loads, not to the TPU's 128 lanes: K5 runs one
  column tile of up to 8 per grid row, so a pad to 128 walks the matrix
  16 times for 4 decode tokens.  Columns are independent, so y has the
  same bits with or without the pad.
* :func:`ops_storage_bytes` counts what the port stores beside the
  value and index streams (``row_block``, ``block_start``,
  ``warp_len``, SELL's ``inv_perm``), and :meth:`SparseLinear.
  memory_summary` adds pJDS's ``inv_perm`` and K5's row map; the
  reference counts the TPU's ``chunk_map`` instead.  The value-plus-
  index bytes are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core import formats as F
from repro_torch.core.operator import DeviceOperator, operator
from repro_torch.models.common import activation

__all__ = ["SparseLinear", "T_PAD", "prune", "ops_storage_bytes",
           "sparsify_ffn_params", "sparse_ffn_apply"]

T_PAD = 4   # K5 reads X rows with 16-byte loads when T % 4 == 0


def _pad(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def prune(w: np.ndarray, density: float) -> np.ndarray:
    """``w`` with all but its ``density`` largest magnitudes zeroed (ties
    at the threshold kept), as the reference prunes."""
    k = max(int(w.size * density), 1)
    thresh = np.partition(np.abs(w).ravel(), -k)[-k]
    return np.where(np.abs(w) >= thresh, w, 0.0)


class SparseLinear(nn.Module):
    """y = x @ W with Wᵀ stored blocked-sparse (rows = output features),
    applied through a :class:`DeviceOperator`, which lives where
    :meth:`from_dense` built it (``.to()`` does not move it)."""

    def __init__(self, op: DeviceOperator, n_out: int, n_in_pad: int,
                 sigma: int, density: float):
        super().__init__()
        self.op = op
        self.n_out = n_out
        self.n_in_pad = n_in_pad
        self.sigma = sigma
        self.density = density

    @property
    def fmt(self) -> str:
        return self.op.fmt

    @property
    def a(self):
        """The inner blocked device operand (storage accounting)."""
        return self.op.dev.dev

    @property
    def values(self) -> torch.Tensor:
        """The stored (pruned) weights: the trainable parameters."""
        return self.op.values

    def with_values(self, val: torch.Tensor) -> "SparseLinear":
        """Same sparsity pattern, new stored values (the grad handle)."""
        return SparseLinear(self.op.with_values(val), self.n_out,
                            self.n_in_pad, self.sigma, self.density)

    @staticmethod
    def from_dense(w: np.ndarray, density: float, b_r: int = 128,
                   chunk_l: int = 8, format: str = "auto",
                   sigma: int | None = None, dtype=None,
                   index_dtype="auto", device=None) -> "SparseLinear":
        """Magnitude-prune ``w`` (in, out) to ``density`` and pack it on
        ``device`` (CUDA unless ``"cpu"`` is given).  ``dtype`` /
        ``index_dtype`` choose the stored value / index widths (bf16
        values and int16 indices store 4 bytes per survivor, not 8)."""
        n_in, n_out = w.shape
        wp = prune(w, density)
        # blocked storage over W^T: each row = one output feature's weights
        csr = F.csr_from_dense(np.asarray(wp.T, dtype=np.float32))
        if format == "auto":
            # padding multiplies by T while the unpermute amortises over
            # it, so the smaller storage wins; SELL when it pads no worse
            rl = csr.row_lengths()
            sell_e = F.estimate_storage_elements(rl, "sell", b_r, chunk_l,
                                                 sigma)
            pjds_e = F.estimate_storage_elements(rl, "pjds", b_r, chunk_l)
            format = "sell" if sell_e <= pjds_e else "pjds"
        if format not in ("sell", "pjds"):
            raise ValueError(f"unknown format {format!r}")
        op = operator(csr, format=format, b_r=b_r, diag_align=chunk_l,
                      chunk_l=chunk_l, sigma=sigma, dtype=dtype,
                      index_dtype=index_dtype, device=device)
        sig = op.dev.dev.sigma if format == "sell" \
            else op.dev.dev.n_rows_pad
        return SparseLinear(op, n_out, n_in, sig, float((wp != 0).mean()))

    def forward(self, x: torch.Tensor,
                backend: Optional[str] = None) -> torch.Tensor:
        """x (..., n_in) -> (..., n_out) in x's dtype."""
        lead = x.shape[:-1]
        xt = x.reshape(-1, x.shape[-1]).T              # (n_in, T)
        t = xt.shape[1]
        if t % T_PAD:
            xt = nn.functional.pad(xt, (0, _pad(t, T_PAD) - t))
        # (n_out, T) in output-feature order, differentiable through the
        # values and x
        y = self.op.matmat(xt, backend=backend)
        return y[:, :t].T.reshape(*lead, self.n_out).to(x.dtype)

    def memory_summary(self, dense_bytes_per_el: int = 2) -> dict:
        """The stored bytes against dense storage of the same weight.
        ``pjds_bytes`` is everything the port keeps on the device for
        this layer: :func:`ops_storage_bytes` plus pJDS's ``inv_perm`` and
        K5's row map (built here if no product has built it yet)."""
        sd = self.op.dev
        dense = self.n_in_pad * self.n_out * dense_bytes_per_el
        value_index = self.a.val.numel() * (self.a.val.element_size()
                                            + self.a.col_idx.element_size())
        stored = ops_storage_bytes(self.a) + sum(
            _nbytes(t) for t in (sd.inv_perm, sd.row_map()))
        csr_min = int(self.density * self.n_in_pad * self.n_out) * 8
        return {"dense_bytes": dense, "pjds_bytes": stored,
                "value_index_bytes": value_index,
                "metadata_bytes": stored - value_index,
                "ratio_vs_dense": stored / dense,
                "padding_overhead": stored / max(csr_min, 1) - 1.0}


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def ops_storage_bytes(a, value_bytes: int | None = None,
                      index_bytes: int | None = None) -> int:
    """Device-operand footprint at the widths actually stored: the value
    and index streams (at ``value_bytes`` / ``index_bytes`` per slot if
    given), plus every other array of the container."""
    vb = a.val.element_size() if value_bytes is None else value_bytes
    ib = a.col_idx.element_size() if index_bytes is None else index_bytes
    rest = sum(_nbytes(getattr(a, f.name)) for f in dataclasses.fields(a)
               if f.name not in ("val", "col_idx")
               and isinstance(getattr(a, f.name), torch.Tensor))
    return a.val.numel() * (vb + ib) + rest


def sparsify_ffn_params(ffn_params, density: float, format: str = "auto",
                        device=None) -> nn.ModuleDict:
    """A dense FFN's ``{"w1", "w3", "w2"}`` (each holding ``"w"``) as
    :class:`SparseLinear` modules on ``device`` (CUDA unless ``"cpu"``)."""
    return nn.ModuleDict({
        k: SparseLinear.from_dense(
            v["w"].detach().float().cpu().numpy(), density, format=format,
            device=device)
        for k, v in ffn_params.items()})


def sparse_ffn_apply(sp, cfg, x: torch.Tensor,
                     backend: Optional[str] = None) -> torch.Tensor:
    act = activation(cfg.act)
    h = sp["w1"](x, backend)
    if "w3" in sp:
        h = act(h) * sp["w3"](x, backend)
    else:
        h = act(h)
    return sp["w2"](h, backend)
