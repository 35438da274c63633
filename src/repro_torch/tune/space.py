"""Search-space enumeration and model-based pruning for the autotuner.

Port of ``repro/tune/space.py``.  The kernel-static space is
``format x b_r x chunk_l x sigma x x_tiles`` (times the dtype policy,
which is an INPUT, not a search axis: the caller's storage precision is
a contract, the tuner only picks layout statics for it).  It is pruned
with the same ``perf_model`` pricing the static dispatch uses, with one
guarantee: :func:`prune_candidates` NEVER drops the heuristic default
(``kernels.ops.as_device``'s no-tuning build), so the measured winner
can only tie or beat what dispatch would have picked.

The enumeration is the reference's, axis for axis.  On the card two of
its axes move little: ``chunk_l`` changes the stored padding but not
the slots K1-K3 and K5 walk (they stop at their derived ``warp_len``),
and ``x_tiles`` changes no kernel at all (it steers only the format
pick and fused eligibility).  Candidates that differ only there are
expected to tie within noise; PERF.md records the measured rows.

The port's default device spec is the H100 (as in
``ops.select_format``); pass ``spec=perf_model.TPU_V5E`` for the
reference's decisions.  ``spec`` prices the heuristic's format pick too,
so the heuristic stays exactly the build ``as_device(tune="off")``
makes under the same spec.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import formats as F
from repro_torch.core import perf_model as PM
from repro_torch.kernels import ops

__all__ = [
    "Candidate",
    "heuristic_candidate",
    "enumerate_candidates",
    "price_candidate",
    "prune_candidates",
    "solver_candidates",
    "dist_candidates",
]

# Default search axes, as in the reference.
B_R_OPTIONS = (32, 64, 128)
CHUNK_L_OPTIONS = (8, 16, 32)
SIGMA_FACTORS = (1, 4, 8, 32)      # sigma = factor * b_r, capped at n_pad

_DEFAULT_B_R = 128                 # as_device defaults -- the heuristic build
_DEFAULT_CHUNK_L = 16
_DEFAULT_DIAG_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the kernel-static search space: everything
    ``kernels.ops.as_device`` needs beyond the matrix and the dtype
    policy.  ``sigma`` is meaningful for sell only (None elsewhere);
    hashable/frozen so candidate sets dedupe, JSON-roundtrippable so
    the persistent cache can store the winning point."""

    fmt: str
    b_r: int = _DEFAULT_B_R
    chunk_l: int = _DEFAULT_CHUNK_L
    sigma: Optional[int] = None
    x_tiles: int = 1

    def build_kwargs(self) -> dict:
        """Keyword arguments for ``ops.as_device`` (minus the dtype
        policy, which the caller owns)."""
        return dict(
            format=self.fmt,
            b_r=self.b_r,
            diag_align=max(_DEFAULT_DIAG_ALIGN, self.chunk_l),
            sigma=self.sigma,
            chunk_l=self.chunk_l,
            x_tiles=self.x_tiles,
        )

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def label(self) -> str:
        sig = f" sigma={self.sigma}" if self.sigma is not None else ""
        xt = f" x_tiles={self.x_tiles}" if self.x_tiles != 1 else ""
        return f"{self.fmt} b_r={self.b_r} chunk_l={self.chunk_l}{sig}{xt}"


def _auto_x_tiles(m: F.CSRMatrix) -> int:
    # Same rule as as_device: the tile is sized by the runtime vector
    # width (>= f32), whatever the stored value width.
    return ops.choose_x_tiles(m.shape[1], max(4, m.data.dtype.itemsize))


def heuristic_candidate(
    m: F.CSRMatrix,
    format: str = "auto",
    dtype=None,
    index_dtype="auto",
    spec: PM.TPUSpec = PM.H100,
) -> Candidate:
    """The exact build ``as_device`` produces with default statics and
    ``tune="off"`` (its format picked under ``spec``) -- the baseline
    every tuned decision is benchmarked against, and the candidate
    :func:`prune_candidates` may never drop."""
    auto_t = _auto_x_tiles(m)
    da = max(_DEFAULT_DIAG_ALIGN, _DEFAULT_CHUNK_L)
    fmt = format
    if fmt == "auto":
        fmt = ops.select_format(m, b_r=_DEFAULT_B_R, diag_align=da,
                                sigma=None, spec=spec, value_dtype=dtype,
                                index_dtype=index_dtype, x_tiles=auto_t)
    sigma = None
    if fmt == "sell":
        sigma = min(8 * _DEFAULT_B_R,
                    F._pad_to(max(m.n_rows, 1), _DEFAULT_B_R))
    return Candidate(
        fmt=fmt,
        b_r=_DEFAULT_B_R,
        chunk_l=_DEFAULT_CHUNK_L,
        sigma=sigma,
        x_tiles=auto_t if fmt in ("sell", "pjds") else 1,
    )


def enumerate_candidates(
    m: F.CSRMatrix,
    format: str = "auto",
    dtype=None,
    index_dtype="auto",
    b_r_options: Sequence[int] = B_R_OPTIONS,
    chunk_l_options: Sequence[int] = CHUNK_L_OPTIONS,
    sigma_factors: Sequence[int] = SIGMA_FACTORS,
    spec: PM.TPUSpec = PM.H100,
) -> list[Candidate]:
    """All legal kernel-static points for ``m`` under the given format
    restriction (``format != "auto"`` collapses the format axis).  The
    heuristic default is always a member.  Degenerate matrices (empty,
    or too few rows to fill one block at the smallest b_r) collapse to
    the CSR baseline."""
    heur = heuristic_candidate(m, format, dtype, index_dtype, spec)
    n = m.n_rows
    if m.nnz == 0 or n < ops._CSR_MIN_ROWS_FACTOR * min(b_r_options):
        return list(dict.fromkeys([Candidate(fmt="csr"), heur]))

    fmts = (["csr", "ellpack_r", "pjds", "sell", "cmrs"] if format == "auto"
            else [format])
    auto_t = _auto_x_tiles(m)
    out = [heur]
    for fmt in fmts:
        if fmt == "csr":
            out.append(Candidate(fmt="csr"))
            continue
        # x too wide to stay whole (the reference's rule) -> only the
        # column-blocking formats; otherwise the whole-x build only.
        if fmt in ("sell", "pjds", "cmrs"):
            tile_opts = sorted({auto_t} | ({1} if auto_t == 1 else
                                           {auto_t, 2 * auto_t}))
        else:
            if auto_t > 1:
                continue
            tile_opts = [1]
        for b_r in b_r_options:
            if n < ops._CSR_MIN_ROWS_FACTOR * b_r:
                continue       # block padding dominates; csr covers this
            sigmas = [None]
            if fmt == "sell":
                n_pad = F._pad_to(n, b_r)
                sigmas = sorted({min(f * b_r, n_pad)
                                 for f in sigma_factors})
            for chunk_l in chunk_l_options:
                for sigma in sigmas:
                    for xt in tile_opts:
                        out.append(Candidate(fmt=fmt, b_r=b_r,
                                             chunk_l=chunk_l, sigma=sigma,
                                             x_tiles=xt))
    return list(dict.fromkeys(out))


def solver_candidates(
    m: F.CSRMatrix,
    *,
    method: str = "cg",
    dtype=None,
    index_dtype="auto",
    spec: PM.TPUSpec = PM.H100,
) -> list[tuple[str, Candidate]]:
    """The solver-level probe set: (strategy, layout) pairs for
    ``tune_solver``, where strategy is ``"fused"`` (K3's spMV + dots
    iteration -- a SELL build with ``x_tiles=1``) or ``"composed"``
    (separate products and reductions over the heuristic's layout, and
    over the SELL build when that differs).  Only the decisions that
    change at the solver level are probed: fused against composed, and
    the fused build's ``chunk_l``."""
    h_sell = heuristic_candidate(m, "sell", dtype, index_dtype, spec)
    h_sell = dataclasses.replace(h_sell, x_tiles=1)
    alt_cl = 8 if h_sell.chunk_l != 8 else 16
    h_auto = heuristic_candidate(m, "auto", dtype, index_dtype, spec)
    out: list[tuple[str, Candidate]] = [
        ("fused", h_sell),
        ("fused", dataclasses.replace(h_sell, chunk_l=alt_cl)),
        ("composed", h_auto),
    ]
    if h_auto != h_sell:
        out.append(("composed", h_sell))
    return list(dict.fromkeys(out))


def price_candidate(
    m: F.CSRMatrix,
    c: Candidate,
    *,
    dtype=None,
    index_dtype="auto",
    spec: PM.TPUSpec = PM.H100,
    calibration="default",
) -> float:
    """Predicted memory-bound spMVM seconds of candidate ``c`` on ``m``
    -- the ``perf_model`` pricing ``select_format`` uses, extended over
    the full static space.  ``calibration=None`` forces the uncalibrated
    data-sheet model (the calibration fit's regressor); the default
    picks up any installed calibration."""
    n, n_nzr = m.n_rows, m.n_nzr
    vecb = max(4, m.data.dtype.itemsize)
    vb = m.data.dtype.itemsize if dtype is None else ops._itemsize(dtype)
    if c.fmt == "csr":
        # CSRDevice streams indices AND row ids per nnz (8 index bytes).
        return PM.predicted_spmv_seconds(
            m.nnz, n, n_nzr, irregular_factor=ops._CSR_IRREGULAR_FACTOR,
            spec=spec, value_bytes=vb, index_bytes=8, vec_bytes=vecb,
            fmt="csr", calibration=calibration)
    rl = m.row_lengths()
    ib = F.resolve_index_dtype(index_dtype, m.shape[1]).itemsize
    da = max(_DEFAULT_DIAG_ALIGN, c.chunk_l)
    elems = F.estimate_storage_elements(rl, c.fmt, c.b_r, da, c.sigma)
    perm_bytes = 0.0
    if c.fmt in ("sell", "pjds"):
        perm_bytes = PM.perm_traffic_bytes(
            n, vecb, window_local=(c.fmt == "sell"))
    if c.fmt == "cmrs":
        # the int8 row_in_strip stream adds a byte per slot, and the
        # reference's reduction compute term can bound it instead
        ib += PM.CMRS_RIS_BYTES
    t = PM.predicted_spmv_seconds(
        elems, n, n_nzr, perm_bytes=perm_bytes, spec=spec,
        value_bytes=vb, index_bytes=ib, vec_bytes=vecb,
        x_tiles=c.x_tiles, n_row_blocks=-(-n // c.b_r),
        fmt=c.fmt, calibration=calibration)
    if c.fmt == "cmrs":
        t = max(t, PM.cmrs_reduce_seconds(elems * c.x_tiles, c.b_r, spec))
    return t


def prune_candidates(
    m: F.CSRMatrix,
    candidates: Sequence[Candidate],
    *,
    top_k: int = 6,
    dtype=None,
    index_dtype="auto",
    spec: PM.TPUSpec = PM.H100,
    heuristic: Optional[Candidate] = None,
) -> list[Candidate]:
    """Keep the ``top_k`` model-cheapest candidates, ALWAYS including
    the heuristic default (appended back if the model would drop it --
    the guarantee that tuning can never do worse than dispatch by more
    than measurement noise).  Ordered cheapest-predicted first."""
    if heuristic is None:
        heuristic = heuristic_candidate(m, dtype=dtype,
                                        index_dtype=index_dtype, spec=spec)
    priced = sorted(
        dict.fromkeys(candidates),
        key=lambda c: price_candidate(m, c, dtype=dtype,
                                      index_dtype=index_dtype, spec=spec))
    kept = priced[: max(top_k, 1)]
    if heuristic not in kept:
        kept.append(heuristic)
    return kept


def dist_candidates(
    n_dev: int,
    *,
    halos: Sequence[str] = ("gathered", "full"),
    modes: Sequence[str] = ("vector", "overlap", "pipeline"),
    grids: Optional[Sequence] = None,
    halo_w_options: Sequence[Optional[int]] = (None,),
) -> list[dict]:
    """The DISTRIBUTED probe set: one dict per (grid, halo, mode,
    halo_w) combination for ``tune_partition``'s communication sweep,
    in the reference's order.

    The grid axis defaults to the three structurally distinct shapes of
    ``n_dev`` ranks -- pure row partitioning ``(P, 1)`` (stored as
    ``grid=None``), pure column partitioning ``(1, P)`` and the
    most-square 2-D factorisation plus its transpose.  The mode axis
    skips ``"naive"`` (the exchange of ``"vector"`` plus a wait) and
    drops ``"pipeline"`` for full halos (a staged full exchange ships
    the same bytes in more messages).  ``halo_w=None`` is the measured
    coupling width.
    """
    if grids is None:
        gs: list = [(n_dev, 1)]
        if n_dev > 1:
            gs.append((1, n_dev))
        sq = max(g for g in range(1, int(np.sqrt(n_dev)) + 1)
                 if n_dev % g == 0)
        if sq > 1:
            gs += [(sq, n_dev // sq), (n_dev // sq, sq)]
        grids = list(dict.fromkeys(gs))
    out = []
    for grid in grids:
        for halo in halos:
            for mode in modes:
                if mode == "naive" or (mode == "pipeline" and halo == "full"):
                    continue
                for hw in halo_w_options:
                    out.append(dict(grid=(None if grid in (None, (n_dev, 1))
                                          else tuple(grid)),
                                    halo=str(halo), mode=str(mode),
                                    halo_w=hw))
    return [dict(t) for t in dict.fromkeys(
        tuple(sorted(c.items(), key=lambda kv: kv[0])) for c in out)]
