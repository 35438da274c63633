"""The memory-bound spMVM time model that prices the dispatch decision.

A copy of what ``repro.core.perf_model`` gives ``select_format``: the
device spec record, the stored-byte model (paper Eq. 1 generalised to
compressed streams), the out-of-kernel permutation cost, the CMRS
compute floor, the solver-iteration byte count and time
(``predicted_iteration_seconds``), the three-term roofline
(``roofline_terms``, ``RooflineReport``), the calibration hook
those functions read (``set_calibration`` / ``get_calibration``; the
tuner's ``tune.calibrate.fit_calibration`` fits one), and the paper's
device-vs-link model (Eq. 1-4) with its gathered-halo refinement that
prices the distributed layer (``predicted_dist_spmv_seconds``,
``choose_halo``).  ``TPU_V5E`` stays so the port can be held to the
reference's decisions; :data:`H100` is the port's default spec.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

__all__ = [
    "TPUSpec",
    "TPU_V5E",
    "H100",
    "Calibration",
    "set_calibration",
    "get_calibration",
    "clear_calibration",
    "code_balance",
    "alpha_range",
    "t_mvm",
    "t_link",
    "t_link_gathered",
    "predicted_dist_spmv_seconds",
    "choose_halo",
    "n_nzr_upper_for_link_penalty",
    "n_nzr_lower_for_link_penalty",
    "spmvm_bytes",
    "perm_traffic_bytes",
    "CMRS_RIS_BYTES",
    "cmrs_reduce_seconds",
    "predicted_spmv_seconds",
    "SOLVER_SPMV_COUNT",
    "SOLVER_VECTOR_PASSES",
    "solver_iteration_bytes",
    "predicted_iteration_seconds",
    "spmvm_flops",
    "roofline_terms",
    "RooflineReport",
]


@dataclasses.dataclass(frozen=True)
class TPUSpec:
    """One accelerator's data-sheet numbers.  The name is the
    reference's; the record describes a GPU just as well (``vmem_bytes``
    is then the per-block shared memory, ``ici_bw`` the per-direction
    NVLink rate)."""

    name: str
    peak_flops: float        # FLOP/s per chip (bf16 matrix units)
    peak_flops_f32: float    # FLOP/s per chip on the f32 spMVM path
    hbm_bw: float            # bytes/s per chip
    ici_bw: float            # bytes/s per link
    vmem_bytes: int
    hbm_bytes: int


TPU_V5E = TPUSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    peak_flops_f32=197e12 / 4,  # f32 through the MXU at quarter rate
    hbm_bw=819e9,
    ici_bw=50e9,
    vmem_bytes=128 * 2 ** 20,
    hbm_bytes=16 * 2 ** 30,
)

# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 67 TFLOP/s f32
# outside the tensor cores, 3.35 TB/s HBM3, 80 GB, NVLink 450 GB/s each
# way, 227 KB of shared memory per block.  Rates assume the 700 W limit.
H100 = TPUSpec(
    name="h100-sxm",
    peak_flops=989e12,
    peak_flops_f32=67e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    vmem_bytes=232_448,
    hbm_bytes=80 * 10 ** 9,
)


# ------------------------------------------------------------- calibration
@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured correction to the memory-bound time model:
    ``predicted = bytes / (spec.hbm_bw * bw_scale) + overhead_s[fmt]``.

    ``link_bw_scale`` scales the link rate and ``msg_overhead_s`` is the
    fixed cost of one point-to-point message per halo flavour (missing
    keys cost 0), which the distributed model's link term reads
    (:func:`t_link_gathered`)."""

    bw_scale: float
    overhead_s: Mapping[str, float] = dataclasses.field(default_factory=dict)
    source: str = ""
    link_bw_scale: float = 1.0
    msg_overhead_s: Mapping[str, float] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if not (self.bw_scale > 0):
            raise ValueError(f"bw_scale must be > 0; got {self.bw_scale}")
        if not (self.link_bw_scale > 0):
            raise ValueError(
                f"link_bw_scale must be > 0; got {self.link_bw_scale}")


_CALIBRATION: Optional[Calibration] = None


def set_calibration(cal: Optional[Calibration]) -> None:
    """Install ``cal`` as the process-wide default calibration (read by
    every :func:`predicted_spmv_seconds` call without an explicit
    ``calibration=``).  ``None`` uninstalls."""
    global _CALIBRATION
    if cal is not None and not isinstance(cal, Calibration):
        raise TypeError(f"expected Calibration or None; got {type(cal)}")
    _CALIBRATION = cal


def get_calibration() -> Optional[Calibration]:
    """The installed process-wide calibration, or None."""
    return _CALIBRATION


def clear_calibration() -> None:
    set_calibration(None)


# ---------------------------------------------------------------- Eq. (1)
def code_balance(alpha: float, n_nzr: float, value_bytes: int = 8,
                 index_bytes: int = 4) -> float:
    """Worst-case code balance in bytes/flop (paper Eq. 1, generalised to
    any value precision).  DP (value_bytes=8):  6 + 4*alpha + 8/N_nzr.
    SP (value_bytes=4):                          4 + 2*alpha + 4/N_nzr.
    """
    # per non-zero: val + col_idx + alpha*RHS element + LHS (read+write)
    # per row, over 2 flops
    return (
        value_bytes + index_bytes + value_bytes * alpha
        + 2 * value_bytes / n_nzr
    ) / 2.0


def alpha_range(n_nzr: float) -> tuple[float, float]:
    """Admissible RHS reuse parameter: [1/N_nzr (perfect reuse), 1 (none)]."""
    return (1.0 / n_nzr, 1.0)


# ------------------------------------------------------------- Eq. (2)-(4)
def t_mvm(n_rows: float, n_nzr: float, alpha: float, dev_bw: float,
          value_bytes: int = 8) -> float:
    """Paper Eq. (2) left: wallclock of the on-device spMVM.
    T = (value_bytes*N / B_dev) * [N_nzr*(alpha + 3/2) + 2]  (DP form)."""
    return (value_bytes * n_rows / dev_bw) * (n_nzr * (alpha + 1.5) + 2.0)


def t_link(n_rows: float, link_bw: float, value_bytes: int = 8) -> float:
    """Paper Eq. (2) right: moving RHS in and LHS out over the slow link."""
    return 2 * value_bytes * n_rows / link_bw


def t_link_gathered(halo_elems: float, link_bw: float,
                    value_bytes: int = 8, k: int = 1, *,
                    msgs: int = 0, halo: str = "gathered",
                    calibration="default") -> float:
    """Gathered-halo refinement of the Eq. (2) link term: only the
    measured per-neighbour halo entries cross the link, not the whole
    slice.  ``halo_elems`` is the sum of the per-neighbour halo sizes
    (``DistPJDS.halo_lens`` plus, on a 2-D grid, ``red_lens``); ``k``
    scales for a block of right-hand sides.  ``msgs`` point-to-point
    messages (``DistPJDS.comm_msgs_per_device``) each pay the calibrated
    fixed cost ``msg_overhead_s[halo]``, and the link rate is scaled by
    ``link_bw_scale``.  Without a calibration (or with ``msgs=0``) the
    term is bytes over bandwidth alone."""
    if calibration == "default":
        calibration = _CALIBRATION
    scale = calibration.link_bw_scale if calibration is not None else 1.0
    fixed = (calibration.msg_overhead_s.get(halo, 0.0)
             if calibration is not None else 0.0)
    return value_bytes * k * halo_elems / (link_bw * scale) + msgs * fixed


def predicted_dist_spmv_seconds(dist, halo: str = "gathered",
                                mode: str = "overlap", *, k: int = 1,
                                value_bytes: int = 4, index_bytes: int = 4,
                                spec: TPUSpec = H100,
                                calibration="default") -> float:
    """Per-device time estimate of one distributed spMVM over a
    ``core.dist_spmv.DistPJDS`` partition (duck-typed).

    compute: the local and remote operands' streams through the
    single-device model (:func:`predicted_spmv_seconds`) at their
    stacked extent; comm: :func:`t_link_gathered` over the measured
    bytes and message count.  Modes ``vector`` / ``naive`` add the
    exchange to the compute; ``overlap`` / ``pipeline`` hide it behind
    the local operand (paper §3.1), so only the part that outlasts it is
    charged.  ``dist_operator(halo="auto")`` decides by this
    (:func:`choose_halo`)."""
    if calibration == "default":
        calibration = _CALIBRATION
    blk_rows = dist.n_blocks * dist.b_r

    def _t(val_arr):
        elems = int(val_arr.shape[1]) * int(val_arr.shape[2])
        if elems == 0:
            return 0.0
        return k * predicted_spmv_seconds(
            elems, blk_rows, elems / blk_rows, spec=spec,
            value_bytes=value_bytes, index_bytes=index_bytes,
            fmt="pjds", calibration=calibration)

    t_loc = _t(dist.loc_val)
    t_rem = _t(dist.rem_val)
    elems = dist.comm_bytes_per_device(value_bytes=1, k=k, halo=halo)
    t_comm = t_link_gathered(elems, spec.ici_bw, value_bytes, 1,
                             msgs=dist.comm_msgs_per_device(halo),
                             halo=halo, calibration=calibration)
    if mode in ("overlap", "pipeline"):
        return max(t_loc, t_comm) + t_rem
    return t_loc + t_rem + t_comm


def choose_halo(dist, mode: str = "overlap", *, k: int = 1,
                value_bytes: int = 4, spec: TPUSpec = H100,
                calibration="default") -> str:
    """The gathered-vs-full exchange decision (``dist_operator(halo=
    "auto")``): price both flavours with
    :func:`predicted_dist_spmv_seconds` and return the cheaper; ties
    (nothing crosses the link either way) go to ``"gathered"``."""
    t_g = predicted_dist_spmv_seconds(dist, "gathered", mode, k=k,
                                      value_bytes=value_bytes, spec=spec,
                                      calibration=calibration)
    t_f = predicted_dist_spmv_seconds(dist, "full", mode, k=k,
                                      value_bytes=value_bytes, spec=spec,
                                      calibration=calibration)
    return "full" if t_f < t_g else "gathered"


def n_nzr_upper_for_link_penalty(dev_bw: float, link_bw: float,
                                 alpha: float) -> float:
    """Paper Eq. (3): below this N_nzr the link transfer costs >= 50% extra
    (T_MVM <= T_link) -> accelerator not worthwhile."""
    return 2.0 * (dev_bw / link_bw - 1.0) / (alpha + 1.5)


def n_nzr_lower_for_link_penalty(dev_bw: float, link_bw: float,
                                 alpha: float) -> float:
    """Paper Eq. (4): above this N_nzr the link penalty is < 10%
    (T_MVM >= 10*T_link)."""
    return (20.0 * dev_bw / link_bw - 2.0) / (alpha + 1.5)


# -------------------------------------------------------------- byte model
def spmvm_flops(nnz: int) -> int:
    """2 flops (multiply + add) per stored non-zero."""
    return 2 * nnz


def spmvm_bytes(stored_elements: int, n_rows: int, alpha: float,
                n_nzr: float, value_bytes: int = 8,
                index_bytes: int = 4, x_tiles: int = 1,
                n_row_blocks: int = 1,
                vec_bytes: int | None = None) -> float:
    """Minimum device-memory traffic of one spMVM in a given format:
    matrix values + indices stream once; RHS traffic scales with alpha;
    LHS written once.  ``value_bytes``/``index_bytes`` are the STORED
    widths, ``vec_bytes`` the (uncompressed, >= f32) vector width.
    ``x_tiles > 1`` prices the reference's column-blocked-x grid."""
    if vec_bytes is None:
        vec_bytes = max(4, value_bytes)
    if x_tiles > 1:
        rhs = n_row_blocks * n_rows * vec_bytes        # x re-read per block
    else:
        rhs = alpha * n_nzr * n_rows * vec_bytes       # resident: alpha term
    return (
        x_tiles * stored_elements * (value_bytes + index_bytes)
        + rhs
        + 2 * n_rows * vec_bytes
    )


def perm_traffic_bytes(n_rows: int, value_bytes: int = 4,
                       index_bytes: int = 4,
                       window_local: bool = False) -> float:
    """Extra traffic of undoing a row sort OUTSIDE the kernel: the
    permutation index stream plus a read+write pass over y.  A
    window-local (SELL-C-sigma) unpermute happens inside the kernel and
    costs nothing."""
    if window_local:
        return 0.0
    return float(n_rows) * (2 * value_bytes + index_bytes)


# CMRS stores one extra byte per slot: the int8 row-in-strip stream.
CMRS_RIS_BYTES = 1


def cmrs_reduce_seconds(stored_elements: int, b_r: int,
                        spec: TPUSpec = H100) -> float:
    """Compute term of the CMRS in-kernel segment reduction as the
    reference prices it: ``2 * b_r`` f32 flops per stored slot."""
    return 2.0 * float(stored_elements) * float(b_r) / spec.peak_flops_f32


def predicted_spmv_seconds(stored_elements: int, n_rows: int, n_nzr: float,
                           perm_bytes: float = 0.0,
                           irregular_factor: float = 1.0,
                           spec: TPUSpec = H100,
                           value_bytes: int = 4,
                           index_bytes: int = 4,
                           x_tiles: int = 1,
                           n_row_blocks: int = 1,
                           vec_bytes: int | None = None,
                           fmt: str | None = None,
                           calibration="default") -> float:
    """Memory-bound time estimate of one spMVM in a candidate format --
    the quantity ``kernels.ops.select_format`` minimises -- with the
    alpha -> 1/N_nzr RHS-reuse limit and an optional calibration."""
    n_nzr = max(n_nzr, 1e-9)
    alpha = 1.0 / n_nzr
    b = spmvm_bytes(stored_elements, n_rows, alpha, n_nzr,
                    value_bytes, index_bytes, x_tiles, n_row_blocks,
                    vec_bytes)
    t = (b * irregular_factor + perm_bytes) / spec.hbm_bw
    if calibration == "default":
        calibration = _CALIBRATION
    if calibration is not None:
        t = t / calibration.bw_scale
        if fmt is not None:
            t += calibration.overhead_s.get(fmt, 0.0)
    return max(t, 0.0)


# ------------------------------------------------- solver-iteration model
# spMV applications per Krylov iteration.
SOLVER_SPMV_COUNT: Mapping[str, int] = {
    "cg": 1,
    "bicgstab": 2,
    "block_cg": 1,
}

# Carrier-vector passes per iteration beyond the spMV's own rhs/lhs
# traffic (each pass = n_rows * vec_bytes read OR written).
SOLVER_VECTOR_PASSES: Mapping[str, Mapping[str, int]] = {
    "cg": {"composed": 12, "fused": 7},
    "bicgstab": {"composed": 22, "fused": 14},
    "block_cg": {"composed": 12, "fused": 12},
}


def solver_iteration_bytes(stored_elements: int, n_rows: int, n_nzr: float,
                           *, method: str = "cg",
                           strategy: str = "composed",
                           value_bytes: int = 4, index_bytes: int = 4,
                           vec_bytes: int = 4, n_vec: int = 1,
                           x_tiles: int = 1,
                           n_row_blocks: int = 1) -> float:
    """Minimum device-memory traffic of ONE solver iteration: the
    method's spMV streams plus the carrier-vector passes around them."""
    spmv_count = SOLVER_SPMV_COUNT[method]
    passes = SOLVER_VECTOR_PASSES[method][strategy]
    alpha = 1.0 / max(n_nzr, 1e-9)
    spmv = spmvm_bytes(stored_elements, n_rows, alpha, n_nzr,
                       value_bytes, index_bytes, x_tiles, n_row_blocks,
                       vec_bytes)
    return spmv_count * spmv + passes * n_vec * float(n_rows) * vec_bytes


def predicted_iteration_seconds(stored_elements: int, n_rows: int,
                                n_nzr: float, *, method: str = "cg",
                                strategy: str = "composed",
                                spec: TPUSpec = H100,
                                value_bytes: int = 4, index_bytes: int = 4,
                                vec_bytes: int = 4, n_vec: int = 1,
                                x_tiles: int = 1, n_row_blocks: int = 1,
                                fmt: str | None = None,
                                calibration="default") -> float:
    """Memory-bound time of one solver iteration:
    :func:`solver_iteration_bytes` over ``spec.hbm_bw`` (the H100's 3.35
    TB/s by default), with :func:`predicted_spmv_seconds`' calibration
    semantics and the per-format overhead charged once per spMV
    application."""
    b = solver_iteration_bytes(
        stored_elements, n_rows, n_nzr, method=method, strategy=strategy,
        value_bytes=value_bytes, index_bytes=index_bytes,
        vec_bytes=vec_bytes, n_vec=n_vec, x_tiles=x_tiles,
        n_row_blocks=n_row_blocks)
    t = b / spec.hbm_bw
    if calibration == "default":
        calibration = _CALIBRATION
    if calibration is not None:
        t = t / calibration.bw_scale
        if fmt is not None:
            t += SOLVER_SPMV_COUNT[method] * calibration.overhead_s.get(
                fmt, 0.0)
    return max(t, 0.0)


# -------------------------------------------------------------- roofline
@dataclasses.dataclass
class RooflineReport:
    compute_s: float
    memory_s: float
    collective_s: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def fraction_of_roofline(self, achieved_s: float) -> float:
        """How close a measured step time is to the roofline bound."""
        return self.bound_s / achieved_s if achieved_s > 0 else 0.0


def roofline_terms(hlo_flops: float, hlo_bytes: float,
                   collective_bytes: float, chips: int,
                   spec: TPUSpec = H100,
                   flops_rate: float | None = None) -> RooflineReport:
    """Three-term roofline of a step:

    compute    = flops / (chips * peak)
    memory     = bytes / (chips * HBM rate)
    collective = collective_bytes / (chips * link rate)

    With the default :data:`H100` spec (data sheet, 700 W: 989 TFLOP/s
    dense bf16, 3.35 TB/s HBM3, NVLink 450 GB/s each way) the
    collective term divides by NVLink's per-direction rate.  The counts
    are global; the dry run's record (``launch/dryrun.py``) gives a
    rank's flops, its unfused bytes (``cost["bytes"]``) and its
    collective bytes, so price a rank with ``chips=1``.
    ``flops_rate`` overrides the spec's peak (e.g. ``peak_flops_f32``).
    """
    rate = flops_rate if flops_rate is not None else spec.peak_flops
    return RooflineReport(
        compute_s=hlo_flops / (chips * rate),
        memory_s=hlo_bytes / (chips * spec.hbm_bw),
        collective_s=collective_bytes / (chips * spec.ici_bw),
        chips=chips,
    )
