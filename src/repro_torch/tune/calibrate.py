"""Calibration: fit the perf model's free terms from measured rows.

Port of the single-device half of ``repro/tune/calibrate.py``.  The
structural byte model (``perf_model.spmvm_bytes``) is exact about WHAT
streams; what it guesses at is the rate and the per-launch cost each
format pays outside the streaming loop.  Both are fit from rows

    { "fmt": ..., "model_s": <uncalibrated predicted seconds>,
      "measured_s": <median measured seconds> }

(what ``autotune`` records) as ``measured ~ model_s / bw_scale +
overhead_s[fmt]`` by weighted least squares in RELATIVE error (weights
1/measured), by coordinate descent whose every step is an exact 1-D
minimiser, so :func:`model_error` never rises from the fit's start.
Install the result with ``perf_model.set_calibration``.

The link half (:func:`fit_link_calibration`, :func:`link_model_error`)
fits the distributed exchange's free terms -- a fixed cost per message
for each halo flavour and the effective link rate -- from the rows of
``tune_partition``'s communication sweep.  It prices with the H100 by
default (``spec=perf_model.H100``; the reference's default is the TPU
v5e, and with ``spec=perf_model.TPU_V5E`` the fit is the reference's).
On ranks that share one card (``ThreadComm``) no message crosses a
link, so such a fit describes the threads' hand-over, not a link.

The bench adapter (:func:`rows_from_bench_kernels`,
:func:`fit_from_bench_kernels`) reads a kernels bench file's
``bytes_per_nnz`` rows -- the reference's schema: ``kind``, ``fmt``,
``predicted_s``, ``measured_ref_s`` -- and fits them as above.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import perf_model as PM

__all__ = ["fit_calibration", "fit_link_calibration", "model_error",
           "link_model_error", "rows_from_bench_kernels",
           "fit_from_bench_kernels"]

_FIT_SWEEPS = 3      # coordinate-descent passes (each pass is monotone)


def _predict(rows, calibration: Optional[PM.Calibration]) -> np.ndarray:
    model = np.asarray([r["model_s"] for r in rows], dtype=np.float64)
    if calibration is None:
        return model
    off = np.asarray([calibration.overhead_s.get(r["fmt"], 0.0)
                      for r in rows], dtype=np.float64)
    return model / calibration.bw_scale + off


def model_error(rows: Sequence[dict],
                calibration: Optional[PM.Calibration] = None) -> float:
    """Root-mean-square RELATIVE error of the (optionally calibrated)
    prediction against the measured rows -- the quantity
    :func:`fit_calibration` minimises."""
    rows = list(rows)
    if not rows:
        raise ValueError("no rows")
    meas = np.asarray([r["measured_s"] for r in rows], dtype=np.float64)
    if np.any(meas <= 0):
        raise ValueError("measured_s must be positive")
    rel = (_predict(rows, calibration) - meas) / meas
    return float(np.sqrt(np.mean(rel ** 2)))


def fit_calibration(rows: Sequence[dict], source: str = "") -> PM.Calibration:
    """Fit ``(bw_scale, overhead_s)`` to measured rows (see the module
    docstring).  Raises on empty or non-positive input; a single row
    still fits (scale only)."""
    rows = list(rows)
    if not rows:
        raise ValueError("cannot calibrate from zero rows")
    t = np.asarray([r["measured_s"] for r in rows], dtype=np.float64)
    m = np.asarray([r["model_s"] for r in rows], dtype=np.float64)
    if np.any(t <= 0) or np.any(m <= 0):
        raise ValueError("model_s and measured_s must be positive")
    fmts = sorted({r["fmt"] for r in rows})
    fmt_of = np.asarray([fmts.index(r["fmt"]) for r in rows])
    w2 = 1.0 / t ** 2                       # relative-error weights

    # measured ~ a * model + c[fmt], a > 0, c >= 0.
    a = float(np.sum(w2 * t * m) / np.sum(w2 * m * m))
    c = np.zeros(len(fmts))
    for _ in range(_FIT_SWEEPS):
        resid = t - a * m
        for i in range(len(fmts)):
            sel = fmt_of == i
            c[i] = max(0.0, float(np.sum(w2[sel] * resid[sel])
                                  / np.sum(w2[sel])))
        a_new = float(np.sum(w2 * (t - c[fmt_of]) * m)
                      / np.sum(w2 * m * m))
        if a_new > 0:
            a = a_new
    return PM.Calibration(
        bw_scale=1.0 / a,
        overhead_s={f: float(ci) for f, ci in zip(fmts, c) if ci > 0.0},
        source=source,
    )


# --------------------------------------------------------------------------
# Link calibration (the distributed exchange's free terms)
# --------------------------------------------------------------------------
def _link_comm_s(rows, calibration, spec) -> np.ndarray:
    """Priced comm seconds of each row under ``calibration`` (None =
    data-sheet: pure bytes over the spec link bandwidth)."""
    return np.asarray([
        PM.t_link_gathered(
            float(r["bytes"]), spec.ici_bw, 1, 1, msgs=int(r["msgs"]),
            halo=r["halo"], calibration=calibration)
        for r in rows], dtype=np.float64)


def _best_bases(rows, comm_s: np.ndarray) -> np.ndarray:
    """Optimal per-group compute base given the comm model (exact 1-D
    weighted-relative-LSQ step, clamped >= 0)."""
    t = np.asarray([r["measured_s"] for r in rows], dtype=np.float64)
    groups = sorted({r["group"] for r in rows})
    g_of = np.asarray([groups.index(r["group"]) for r in rows])
    w2 = 1.0 / t ** 2
    resid = t - comm_s
    return np.asarray([
        max(0.0, float(np.sum(w2[g_of == gi] * resid[g_of == gi])
                       / np.sum(w2[g_of == gi])))
        for gi in range(len(groups))])[g_of]


def link_model_error(rows: Sequence[dict],
                     calibration: Optional[PM.Calibration] = None,
                     spec: PM.TPUSpec = PM.H100) -> float:
    """RMS relative error of ``measured ~ base[group] + comm(calibration)``
    over link rows, with the per-group compute base chosen optimally for
    the given comm model -- so the number isolates how well the COMM
    terms fit, which is what :func:`fit_link_calibration` minimises."""
    rows = list(rows)
    if not rows:
        raise ValueError("no rows")
    t = np.asarray([r["measured_s"] for r in rows], dtype=np.float64)
    if np.any(t <= 0):
        raise ValueError("measured_s must be positive")
    comm = _link_comm_s(rows, calibration, spec)
    rel = (_best_bases(rows, comm) + comm - t) / t
    return float(np.sqrt(np.mean(rel ** 2)))


def fit_link_calibration(rows: Sequence[dict],
                         spec: PM.TPUSpec = PM.H100,
                         base: Optional[PM.Calibration] = None,
                         source: str = "") -> PM.Calibration:
    """Fit the LINK half of the calibration from measured distributed
    spMVM rows

        { "group": <matrix id>, "halo": "gathered" | "full",
          "msgs": <messages/rank>, "bytes": <wire bytes/rank>,
          "measured_s": <median seconds> }

    as ``measured ~ base[group] + msgs * c[halo] + bytes / bw_eff`` by
    weighted-relative-error coordinate descent (the discipline of
    :func:`fit_calibration`): ``base`` absorbs the compute time shared
    by both exchange flavours on one matrix, ``c[halo]`` is the
    per-MESSAGE fixed cost, and ``bw_eff`` the effective link rate.  All
    three are clamped to their physical signs.

    Returns a :class:`perf_model.Calibration` carrying the fitted
    ``link_bw_scale`` / ``msg_overhead_s`` on top of ``base`` (or the
    installed calibration, or data-sheet defaults), ready for
    ``perf_model.set_calibration`` -- ``perf_model.choose_halo`` and
    ``dist_operator(halo="auto")`` then decide the gathered-vs-full
    crossover from measurements.
    """
    rows = list(rows)
    if not rows:
        raise ValueError("cannot calibrate from zero rows")
    t = np.asarray([r["measured_s"] for r in rows], dtype=np.float64)
    if np.any(t <= 0):
        raise ValueError("measured_s must be positive")
    msgs = np.asarray([r["msgs"] for r in rows], dtype=np.float64)
    byts = np.asarray([r["bytes"] for r in rows], dtype=np.float64)
    groups = sorted({r["group"] for r in rows})
    halos = sorted({r["halo"] for r in rows})
    g_of = np.asarray([groups.index(r["group"]) for r in rows])
    h_of = np.asarray([halos.index(r["halo"]) for r in rows])
    w2 = 1.0 / t ** 2

    bse = np.asarray([float(np.min(t[g_of == gi]))
                      for gi in range(len(groups))])
    c = np.zeros(len(halos))
    inv_bw = 0.0                        # seconds per wire byte
    for _ in range(16 * _FIT_SWEEPS):
        resid = t - msgs * c[h_of] - byts * inv_bw
        for gi in range(len(groups)):
            sel = g_of == gi
            bse[gi] = max(0.0, float(np.sum(w2[sel] * resid[sel])
                                     / np.sum(w2[sel])))
        resid = t - bse[g_of] - byts * inv_bw
        for hi in range(len(halos)):
            sel = h_of == hi
            den = float(np.sum(w2[sel] * msgs[sel] ** 2))
            c[hi] = (max(0.0, float(np.sum(w2[sel] * resid[sel] * msgs[sel]))
                         / den) if den > 0 else 0.0)
        resid = t - bse[g_of] - msgs * c[h_of]
        den = float(np.sum(w2 * byts ** 2))
        inv_bw = (max(0.0, float(np.sum(w2 * resid * byts)) / den)
                  if den > 0 else 0.0)

    link_scale = (1.0 / (inv_bw * spec.ici_bw)) if inv_bw > 0 else 1.0
    if base is None:
        base = PM.get_calibration()
    return PM.Calibration(
        bw_scale=base.bw_scale if base else 1.0,
        overhead_s=dict(base.overhead_s) if base else {},
        source=source or (base.source if base else ""),
        link_bw_scale=link_scale,
        msg_overhead_s={h: float(ci) for h, ci in zip(halos, c) if ci > 0.0},
    )


# ------------------------------------------------- kernels bench adapter
def rows_from_bench_kernels(path) -> list[dict]:
    """Calibration rows from a kernels bench file (``BENCH_kernels.json``):
    each ``bytes_per_nnz`` row with a positive uncalibrated prediction
    (``predicted_s``) and measured time (``measured_ref_s``) becomes
    ``{"fmt", "model_s", "measured_s"}``."""
    payload = json.loads(pathlib.Path(path).read_text())
    out = []
    for r in payload.get("rows", []):
        if r.get("kind") != "bytes_per_nnz":
            continue
        if r.get("predicted_s", 0) > 0 and r.get("measured_ref_s", 0) > 0:
            out.append(dict(fmt=r["fmt"], model_s=float(r["predicted_s"]),
                            measured_s=float(r["measured_ref_s"])))
    return out


def fit_from_bench_kernels(path, source: Optional[str] = None
                           ) -> PM.Calibration:
    """:func:`fit_calibration` over :func:`rows_from_bench_kernels`;
    raises ``ValueError`` when the file has no usable row."""
    rows = rows_from_bench_kernels(path)
    if not rows:
        raise ValueError(f"no usable roofline rows in {path}")
    return fit_calibration(rows, source=source or f"bench_kernels:{path}")
