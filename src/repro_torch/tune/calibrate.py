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
Install the result with ``perf_model.set_calibration``.  The link
calibration of the distributed exchange (``fit_link_calibration``) is
not ported yet (ROADMAP.md, item 1.20).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import perf_model as PM

__all__ = ["fit_calibration", "model_error"]

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
