"""The port's roofline and solver-iteration model against the
reference's: ``spmvm_flops``, ``predicted_iteration_seconds``,
``RooflineReport`` and ``roofline_terms``.

With ``spec=TPU_V5E`` every number equals the reference's within 1e-12
relative, over a grid of formats, methods, strategies, right-hand-side
counts, x tiles and calibrations (none, the installed one, an explicit
one).  The port's default spec is the H100; its defaults are checked
against the data sheet's rates by hand.
"""
import itertools

import pytest

from repro.core import perf_model as PM
from repro_torch.core import perf_model as TPM

REL = 1e-12


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-300), (a, b)


def _cal(pm, kind):
    if kind == "none":
        return None
    if kind == "default":
        return "default"
    return pm.Calibration(bw_scale=0.61, overhead_s={"sell": 3e-6,
                                                     "pjds": 7e-6,
                                                     "cmrs": 1e-5})


@pytest.fixture
def installed():
    """A calibration installed in both packages for ``"default"``."""
    PM.set_calibration(PM.Calibration(bw_scale=0.8,
                                      overhead_s={"sell": 2e-6}))
    TPM.set_calibration(TPM.Calibration(bw_scale=0.8,
                                        overhead_s={"sell": 2e-6}))
    yield
    PM.clear_calibration()
    TPM.clear_calibration()


@pytest.mark.parametrize("nnz", [0, 1, 7, 22_600_000, 2 ** 40])
def test_spmvm_flops(nnz):
    assert TPM.spmvm_flops(nnz) == PM.spmvm_flops(nnz)


_GRID = list(itertools.product(
    ["sell", "pjds", "cmrs", None],                 # fmt
    [("cg", "composed"), ("cg", "fused"), ("bicgstab", "composed"),
     ("bicgstab", "fused"), ("block_cg", "composed")],
    [1, 4],                                         # n_vec
    [(1, 1), (3, 64)],                              # x_tiles, n_row_blocks
    ["none", "default", "explicit"]))


@pytest.mark.parametrize("fmt,ms,n_vec,tiles,cal", _GRID)
def test_predicted_iteration_seconds_matches_reference(installed, fmt, ms,
                                                       n_vec, tiles, cal):
    method, strategy = ms
    kw = dict(method=method, strategy=strategy, n_vec=n_vec,
              x_tiles=tiles[0], n_row_blocks=tiles[1], fmt=fmt,
              value_bytes=2 if n_vec == 4 else 4,
              index_bytes=2 if tiles[0] == 3 else 4)
    for stored, rows, nzr in [(8_200_000, 1_000_000, 7.3),
                              (65_536, 6_800, 6.66), (0, 128, 0.0)]:
        want = PM.predicted_iteration_seconds(
            stored, rows, nzr, spec=PM.TPU_V5E,
            calibration=_cal(PM, cal), **kw)
        got = TPM.predicted_iteration_seconds(
            stored, rows, nzr, spec=TPM.TPU_V5E,
            calibration=_cal(TPM, cal), **kw)
        _close(got, want)


@pytest.mark.parametrize("flops,bytes_,coll,chips,rate", [
    (1.75e15, 3.2e12, 6.2e11, 1, None),
    (3.82e14, 1e9, 0.0, 256, None),
    (1e9, 5e12, 1e6, 4, 197e12 / 4),
    (0.0, 0.0, 0.0, 1, None),
    (4.0e12, 2.0e12, 9.0e12, 8, 1e12),
])
def test_roofline_terms_match_reference(flops, bytes_, coll, chips, rate):
    want = PM.roofline_terms(flops, bytes_, coll, chips, spec=PM.TPU_V5E,
                             flops_rate=rate)
    got = TPM.roofline_terms(flops, bytes_, coll, chips, spec=TPM.TPU_V5E,
                             flops_rate=rate)
    assert isinstance(got, TPM.RooflineReport)
    for k in ("compute_s", "memory_s", "collective_s", "bound_s"):
        _close(getattr(got, k), getattr(want, k))
    assert got.chips == want.chips
    assert got.dominant == want.dominant
    for achieved in (0.0, 1e-3, 2.5):
        _close(got.fraction_of_roofline(achieved),
               want.fraction_of_roofline(achieved))


def test_roofline_report_fields_match_reference():
    import dataclasses
    assert [f.name for f in dataclasses.fields(TPM.RooflineReport)] == \
        [f.name for f in dataclasses.fields(PM.RooflineReport)]
    r = TPM.RooflineReport(1.0, 2.0, 2.0, 1)
    assert r.dominant == PM.RooflineReport(1.0, 2.0, 2.0, 1).dominant


def test_h100_defaults_by_hand():
    """The port prices against the H100 by default: 989 TFLOP/s dense
    bf16, 3.35 TB/s HBM3, NVLink 450 GB/s each way."""
    r = TPM.roofline_terms(989e12, 3.35e12, 450e9, 1)
    _close(r.compute_s, 1.0)
    _close(r.memory_s, 1.0)
    _close(r.collective_s, 1.0)
    r = TPM.roofline_terms(2e15, 1e12, 1.8e12, 4)
    _close(r.compute_s, 2e15 / (4 * 989e12))
    _close(r.memory_s, 1e12 / (4 * 3.35e12))
    _close(r.collective_s, 1.8e12 / (4 * 450e9))
    assert r.dominant == "collective"
    r = TPM.roofline_terms(67e12, 0, 0, 1,
                           flops_rate=TPM.H100.peak_flops_f32)
    _close(r.compute_s, 1.0)
    # one CG iteration on sAMG's size: the byte count over 3.35 TB/s
    b = TPM.solver_iteration_bytes(23_000_000, 3_400_000, 6.65,
                                   method="cg", strategy="fused")
    _close(TPM.predicted_iteration_seconds(23_000_000, 3_400_000, 6.65,
                                           method="cg", strategy="fused",
                                           calibration=None),
           b / 3.35e12)
    # the calibration's overhead is charged once per spMV (BiCGStab: 2)
    cal = TPM.Calibration(bw_scale=0.5, overhead_s={"sell": 1e-5})
    b = TPM.solver_iteration_bytes(1000, 100, 10.0, method="bicgstab")
    _close(TPM.predicted_iteration_seconds(1000, 100, 10.0,
                                           method="bicgstab", fmt="sell",
                                           calibration=cal),
           b / 3.35e12 / 0.5 + 2e-5)
