"""The kernels-bench adapter (``tune.rows_from_bench_kernels``,
``tune.fit_from_bench_kernels``) against the reference's: both packages
read one synthetic ``BENCH_kernels.json`` and must give equal rows and
an equal ``Calibration`` (the fit is the same host arithmetic: exact
equality).  A file with no usable row raises in both.
"""
import json

import numpy as np
import pytest

from repro import tune as JT
from repro_torch import tune as TT


def _bench(path, rows):
    path.write_text(json.dumps({"suite": "kernels", "rows": rows}))
    return path


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for fmt, scale, over in [("sell", 0.7, 2e-6), ("pjds", 0.7, 5e-6),
                             ("ell", 0.7, 1e-6), ("cmrs", 0.7, 9e-6)]:
        for variant in ("f32/int32", "bf16/int16", "f32/int16"):
            pred = float(rng.uniform(1e-5, 1e-3))
            rows.append({"kind": "bytes_per_nnz", "fmt": fmt,
                         "variant": variant, "predicted_s": pred,
                         "measured_ref_s": pred / scale + over
                         * float(rng.uniform(0.8, 1.2))})
    # rows the adapter must skip: other kinds, unmeasured, unpredicted
    rows += [{"kind": "spmv_time", "fmt": "sell", "predicted_s": 1e-4,
              "measured_ref_s": 2e-4},
             {"kind": "bytes_per_nnz", "fmt": "sell", "predicted_s": 1e-4,
              "measured_ref_s": 0},
             {"kind": "bytes_per_nnz", "fmt": "pjds", "predicted_s": 0,
              "measured_ref_s": 3e-4},
             {"kind": "bytes_per_nnz", "fmt": "ell"}]
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_and_fit_match_reference(tmp_path, seed):
    path = _bench(tmp_path / "BENCH_kernels.json", _rows(seed))
    want_rows = JT.rows_from_bench_kernels(path)
    got_rows = TT.rows_from_bench_kernels(path)
    assert got_rows == want_rows
    assert len(got_rows) == 12
    want = JT.fit_from_bench_kernels(path)
    got = TT.fit_from_bench_kernels(path)
    assert got.bw_scale == want.bw_scale
    assert dict(got.overhead_s) == dict(want.overhead_s)
    assert got.source == want.source == f"bench_kernels:{path}"
    assert got.link_bw_scale == want.link_bw_scale
    assert dict(got.msg_overhead_s) == dict(want.msg_overhead_s)
    named = TT.fit_from_bench_kernels(str(path), source="mine")
    assert named.source == "mine"
    assert named.bw_scale == want.bw_scale


@pytest.mark.parametrize("rows", [[], [{"kind": "spmv_time", "fmt": "sell",
                                        "predicted_s": 1.0,
                                        "measured_ref_s": 1.0}]])
def test_no_usable_row_raises_in_both(tmp_path, rows):
    path = _bench(tmp_path / "BENCH_kernels.json", rows)
    assert TT.rows_from_bench_kernels(path) == []
    with pytest.raises(ValueError, match="no usable roofline rows"):
        JT.fit_from_bench_kernels(path)
    with pytest.raises(ValueError, match="no usable roofline rows"):
        TT.fit_from_bench_kernels(path)


def test_a_file_without_rows_raises_in_both(tmp_path):
    path = tmp_path / "BENCH_kernels.json"
    path.write_text(json.dumps({"suite": "kernels"}))
    with pytest.raises(ValueError):
        JT.fit_from_bench_kernels(path)
    with pytest.raises(ValueError):
        TT.fit_from_bench_kernels(path)
