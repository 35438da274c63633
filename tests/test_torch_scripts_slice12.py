"""Rehearsal on the CPU of ``chip_smoke.slice12_phases``: the six
examples through ``main`` at small sizes (the card runs the
reference's), and ``dryrun:peak`` on a smoke config at four layers (its
flops, bytes and peak also carried from the 1- to 3-layer steps), with
a host-clock harness whose counts map the plain versions the CPU runs
to the kernels they stand for on the card.  Every phase's checks pass; the examples
reach the plain versions of K1, K5 and K7.  In a subprocess: the
distributed example's ranks are threads of it.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

_SLICE12 = textwrap.dedent("""
    import dataclasses, json, sys, types
    sys.path.insert(0, sys.argv[1])
    import torch
    import chip_smoke as CS
    from repro_torch import configs as TCFG
    from repro_torch.kernels import ref as R

    STANDS_FOR = {"pjds_spmv": [R.pjds_matvec_ref],
                  "pjds_spmm": [R.pjds_matmat_ref],
                  "transpose_spmv": [R.blocked_rmatvec_ref,
                                     R.cmrs_rmatvec_ref, R.ell_rmatvec_ref],
                  "cmrs_spmv": [R.cmrs_matvec_ref]}

    def counts():
        return ({k: sum(f.calls for f in fs)
                 for k, fs in STANDS_FOR.items()}, {})

    def require(ok, what):
        if not ok:
            raise AssertionError(what)
    rows = {}
    out = CS.slice12_phases(types.SimpleNamespace(
        dev=torch.device("cpu"), seed=0, require=require,
        emit=lambda phase, **f: rows.__setitem__(phase, f),
        counts=counts, reset_counts=R.reset_calls,
        plain_free=lambda calls, phase: None,
        cfgs={"peak": dataclasses.replace(TCFG.smoke("minicpm-2b"),
                                          n_layers=4)},
        example_args={"quickstart": [],
                      "eigensolver": ["--scale", "0.0002"],
                      "cg_solver": ["--ranks", "2", "--side", "24"],
                      "serve_solver": [], "serve_lm": [],
                      "train_lm": ["--steps", "3", "--batch", "1",
                                   "--seq", "32"]},
        batch=2, seq=32))
    print("OUT " + json.dumps({"rows": rows, "launches": out["launches"]},
                              default=str))
""")


def test_slice12_phases_rehearse_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _SLICE12, str(ROOT)],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("OUT ")][-1]
    out = json.loads(line[4:])
    rows = out["rows"]
    for name in ("quickstart", "eigensolver", "cg_solver", "serve_solver",
                 "serve_lm", "train_lm"):
        row = rows[f"examples:{name}"]
        assert row["printed"], name
        assert row["seconds"] > 0
    for k in ("pjds_spmv", "pjds_spmm", "transpose_spmv"):
        assert out["launches"][k] >= 1, k
    peak = rows["dryrun:peak"]
    assert peak["recorder_peak_bytes"] > peak["recorder_held_bytes"] > 0
    assert peak["recorder_bytes"] > 0 and peak["recorder_flops"] > 0
    assert peak["ratio"] is None and peak["ratio_over_phase_start"] is None
    # the dry run's plan at 1 and 2 layers (3 for the peak), carried to 4
    assert peak["traced_layers"] == [1, 2, 3]
    assert peak["n_layers"] == 4
    # within half of what one layer adds to the peak
    assert peak["layer_peak_growth_bytes"] > 0
    assert peak["extrapolated_peak_err_layers"] <= 0.5
