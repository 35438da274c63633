"""The port's ``eigensolver`` and ``train_lm`` examples on the CPU
(``test_torch_examples.py`` has the other four).

``eigensolver`` runs at the reference's size (HMEp at scale 0.001, 6200
rows): its extremal Ritz values within 1e-4 of ``numpy.linalg.eigvalsh``
on the dense matrix (Lanczos m = 100 in f32), and the polished value
within 1e-4 too, as the reference reaches them.  ``train_lm`` trains the
reference's ~100 M-parameter model for 3 steps at batch 2 x 64 (its
size, cut in steps, batch and sequence) into a checkpoint directory,
then a second run resumes from it: finite losses, the resume's first
step the fourth.
"""
import math

import pytest

EIG_TOL = 1e-4


@pytest.fixture(scope="module")
def eig():
    from repro_torch.examples import eigensolver
    return eigensolver.main(["--device", "cpu"])


def test_eigensolver_ritz_values_match_dense(eig):
    assert eig["shape"] == (6200, 6200)
    assert eig["err_lanczos_max"] <= EIG_TOL
    assert eig["err_lanczos_min"] <= EIG_TOL


def test_eigensolver_polish(eig):
    assert eig["solve_status"] == "converged"
    assert eig["err_polished"] <= EIG_TOL


def test_eigensolver_storage_matches_reference(eig):
    import numpy as np
    from repro.core import formats as F
    from repro.core import matrices as M
    d = F.csr_to_dense(M.hmep(scale=0.001))
    h = F.csr_from_dense(((d + d.T) / 2).astype(np.float32))
    assert eig["nnz"] == h.nnz
    assert eig["data_reduction"] == F.data_reduction_vs_ellpack(h)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from repro_torch.examples import train_lm
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    argv = ["--device", "cpu", "--batch", "2", "--seq", "64",
            "--ckpt", ckpt]
    first = train_lm.main(argv + ["--steps", "3"])
    second = train_lm.main(argv + ["--steps", "4"])
    return first, second


def test_train_lm_trains(trained):
    first, _ = trained
    assert first["arch"] == "qwen2.5-14b-100m"
    assert 50e6 < first["n_params"] < 150e6
    assert len(first["losses"]) == 3
    assert all(math.isfinite(x) for x in first["losses"])
    assert first["losses"][0] < 11.0


def test_train_lm_resumes(trained):
    first, second = trained
    assert len(second["losses"]) == 1
    assert math.isfinite(second["losses"][0])
    assert second["n_params"] == first["n_params"]


def test_hundred_m_matches_reference():
    import dataclasses
    import importlib.util
    import pathlib
    from repro_torch.examples import train_lm
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "_ref_train_lm", root / "examples" / "train_lm.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for arch in ("qwen2.5-14b", "deepseek-moe-16b", "falcon-mamba-7b",
                 "seamless-m4t-medium", "llava-next-mistral-7b"):
        assert dataclasses.asdict(train_lm.hundred_m(arch)) == \
            dataclasses.asdict(ref.hundred_m(arch)), arch
