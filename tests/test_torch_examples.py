"""The port's examples (``repro_torch.examples``) on the CPU:
``quickstart``, ``cg_solver``, ``serve_solver`` and ``serve_lm`` (the
heavier ``eigensolver`` and ``train_lm`` are in
``test_torch_examples_heavy.py``).

Each runs through ``main([..., "--device", "cpu"])`` and is held to the
reference's numbers where the two compute the same thing (``quickstart``'s
stored elements and data reduction, from the reference's functions on
the reference's matrix: exact), and otherwise to its own checks:
products at f32 round-off (1e-5 of the largest entry), every solve
converged and certified at its tolerance, every request served, the
batched tokens equal to each request served alone.  ``cg_solver`` runs
4 rank threads on Poisson 48 x 48 here (the reference's 8 ranks on
96 x 96 run on the card, in ``chip_smoke.py``).
"""
import numpy as np
import pytest

from repro.core import formats as F
from repro.core import matrices as M

ROUND_OFF = 1e-5


@pytest.fixture(scope="module")
def quick():
    from repro_torch.examples import quickstart
    return quickstart.main(["--device", "cpu"])


def test_quickstart_storage_equals_reference(quick):
    m = M.samg(scale=0.002)
    assert quick["shape"] == m.shape and quick["nnz"] == m.nnz
    assert quick["ell_elements"] == F.storage_elements(
        F.csr_to_ell(m, row_align=128))
    assert quick["pjds_elements"] == F.storage_elements(
        F.csr_to_pjds(m, b_r=128))
    assert quick["data_reduction"] == F.data_reduction_vs_ellpack(m)


def test_quickstart_products_at_round_off(quick):
    assert quick["matvec_err"] <= ROUND_OFF * quick["y_ref_max"]
    assert quick["rmatvec_rel_err"] <= ROUND_OFF
    assert quick["grad_err"] <= ROUND_OFF * quick["grad_ref_max"]


def test_quickstart_prices_eq3_on_the_h100(quick):
    from repro_torch.core import perf_model as PM
    lo = 1.0 / quick["n_nzr"]
    assert quick["eq3_threshold"] == PM.n_nzr_upper_for_link_penalty(
        3.35e12, 450e9, lo)
    assert quick["link_dominated"] == (quick["n_nzr"]
                                       < quick["eq3_threshold"])
    assert quick["format"] in ("sell", "pjds", "ell", "cmrs")


@pytest.fixture(scope="module")
def cg():
    from repro_torch.examples import cg_solver
    return cg_solver.main(["--device", "cpu", "--ranks", "4",
                           "--side", "48"])


@pytest.mark.parametrize("mode", ["vector", "naive", "overlap"])
def test_cg_modes_converge_alike(cg, mode):
    r = cg["modes"][mode]
    assert r["status"] == "converged" and r["rel_res"] <= 1e-6
    assert r["iters"] == cg["modes"]["vector"]["iters"]
    assert cg["ranks_agree"] and cg["ranks"] == 4


def test_cg_jacobi_block_and_bicgstab(cg):
    assert cg["jacobi"]["status"] == "converged"
    assert cg["block_cg"]["status"] == "converged"
    assert cg["block_cg"]["true_res"] <= 2e-6 * 1.5
    assert cg["bicgstab"]["status"] == "converged"
    assert cg["bicgstab"]["true_res"] <= 1e-6 * 1.5
    assert cg["transpose_rel_err"] <= ROUND_OFF
    assert cg["cg_true_res"] <= 1e-6 * 1.5


@pytest.fixture(scope="module")
def served():
    from repro_torch.examples import serve_solver
    return serve_solver.main(["--device", "cpu"])


def test_serve_solver_serves_every_request(served):
    st = served["statuses"]
    assert len(st) == served["n_requests"] == 12
    assert st[7] == "shed"
    assert all(s == "converged" for i, s in enumerate(st) if i != 7)
    assert all(r <= 1e-6 for i, r in enumerate(served["residuals"])
               if i != 7)
    c = served["counters"]
    assert c["converged"] == 11 and c["shed"] == 1


def test_serve_solver_swaps_values(served):
    assert served["swaps"] == 1 and served["version"] == 1
    assert served["batch_k"][:4] == [4, 4, 4, 4]


@pytest.fixture(scope="module")
def lm():
    from repro_torch.examples import serve_lm
    return serve_lm.main(["--device", "cpu"])


def test_serve_lm_serves_six_requests(lm):
    assert lm["slots"] == 4 and lm["max_len"] == 128
    assert [len(p) for p in lm["prompts"]] == [4 + 3 * i for i in range(6)]
    assert all(lm["done"]) and all(len(t) == 8 for t in lm["tokens"])
    rng = np.random.default_rng(0)
    for p in lm["prompts"]:
        assert p == rng.integers(0, 512, (len(p),)).astype(np.int32).tolist()


def test_serve_lm_tokens_equal_solo_runs(lm):
    from repro_torch.examples import serve_lm
    cfg, model, params = serve_lm.build("cpu")
    for req in serve_lm.requests(cfg):
        serve_lm.serve(model, params, [req])
        assert req.out == lm["tokens"][req.rid], req.rid
