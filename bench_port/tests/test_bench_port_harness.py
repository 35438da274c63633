"""The harness on the CPU at tiny sizes: every cell runs end to end and
comes out correct; a fault planted under the timed path makes it come
out not correct; a new cell or metric needs files and manifest entries
only; the manifest keeps the benchmark's contract; nothing the harness,
the reference or the rank processes run loads JAX or the JAX package;
the controls fail the limits.  The card test runs each cell through its
command for a second."""
import ast
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from bench_port import harness as H

ROOT = pathlib.Path(H.__file__).resolve().parents[1]
TINY = {"cg_poisson2048": {"nx": 24, "ny": 20},
        "spmv_samg": {"scale": 0.002}, "spmv_t_samg": {"scale": 0.002},
        "dist_spmv_samg4": {"scale": 0.002}}
PENDING = {"dist_spmv_samg4"}    # bench_port/pending/<cell>.json
SEED = 2 ** 31 + 12345


def _manifest(with_pending=False):
    """BENCHMARK.json, with the held-back cells' entries added as a
    later change would add them."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in sorted(PENDING) if with_pending else ():
        p = json.loads((ROOT / "bench_port" / "pending"
                        / f"{cell}.json").read_text())
        b["workloads"].append(p["workload"])
        b["end_to_end"] += p["end_to_end"]
        b["per_layer"] += p["per_layer"]
        for m in b["per_layer"]:
            if m["name"] == "build_s":
                m["workloads"].append(cell)
    return b


@pytest.fixture(scope="module")
def pending_root(tmp_path_factory):
    """A checkout whose manifest holds the held-back cells too."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "BENCHMARK.json").write_text(json.dumps(_manifest(True)))
    return root


def _run(cell, *, trace=False, fault=None, root=ROOT, seconds=0.3):
    out, err = io.StringIO(), io.StringIO()
    rc = H.run_cell(cell, SEED, seconds, trace, root=root, device="cpu",
                    fault=fault, overrides=TINY.get(cell, {}), out=out,
                    err=err)
    assert rc == 0, err.getvalue()
    lines = out.getvalue().splitlines()
    return json.loads(lines[-2])["run"], json.loads(lines[-1]), \
        err.getvalue().splitlines()


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_correct_on_the_cpu(cell, pending_root):
    run, res, err = _run(cell, root=pending_root if cell in PENDING
                         else ROOT)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert err[-len(res["checks"]):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in res["checks"].items()]
    assert "setup_s" in res["metrics"]
    assert res["device"]["platform"] == "cpu"   # no device metric here
    assert run["workload"] == cell and run["seed"] == SEED


@pytest.mark.parametrize("cell", ["cg_poisson2048", "spmv_t_samg"])
def test_traced_run_reports_per_layer_metrics(cell):
    _, res, _ = _run(cell, trace=True)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in H.metrics_of_cell(manifest, cell, True)}
    assert set(res["metrics"]) <= names and "build_s" in res["metrics"]
    assert res["correct"] is True and "breakdown" in res


# -- faults under the timed path: each must make `correct` false ------------
def _solve_state_unchanged(real):
    def solve(op, b, **kw):
        res = real(op, b, **kw)
        res.x = torch.zeros_like(res.x)      # x0 back, "converged"
        return res
    return solve


def _solve_answer_altered(real):
    def solve(op, b, **kw):
        res = real(op, b, **kw)
        res.x = res.x.clone()
        res.x[len(res.x) // 3] += 1.0
        return res
    return solve


@pytest.mark.parametrize("fault", [_solve_state_unchanged,
                                   _solve_answer_altered])
def test_solve_fault_is_caught(monkeypatch, fault):
    import repro_torch
    monkeypatch.setattr(repro_torch, "solve", fault(repro_torch.solve))
    _, res, _ = _run("cg_poisson2048")
    assert res["correct"] is False


def _product_altered(y):
    y = y.clone()
    y[len(y) // 2] += 0.01 * y.abs().max()    # one entry off by 1 %
    return y


def _half_left_out(y):
    y = y.clone()
    y[len(y) // 2:] = 0
    return y


@pytest.mark.parametrize("cell,method", [("spmv_samg", "matvec"),
                                         ("spmv_t_samg", "matvec"),
                                         ("spmv_t_samg", "rmatvec")])
@pytest.mark.parametrize("fault", [_product_altered, _half_left_out])
def test_product_fault_is_caught(monkeypatch, cell, method, fault):
    from repro_torch.core.operator import DeviceOperator
    real = getattr(DeviceOperator, method)
    monkeypatch.setattr(DeviceOperator, method,
                        lambda self, v, backend=None: fault(
                            real(self, v, backend)))
    _, res, _ = _run(cell)
    assert res["correct"] is False


class _NoExchange:
    """A communicator whose halo messages never go out."""

    def __init__(self, comm):
        self.comm, self.rank, self.size = comm, comm.rank, comm.size

    def exchange(self, sends, recvs):
        return self.comm.exchange([], [])

    def all_reduce_sum(self, t):
        return self.comm.all_reduce_sum(t)


def drop_exchange(point, comm):
    return _NoExchange(comm) if point == "comm" else comm


def test_exchange_left_out_is_caught(pending_root):
    _, res, _ = _run("dist_spmv_samg4", root=pending_root,
                     fault=f"{__name__}:drop_exchange")
    assert res["correct"] is False


# -- data-driven: a cell and a metric from files alone ----------------------
def test_new_cell_and_metric_from_files_alone(tmp_path):
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = _manifest()
    (tmp_path / "bench_port" / "traffic" / "spmv_sell.json").write_text(
        json.dumps({"kind": "spmv", "format": "sell", "ring": 3,
                    "transpose": False, "trace_calls": 5,
                    "enqueue_calls": 4, "samples": 3}))
    (tmp_path / "bench_port" / "limits" / "spmv_sell_samg.json").write_text(
        json.dumps({"limits": {"y_err": 5e-05}}))
    (tmp_path / "bench_port" / "metrics" / "products_per_s.py").write_text(
        '"""Products a second."""\n\n\ndef read(rec):\n'
        '    return rec["products"] / rec["window_s"]\n')
    manifest["workloads"].append(
        {"name": "spmv_sell_samg", "config": "samg", "traffic": "spmv_sell",
         "chips": 1, "why": "SELL instead of the default format"})
    manifest["end_to_end"].append(
        {"name": "products_per_s", "unit": "1/s", "better": "higher",
         "bound": 0.05, "source": "host_clock",
         "workloads": ["spmv_sell_samg"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    out, err = io.StringIO(), io.StringIO()
    rc = H.run_cell("spmv_sell_samg", SEED, 0.2, False, root=tmp_path,
                    device="cpu", overrides={"scale": 0.001}, out=out,
                    err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().splitlines()[-1])
    run = json.loads(out.getvalue().splitlines()[-2])["run"]
    assert res["correct"] is True and run["picked"]["format"] == "sell"
    assert res["metrics"]["products_per_s"]["value"] > 0
    assert "setup_s" in res["metrics"]


# -- the manifest against the contract's static rules ----------------------
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.mark.parametrize("with_pending", [False, True])
def test_manifest_keeps_the_contract(with_pending):
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = _manifest(with_pending)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench_port"] and 1 <= b["run_seconds"] <= 51
    assert b["command"] == ["python3", "bench_port/run.py"]
    confs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["file"].startswith("bench_port/")
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in confs and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        for d, f in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert (ROOT / "bench_port" / d / f"{f}.json").is_file()
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"solve_ms", "spmv_gflops", "operand_bytes_per_nnz",
                        "setup_s"} | ({"dist_spmv_gflops"} if with_pending
                                      else set())
    assert "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            mv = e2e[m["moves"]]
            assert w in cells and w in mv.get("workloads", cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "bench_port" / "metrics" / f"{m['name']}.py").is_file()
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"
    for w in cells:
        reported = H.metrics_of_cell(b, w, False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2 and H.metrics_of_cell(b, w, True)
    # run_seconds fits the full 24 cells of a later check
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


# -- the import scan -------------------------------------------------------
def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_under_bench_port_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench_port").rglob("*.py"):
        if "tests" in path.parts:
            continue
        found = set(_top_imports(path)) & set(H.FORBIDDEN)
        assert not found, (path, found)


def test_forbidden_names_compare_whole_top_level_names():
    assert H.forbidden_modules(["repro_torch", "repro_torch.core",
                                "jaxtyping", "reprox"]) == []
    assert H.forbidden_modules(["repro.core", "jax.numpy", "benchmarks",
                                "flax"]) == ["benchmarks", "flax", "jax",
                                             "repro"]


def _fresh(code):
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr
    return p.stdout


def test_reference_imports_nothing_of_the_port_or_jax():
    out = _fresh("import sys, bench_port.reference, bench_port.roofline, "
                 "bench_port.generators\n"
                 "print(sorted({m.split('.')[0] for m in sys.modules}))")
    tops = set(json.loads(out.replace("'", '"')))
    assert not tops & {"repro_torch", *H.FORBIDDEN}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_whole_run_loads_no_jax(cell, pending_root):
    # the harness exits 3 and prints no result if the process that prints
    # it (or, for four ranks, any rank) loaded one of the names
    root = pending_root if cell in PENDING else ROOT
    out = _fresh(
        "import io, json, pathlib, sys\n"
        "from bench_port import harness as H\n"
        f"o = io.StringIO(); rc = H.run_cell({cell!r}, 7, 0.2, False, "
        f"root=pathlib.Path({str(root)!r}), device='cpu', "
        f"overrides={TINY[cell]!r}, out=o)\n"
        "print(rc, json.dumps(H.forbidden_modules()))\n")
    rc, found = out.split(" ", 1)
    assert rc == "0" and json.loads(found) == []


def test_a_forbidden_module_stops_the_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    out, err = io.StringIO(), io.StringIO()
    rc = H.run_cell("spmv_samg", SEED, 0.2, False, device="cpu",
                    overrides=TINY["spmv_samg"], out=out, err=err)
    assert rc == 3 and out.getvalue() == "" and "jax" in err.getvalue()


# -- the controls fail the limits ------------------------------------------
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails_a_limit(cell, pending_root):
    from bench_port.controls import control
    root = pending_root if cell in PENDING else ROOT
    limits = H.find_cell(_manifest(True), cell, root)["limits"]
    over = {"cg_poisson2048": {"nx": 48, "ny": 40}}.get(cell, TINY[cell])
    got = control(cell, SEED, device="cpu", overrides=over, root=root)
    assert any(got[k] > v for k, v in limits.items()), got


# -- on the card ----------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(set(TINY) - PENDING))
def test_cell_command_on_the_card(cell):
    chips = H.find_cell(_manifest(), cell)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        cell, "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
