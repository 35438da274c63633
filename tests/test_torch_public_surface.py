"""The port's public surface against the reference's, module by module.

For every module of ``src/repro/`` (``_compat/`` aside), the public
top-level ``def`` / ``class`` names (AST, no leading underscore) must
be top-level names of the port's module of the same path
(``launch/hlo_analysis.py`` is ``launch/comm_analysis.py``), defined or
imported there.  The allowed omissions sit in :data:`OMITTED`, each with
its reason; an entry whose name the port has after all fails too, so
the table stays true.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

RENAMED = {"launch/hlo_analysis.py": "launch/comm_analysis.py"}

_TPU_GRID = ("a helper of the Pallas grid on the TPU (BlockSpec index "
             "maps, interpret mode, per-tile bodies); the CUDA kernels "
             "are written whole and decide the backend per tensor")
_XLA_COST = ("exists because XLA's cost analysis counts a while body "
             "once; the port's stack and attention are Python loops, so "
             "the dry run's depth variants trace every layer and chunk "
             "pair as they stand and need no cost mode")

# (module, name) -> why the port has no counterpart
OMITTED = {
    ("kernels/ops.py", "spmv"):
        "deprecated by the reference itself (repro/kernels/ops.py:953); "
        "the port's entry points are operator(m) @ x and as_device",
    ("kernels/_backend.py", "resolve_interpret"): _TPU_GRID,
    ("kernels/_backend.py", "chunk_clamp"): _TPU_GRID,
    ("kernels/_backend.py", "tile_contrib"): _TPU_GRID,
    ("kernels/pjds_spmv.py", "block_extents"): _TPU_GRID,
    ("kernels/ref.py", "partial_reduce_epilogue_ref"):
        "the port reduces the 2-D grid's partial sums inside "
        "core/dist_spmv.py (_reduce_partials)",
    ("core/dist_spmv.py", "make_dist_matvec"):
        "a jitted shard_map closure over a JAX mesh; the port's "
        "DistOperator applies the partition on each rank (op @ x)",
    ("core/dist_spmv.py", "make_dist_matmat"):
        "a jitted shard_map closure over a JAX mesh; the port's "
        "DistOperator applies the partition on each rank (op @ X)",
    ("tune/measure.py", "measurement_backend"):
        "the port measures on the operand's device; there is no "
        "interpret mode to avoid timing",
    ("models/common.py", "split_keys"):
        "splits a JAX PRNG key; the port draws from a torch.Generator",
    ("launch/hlo_analysis.py", "hlo_flops_bytes"):
        "XLA's cost analysis; the port's StepRecorder counts flops and "
        "bytes as the step runs (comm_analysis.StepRecorder)",
    ("models/unroll.py", "cost_mode"): _XLA_COST,
    ("models/unroll.py", "cost_mode_enabled"): _XLA_COST,
    ("models/unroll.py", "scan_unroll"): _XLA_COST,
}
NO_MODULE = {"models/unroll.py": _XLA_COST}


def _ref_modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
                  if not p.relative_to(REF).as_posix().startswith("_compat"))


def _public_defs(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")}


def _top_level_names(path: pathlib.Path) -> set:
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


def _port_path(rel: str) -> pathlib.Path:
    return PORT / RENAMED.get(rel, rel)


@pytest.mark.parametrize("rel", _ref_modules())
def test_module_names_are_ported(rel):
    ref_names = _public_defs(REF / rel)
    port = _port_path(rel)
    if rel in NO_MODULE:
        assert not port.exists(), f"{rel} is ported now: drop NO_MODULE"
        missing = ref_names
    else:
        assert port.exists(), f"no port of {rel}"
        missing = ref_names - _top_level_names(port)
    allowed = {name for (mod, name) in OMITTED if mod == rel}
    assert missing - allowed == set(), \
        f"{rel}: the port lacks {sorted(missing - allowed)}"
    assert allowed - missing == set(), \
        f"{rel}: OMITTED lists {sorted(allowed - missing)}, which the " \
        f"port has"


def test_every_omission_names_a_reference_name_and_a_reason():
    for (rel, name), why in OMITTED.items():
        assert name in _public_defs(REF / rel), (rel, name)
        assert len(why) > 20


@pytest.mark.parametrize("rel,names", [
    ("core/perf_model.py", ["spmvm_flops", "predicted_iteration_seconds",
                            "RooflineReport", "roofline_terms"]),
    ("tune/calibrate.py", ["rows_from_bench_kernels",
                           "fit_from_bench_kernels"]),
    ("core/formats.py", ["csr_to_dense", "pjds_to_dense", "sell_to_dense"]),
])
def test_names_ported_in_this_slice_are_exported(rel, names):
    import importlib
    mod = importlib.import_module(
        "repro_torch." + rel[:-3].replace("/", "."))
    for name in names:
        assert name in mod.__all__ and callable(getattr(mod, name)), name


def test_tune_package_exports_the_bench_adapter():
    import repro.tune as JT
    import repro_torch.tune as TT
    for name in ("rows_from_bench_kernels", "fit_from_bench_kernels"):
        assert name in JT.__all__ and name in TT.__all__


@pytest.mark.parametrize("name", ["quickstart", "eigensolver", "cg_solver",
                                  "serve_solver", "serve_lm", "train_lm"])
def test_every_reference_example_has_a_port(name):
    assert (ROOT / "examples" / f"{name}.py").exists()
    src = (PORT / "examples" / f"{name}.py").read_text()
    tree = ast.parse(src)
    assert "main" in {n.name for n in tree.body
                      if isinstance(n, ast.FunctionDef)}
    assert '"--device"' in src and '__name__ == "__main__"' in src
