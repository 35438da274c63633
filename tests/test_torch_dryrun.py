"""The port's dry run (``repro_torch.launch.dryrun``) and its collective
accounting (``launch.comm_analysis``) against the reference's.

The cells run in subprocesses: PyTorch's fake process group must not
enter a test worker.  The seamless-m4t-medium ``decode_32k`` cell on the
fake 256-rank (16, 16) mesh ends ``ok`` with 256 chips, as the
reference's ``tests/test_dryrun.py`` asks of its cell, and on the
512-rank (2, 16, 16) mesh too.  A JAX subprocess reads the reference's
``SKIP`` table and runs its HLO parser on collective ops whose port
counterparts (``collective_bytes``'s records) must cost the same.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.launch import comm_analysis as CA
from repro_torch.launch import dryrun as DR

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CELL = textwrap.dedent("""
    import json, sys
    from repro_torch.launch.dryrun import dryrun_cell
    out = {}
    for mesh in ("single", "multi"):
        rec = dryrun_cell("seamless-m4t-medium", "decode_32k", mesh)
        out[mesh] = {k: rec[k] for k in ("status", "chips", "flops_per_rank",
                                         "collective_raw", "memory", "rules",
                                         "cost")}
    # a row-parallel product over the model axis: one all-reduce of its
    # (B, N) result, and the rank's share of the flops
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import comm_analysis as CA
    from repro_torch.launch.dryrun import _fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as S
    _fake_world(4)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = S.place(torch.empty(8, 64), mesh, [Shard(0), Shard(1)])
        w = S.place(torch.empty(64, 32), mesh, [Replicate(), Shard(0)])
        r = CA.StepRecorder()
        with r:
            y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
    out["row_parallel"] = {"collectives": r.collectives, "flops": r.flops}
    print("OUT " + json.dumps(out))
""")

_REF = textwrap.dedent("""
    import json
    from repro.launch.dryrun import SKIP
    from repro.launch.hlo_analysis import collective_bytes
    hlo = '''
      %ag = f32[16,512]{1,0} all-gather(f32[1,512]{1,0} %p), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
      %ar = bf16[1024]{0} all-reduce(bf16[1024]{0} %x), replica_groups=[16,16]
      %agd = f32[16,512]{1,0} all-gather-done(f32[16,512]{1,0} %ags)
      %cp = f32[256]{0} collective-permute(f32[256]{0} %y), source_target_pairs={{0,1}}
      %rs = bf16[64,128]{1,0} reduce-scatter(bf16[256,128]{1,0} %z), replica_groups=[64,4], dimensions={0}
      %a2a = f32[32,8]{1,0} all-to-all(f32[32,8]{1,0} %w), replica_groups={{0,1,2,3,4,5,6,7}}
      %ar2 = f32[4096]{0} all-reduce(f32[4096]{0} %v), replica_groups=[2,256]
    '''
    print("OUT " + json.dumps({"skip": {f"{a}|{s}": r
                                        for (a, s), r in SKIP.items()},
                               "bytes": collective_bytes(hlo)}))
""")

# the same ops as the port's recorder writes them: result bytes, group
_RECORDS = [
    {"op": "all-gather", "bytes": 16 * 512 * 4, "group": 16},
    {"op": "all-reduce", "bytes": 1024 * 2, "group": 16},
    {"op": "collective-permute", "bytes": 256 * 4, "group": 2},
    {"op": "reduce-scatter", "bytes": 64 * 128 * 2, "group": 4},
    {"op": "all-to-all", "bytes": 32 * 8 * 4, "group": 8},
    {"op": "all-reduce", "bytes": 4096 * 4, "group": 256},
]


def _run(script, jax_env=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    if jax_env:
        env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("OUT ")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def cells():
    return _run(_CELL)


@pytest.fixture(scope="module")
def ref():
    return _run(_REF, jax_env=True)


@pytest.mark.parametrize("mesh,chips", [("single", 256), ("multi", 512)])
def test_decode_cell_runs_on_the_fake_mesh(cells, mesh, chips):
    rec = cells[mesh]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == chips
    assert rec["flops_per_rank"] > 0
    assert rec["cost"]["flops"] == rec["flops_per_rank"]
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == (mem["params_bytes"]
                                             + mem["cache_bytes"]
                                             + mem["batch_bytes"])
    # decode_32k: batch 128 splits over the data axes, no context
    # parallelism
    assert rec["rules"]["kvseq"] is None and rec["rules"]["batch"]
    assert rec["collective_raw"]["counts"].get("all-reduce", 0) > 0


def test_the_per_rank_layout_shrinks_with_the_mesh(cells):
    """Twice the ranks (the pod axis on the batch): the cache a rank
    holds halves, its params do not."""
    one, two = cells["single"]["memory"], cells["multi"]["memory"]
    assert two["cache_bytes"] * 2 == one["cache_bytes"]
    assert two["params_bytes"] == one["params_bytes"]


def test_row_parallel_product_records_one_all_reduce(cells):
    r = cells["row_parallel"]
    assert r["collectives"] == [{"op": "all-reduce", "bytes": 4 * 32 * 4,
                                 "group": 2}]
    assert r["flops"] == 2 * 4 * 32 * 32     # the rank's (4, 32) x (32, 32)


def test_skip_table_matches_reference(ref):
    assert {f"{a}|{s}": r for (a, s), r in DR.SKIP.items()} == ref["skip"]


def test_collective_bytes_matches_reference_parser(ref):
    got = CA.collective_bytes(_RECORDS)
    want = ref["bytes"]
    assert got["counts"] == want["counts"]
    assert abs(got["total"] - want["total"]) <= 1e-6 * want["total"]
    for op, v in want["per_op"].items():
        assert abs(got["per_op"][op] - v) <= 1e-6 * v, op


def test_skipped_cell_and_cell_file(tmp_path):
    DR.main(["--arch", "qwen2.5-14b", "--shape", "long_500k", "--out",
             str(tmp_path)])
    rec = json.loads((tmp_path / "single" /
                      "qwen2.5-14b__long_500k.json").read_text())
    assert rec["status"] == "skipped"
    assert rec["reason"] == DR.SKIP[("qwen2.5-14b", "long_500k")]
