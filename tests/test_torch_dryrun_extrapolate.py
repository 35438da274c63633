"""The dry run's depth extrapolation (``launch.dryrun._depth_variants``,
``extrapolated_cost``) against the reference's plan and against a trace
of the full depth.

* The plan: for the eight uniform configs the port's variants have the
  reference's depths, layer kinds and counts (a JAX subprocess runs
  ``repro.launch.dryrun._depth_variants``); for the two multi-kind ones
  the port takes whole periods where the reference takes each kind
  alone, over the same layers.
* The record: on cells whose full depth traces in seconds -- a uniform
  decode, a multi-kind one (recurrentgemma-2b's long_500k), an MoE
  with a dense first layer, the encoder-decoder, one whose encoder is
  shallower than its decoder, a train and a prefill cell on short
  shapes -- the record built from
  the variants has the full trace's (``with_cost=False``) flops,
  unfused bytes, collective bytes and counts, argument and output
  bytes, and its temporaries (peak less arguments) within 1 %.
* Cross-attention keeps its heads split over the model axis in every
  decoder layer.

Each cell runs in a subprocess of its own, all at once, its variants
traced in processes of their own as the command line traces them:
PyTorch's fake process group must not enter a test worker.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch import configs
from repro_torch.launch import dryrun as DR

ROOT = pathlib.Path(__file__).resolve().parents[1]

PEAK_TOL = 0.01
COUNT_TOL = 1e-9

_REF_PLAN = textwrap.dedent("""
    import json
    from repro import configs
    from repro.launch.dryrun import _depth_variants
    print("OUT " + json.dumps({
        a: [[s1.n_layers, s1.enc_layers, list(s1.layer_pattern),
             s2.n_layers, s2.enc_layers, list(s2.layer_pattern), n]
            for s1, s2, n, _ in _depth_variants(configs.get(a))]
        for a in configs.ARCH_IDS}))
""")

_CELL = textwrap.dedent("""
    import json, sys
    from repro_torch import configs
    from repro_torch.launch.dryrun import dryrun_cell
    # short shapes of the published kinds: a train and a prefill cell
    # whose full depth traces in seconds
    configs.SHAPES["train_short"] = configs.ShapeConfig(
        "train_short", 256, 32, "train")
    configs.SHAPES["prefill_short"] = configs.ShapeConfig(
        "prefill_short", 1024, 32, "prefill")
    arch, shape, mesh, ov = (sys.argv[1], sys.argv[2], sys.argv[3],
                             json.loads(sys.argv[4]))
    out = {}
    for key, with_cost in (("ex", True), ("full", False)):
        rec = dryrun_cell(arch, shape, mesh, overrides=ov or None,
                          q_chunk=256, k_chunk=256, with_cost=with_cost)
        out[key] = {k: rec.get(k) for k in (
            "status", "flops_per_rank", "hlo_bytes_raw", "collective_raw",
            "memory", "cost", "trace_s")}
    print("OUT " + json.dumps(out))
""")

# the local q heads each attention of seamless-m4t-medium's train step
# (three decoder layers, one encoder layer) runs on
_HEADS = textwrap.dedent("""
    import dataclasses, json
    from repro_torch import configs
    from repro_torch.launch.dryrun import _trace_cell
    from repro_torch.models import attention as A
    shape = configs.ShapeConfig("train_short", 256, 32, "train")
    heads = []
    plain = A.flash_attention

    def flash_attention(q, k, v, **kw):
        heads.append(q.shape[2])
        return plain(q, k, v, **kw)
    A.flash_attention = flash_attention
    cfg = dataclasses.replace(configs.get("seamless-m4t-medium"),
                              n_layers=3, enc_layers=1)
    _trace_cell(cfg, shape, "single", 256, 256)
    print("OUT " + json.dumps(heads))
""")

# id -> (arch, shape, mesh, overrides)
CASES = {
    "uniform-decode": ("qwen2.5-14b", "decode_32k", "single", {}),
    # a recurrent layer after a recurrent one reads 8 x the flops of the
    # first: the reference's per-kind plan gave 3.5 x the cell's flops
    "multi-kind-decode": ("recurrentgemma-2b", "long_500k", "single", {}),
    "dense-prefix-moe": ("deepseek-moe-16b", "decode_32k", "single", {}),
    "enc-dec": ("seamless-m4t-medium", "decode_32k", "single", {}),
    "enc-dec-shallow-encoder": ("seamless-m4t-medium", "train_short",
                                "single", {"n_layers": 4, "enc_layers": 3}),
    # four periods of (recurrent, recurrent, local) and two layers more
    "train-multi-kind": ("recurrentgemma-2b", "train_short", "single",
                         {"n_layers": 14}),
    # three periods of (5 x local, global) and two local layers more
    "prefill-multi-pod": ("gemma3-4b", "prefill_short", "multi",
                          {"n_layers": 20}),
}


def _env(jax=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _out(proc):
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("OUT ")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def runs():
    procs = {"ref_plan": subprocess.Popen(
        [sys.executable, "-c", _REF_PLAN], env=_env(jax=True),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for case, (arch, shape, mesh, ov) in CASES.items():
        procs[case] = subprocess.Popen(
            [sys.executable, "-c", _CELL, arch, shape, mesh, json.dumps(ov)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    procs["heads"] = subprocess.Popen(
        [sys.executable, "-c", _HEADS], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return {k: _out(p) for k, p in procs.items()}


# the configs whose plans depart from the reference's: a whole period
MULTI_KIND = ("gemma3-4b", "recurrentgemma-2b")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_plan_is_the_references(runs, arch):
    """The reference's plan for a uniform pattern; for a multi-kind one,
    a whole period where the reference takes each kind alone, over the
    same layers and kinds."""
    cfg = configs.get(arch)
    ref = runs["ref_plan"][arch]
    got = [[v.small1.n_layers, v.small1.enc_layers,
            list(v.small1.layer_pattern), v.small2.n_layers,
            v.small2.enc_layers, list(v.small2.layer_pattern), v.count]
           for v in DR._depth_variants(cfg)]
    if arch not in MULTI_KIND:
        assert got == ref
        return
    pattern = list(cfg.layer_pattern)
    (v,) = DR._depth_variants(cfg)
    period = v.small2.n_layers - v.small1.n_layers
    assert v.kind == "period" and period == len(pattern)
    assert v.small1.layer_pattern == v.small2.layer_pattern == cfg.layer_pattern
    assert v.small1.n_layers + (v.count - 1) * period == cfg.n_layers
    # the reference: each kind of the period alone at 1 and 2 layers,
    # counted over the same layers
    assert sorted(r[2][0] for r in ref) == sorted(set(pattern))
    assert all(r[0:2] == [1, 0] and r[3:5] == [2, 0] for r in ref)
    assert sum(r[6] for r in ref) == cfg.n_layers


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1)


@pytest.mark.parametrize("case", CASES)
def test_record_is_extrapolated(runs, case):
    ex, full = runs[case]["ex"], runs[case]["full"]
    assert ex["status"] == full["status"] == "ok"
    cost = ex["cost"]
    assert cost["extrapolated"] is True
    assert cost["n_variant_traces"] >= 2
    assert len(cost["traced"]) == cost["n_variant_traces"]
    assert all(isinstance(t["temp_size_in_bytes"], int)
               for t in cost["traced"])
    assert "cost" not in full or full["cost"] is None
    arch, _, _, ov = CASES[case]
    cfg = configs.get(arch)
    depth = ov.get("n_layers", cfg.n_layers)
    assert sum(v["count"] for v in cost["variants"]
               if v["kind"] != "encoder") <= depth
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "peak_bytes"):
        assert isinstance(ex["memory"][k], int), k
    assert ex["memory"]["temp_size_in_bytes"] == (
        ex["memory"]["peak_bytes"] - ex["memory"]["argument_size_in_bytes"])
    assert cost["flops"] == ex["flops_per_rank"]
    assert cost["bytes"] == ex["hlo_bytes_raw"]


@pytest.mark.parametrize("what", ["flops", "bytes", "collective_bytes",
                                  "collective_per_op"])
@pytest.mark.parametrize("case", CASES)
def test_counts_equal_the_full_trace(runs, case, what):
    ex, full = runs[case]["ex"], runs[case]["full"]
    if what == "flops":
        pairs = [(ex["flops_per_rank"], full["flops_per_rank"])]
    elif what == "bytes":
        pairs = [(ex["hlo_bytes_raw"], full["hlo_bytes_raw"])]
    elif what == "collective_bytes":
        pairs = [(ex["collective_raw"]["total"],
                  full["collective_raw"]["total"])]
    else:
        assert ex["collective_raw"]["counts"] == \
            full["collective_raw"]["counts"]
        assert set(ex["collective_raw"]["per_op"]) == \
            set(full["collective_raw"]["per_op"])
        pairs = [(ex["collective_raw"]["per_op"][op], v)
                 for op, v in full["collective_raw"]["per_op"].items()]
    assert pairs[0][1] > 0 or what.startswith("collective")
    for got, want in pairs:
        assert _rel(got, want) <= COUNT_TOL, (got, want)


@pytest.mark.parametrize("case", CASES)
def test_argument_and_output_bytes_are_exact(runs, case):
    ex, full = runs[case]["ex"]["memory"], runs[case]["full"]["memory"]
    for k in ("params_bytes", "opt_state_bytes", "cache_bytes",
              "batch_bytes", "argument_size_in_bytes",
              "output_size_in_bytes"):
        assert ex.get(k) == full.get(k), k


@pytest.mark.parametrize("case", CASES)
def test_peak_within_one_percent(runs, case):
    """The extrapolated part itself: the peak less the arguments (which
    are laid out at full depth, exact) within 1 % of the full trace's."""
    ex, full = runs[case]["ex"]["memory"], runs[case]["full"]["memory"]
    assert _rel(ex["temp_size_in_bytes"], full["temp_size_in_bytes"]) \
        <= PEAK_TOL, (ex["temp_size_in_bytes"], full["temp_size_in_bytes"])
    assert _rel(ex["peak_bytes"], full["peak_bytes"]) <= PEAK_TOL


def test_cross_attention_keeps_heads_split(runs):
    """Every attention of every layer, forward and recomputed, runs on
    its rank's heads (16 over the model axis of 16): the encoder's, each
    decoder layer's self- and cross-attention."""
    heads = runs["heads"]
    n_heads = configs.get("seamless-m4t-medium").n_heads
    assert len(heads) >= 1 + 2 * 3
    assert set(heads) == {n_heads // 16}, heads


@pytest.mark.parametrize("step_kind,n_traced", [
    ("decode", 3), ("prefill", 2), ("train", 3)])
def test_shallow_cell_is_traced_whole(step_kind, n_traced):
    """A depth no deeper than the plan's configs: nothing to carry."""
    cfg = configs.smoke("minicpm-2b")
    assert cfg.n_layers == 2
    plan = DR._depth_variants(cfg)
    assert len(DR.traced_configs(plan, step_kind)) == n_traced
    assert not DR._needs_variants(cfg, plan, step_kind)
    deep = configs.get("minicpm-2b")
    assert DR._needs_variants(deep, DR._depth_variants(deep), step_kind)


def test_encoder_kind_shares_the_decoders_first_config():
    cfg = configs.get("seamless-m4t-medium")
    plan = DR._depth_variants(dataclasses.replace(cfg, enc_layers=5))
    assert [v.kind for v in plan] == ["global", "encoder"]
    dec, enc = plan
    assert dec.small1 == enc.small1
    assert (dec.count, enc.count) == (12, 5)
    assert (enc.small2.n_layers, enc.small2.enc_layers) == (1, 2)
    assert (dec.small2.n_layers, dec.small2.enc_layers) == (2, 1)
    # the peak's: two of each, and for a train step one more of each
    depths = [(c.n_layers, c.enc_layers)
              for c in DR.traced_configs(plan, "train")]
    assert depths == [(1, 1), (2, 1), (1, 2), (2, 2), (3, 2), (2, 3)]


@pytest.mark.parametrize("arch,depths,count", [
    ("gemma3-4b", (10, 16), 5),           # 5 x 6 layers + 4 local
    ("recurrentgemma-2b", (5, 8), 8),     # 8 x 3 layers + 2 recurrent
    ("qwen2.5-14b", (1, 2), 48),          # uniform: the reference's plan
    ("deepseek-moe-16b", (2, 3), 27),
])
def test_cell_plan_takes_whole_periods(arch, depths, count):
    """A layer's counts depend on the layers around it: a cell takes a
    multi-kind pattern a period at a time, the suffix in the base."""
    (v,) = DR._depth_variants(configs.get(arch))
    assert (v.small1.n_layers, v.small2.n_layers) == depths
    assert v.count == count
    assert v.small1.layer_pattern == configs.get(arch).layer_pattern


def _trace(temp, out=0):
    return {"flops": 0, "bytes": 0, "collectives": [],
            "memory": {"temp_size_in_bytes": temp,
                       "output_size_in_bytes": out}}


@pytest.mark.parametrize("step_kind", ["train", "decode", "prefill"])
def test_peak_formula(step_kind):
    """The line through the second unit: ``args + temp(two) + (count -
    2) * slope``, slope by step kind (a train or decode step's
    temporaries one unit deeper, a prefill its output's growth); with
    an encoder kind, two units of each and a slope for each."""
    cfg = configs.get("minicpm-2b")
    plan = DR._depth_variants(cfg)
    c1, c2, c3 = (DR._at(plan, [u]) for u in (1, 2, 3))
    traces = {c1: _trace(50, 7), c2: _trace(60, 9), c3: _trace(64, 11)}
    got = DR.extrapolate(plan, traces, 1000, step_kind)
    slope = {"train": 4, "decode": 4, "prefill": 2}[step_kind]
    assert got["slopes"] == [slope]
    assert got["peak_bytes"] == 1000 + 60 + (cfg.n_layers - 2) * slope
    assert got["counts"]["output"] == 7 + (cfg.n_layers - 1) * 2

    enc = dataclasses.replace(configs.get("seamless-m4t-medium"),
                              enc_layers=5)
    plan = DR._depth_variants(enc)
    units = {(1, 1): 10, (2, 1): 13, (1, 2): 12, (2, 2): 15, (3, 2): 18,
             (2, 3): 16}
    traces = {DR._at(plan, u): _trace(t) for u, t in units.items()}
    got = DR.extrapolate(plan, traces, 100, step_kind)
    want = {"train": [3, 1], "decode": [3, 1], "prefill": [0, 0]}
    assert got["slopes"] == want[step_kind]
    assert got["peak_bytes"] == 100 + 15 + sum(
        (n - 2) * s for n, s in zip((12, 5), want[step_kind]))
