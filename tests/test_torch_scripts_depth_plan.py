"""``chip_smoke.py``'s depth plan and its attention-switch phase, on the
CPU.

The plan (``GROUP_SIZES``, ``GROUP_DEPTH``, ``group_configs``): every
config a group builds keeps its published fields -- d_model, heads,
head dim, vocab, experts, the layer pattern -- and only its depth
(``n_layers``, an encoder's ``enc_layers``) may be cut, a multi-kind
pattern in whole periods with its prefix and suffix kinds kept; sAMG
runs at its published rows; the sparse FFN's group builds qwen2.5-14b
as published and times T = 4 and 128; the main training config,
minicpm-2b, keeps its published depth.  ``attn_impl_phases``
rehearses on a smoke config with a host-clock harness: the q-loop's
logits, cache and losses equal the pair loop's, no kernel launched.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch import configs as TCFG
from repro_torch.core import matrices as TM
from repro_torch.models.transformer import make_plan

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

GROUPS = ("slice8", "slice9", "slice10", "slice11", "slice12", "attn")
BUILT = [(g, role) for g in GROUPS for role in CS.group_configs(TCFG, g)]


@pytest.mark.parametrize("group, role", BUILT, ids=[f"{g}-{r}"
                                                    for g, r in BUILT])
def test_cut_config_keeps_every_width(group, role):
    cfg = CS.group_configs(TCFG, group)[role]
    pub = TCFG.get(cfg.name)
    flags = {"parallel_block": cfg.parallel_block}
    assert dataclasses.replace(cfg, n_layers=0, enc_layers=0, **flags) == \
        dataclasses.replace(pub, n_layers=0, enc_layers=0, **flags)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.vocab, cfg.n_experts, cfg.top_k, cfg.layer_pattern) == \
        (pub.d_model, pub.n_heads, pub.n_kv_heads, pub.resolved_head_dim,
         pub.vocab, pub.n_experts, pub.top_k, pub.layer_pattern)
    assert 1 <= cfg.n_layers <= pub.n_layers
    assert cfg.enc_layers <= pub.enc_layers
    assert (cfg.enc_layers >= 1) == (pub.enc_layers >= 1)
    plan, pub_plan = make_plan(cfg, cfg.n_layers), make_plan(pub,
                                                            pub.n_layers)
    # whole periods, the layers outside them kept
    assert (plan.prefix_kinds, plan.period_kinds, plan.suffix_kinds) == \
        (pub_plan.prefix_kinds, pub_plan.period_kinds, pub_plan.suffix_kinds)
    assert plan.n_periods >= 1
    cut = CS.GROUP_DEPTH.get(group, {}).get(role)
    if cut is None and group != "slice12":
        assert (cfg.n_layers, cfg.enc_layers) == (pub.n_layers,
                                                  pub.enc_layers)
    elif cut is not None:
        assert (cfg.n_layers, cfg.enc_layers) == cut


def test_published_sizes_where_the_plan_keeps_them():
    # sAMG at the paper's rows: every sAMG kernel row stays comparable
    assert CS.SAMG_SCALE == 1.0
    assert int(TM._PUBLISHED["sAMG"]["dim"] * CS.SAMG_SCALE) > 3_000_000
    # the sparse FFN: qwen2.5-14b as published, K5's split walk at T = 4
    # and 128 on its w1 and w2
    assert CS.group_configs(TCFG, "slice8")["lm"] == TCFG.get("qwen2.5-14b")
    assert CS.GROUP_SIZES["slice8"]["tokens"] == (4, 128)
    # the main training config at its published depth
    assert CS.group_configs(TCFG, "slice10")["main"] == \
        TCFG.get("minicpm-2b")
    assert "main" not in CS.GROUP_DEPTH.get("slice10", {})
    assert CS.GROUP_SIZES["slice10"]["steps_main"] >= 2
    # the switch's phase walks several q chunks at published width
    attn = CS.GROUP_SIZES["attn"]
    assert attn["seq"] // attn["chunk"] >= 2
    assert CS.group_configs(TCFG, "attn")["main"] == TCFG.get("minicpm-2b")


def test_budget_line_reads_against_the_limit():
    line = CS.budget_line({"slice6": 100.0, "training": 50.0}, 600.0)
    assert line == {"budget": {"groups_s": {"slice6": 100.0,
                                            "training": 50.0},
                               "total_s": 600.0, "limit_s": 1200,
                               "free_s": 600.0}}


_ATTN = textwrap.dedent("""
    import dataclasses, json, sys, types
    sys.path.insert(0, sys.argv[1])
    import torch
    import chip_smoke as CS
    from repro_torch import configs as TCFG

    def require(ok, what):
        if not ok:
            raise AssertionError(what)
    rows = {}
    none = {n: 0 for n in ("pjds_spmv", "pjds_spmm")}
    out = CS.attn_impl_phases(types.SimpleNamespace(
        dev=torch.device("cpu"), seed=0, require=require,
        emit=lambda phase, **f: rows.__setitem__(phase, f),
        counts=lambda: (dict(none), {}), reset_counts=lambda: None,
        plain_free=lambda calls, phase: None,
        cfgs={"main": dataclasses.replace(TCFG.smoke("minicpm-2b"),
                                          n_layers=2)},
        prefill_batch=2, batch=2, seq=32, chunk=8, prefill_reps=1,
        train_steps=2))
    print("OUT " + json.dumps({"rows": rows, "launches": out["launches"]},
                              default=str))
""")


def test_attn_impl_phase_rehearses_on_the_cpu(tmp_path):
    script = tmp_path / "attn.py"
    script.write_text(_ATTN)
    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, str(script), str(ROOT)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("OUT "))
    rows = json.loads(line[4:])["rows"]
    row = rows["attn:qloop:minicpm-2b-smoke"]
    assert row["logits_bit_equal"] and row["cache_bit_equal"]
    assert row["losses_bit_equal"] and len(row["losses"]) == 2
    assert row["q_chunks"] == 4
    assert not any(row["launches"].values())
    for impl in ("pairs", "qloop", "pairs_again"):
        assert len(row[impl]["step_ms"]) == 2
    assert len(row["qloop"]["prefill_ms_all"]) == 1
