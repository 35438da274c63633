"""The model across cards (ROADMAP 1.28): the logical sharding rules and
the spec trees against the reference's.

One JAX subprocess (512 host devices, as the reference's dry run) dumps,
for all ten configs, smoke and published: ``param_specs`` /
``param_shapes``, ``cache_specs``, ``input_specs`` for every shape,
``zero1_specs`` and each param's ``NamedSharding.shard_shape`` on the
(16, 16) and (2, 16, 16) production meshes, ``rules_for`` over shape
kinds, batches and mesh shapes, and ``logical_to_pspec`` of every
logical spec.  One port subprocess (PyTorch's fake process group of 256
and 512 ranks, which must not enter a test worker) lays every published
param out on those meshes and reports its local shard shape.  The
reference stacks each period position's params over a leading layer
axis (spec ``None``); the port keeps one block per layer, so a stacked
reference leaf stands for each of its layers, its layer axis dropped.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch import configs as TCFG
from repro_torch.models import sharding as S
from repro_torch.models import transformer as TT
from repro_torch.models.api import build_model
from repro_torch.train import optimizer as TO

ARCHS = list(TCFG.ARCH_IDS)
KINDS = ("smoke", "published")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_REF = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from jax.sharding import NamedSharding
    from repro import configs
    from repro._compat import make_mesh
    from repro.models.api import build_model
    from repro.models.sharding import (DEFAULT_SINGLE_POD,
                                       DEFAULT_MULTI_POD, rules_for,
                                       use_rules, logical_to_pspec)
    from repro.train.optimizer import zero1_axis, zero1_specs

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, tuple))
        return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in p): v for p, v in leaves}

    def js(spec):
        return [list(a) if isinstance(a, tuple) else a for a in spec]

    meshes = {
        "single": (make_mesh((16, 16), ("data", "model")),
                   DEFAULT_SINGLE_POD, ("data",)),
        "multi": (make_mesh((2, 16, 16), ("pod", "data", "model")),
                  DEFAULT_MULTI_POD, ("pod", "data"))}
    out = {}
    for arch in configs.ARCH_IDS:
        for kind in ("smoke", "published"):
            cfg = configs.smoke(arch) if kind == "smoke" \\
                else configs.get(arch)
            m = build_model(cfg)
            box = {}

            def f():
                p, s = m._init(jax.random.PRNGKey(0))
                box["s"] = s
                return p
            shapes = flat(jax.eval_shape(f))
            specs = box["s"]
            rec = {"params": {k: js(v) for k, v in flat(specs).items()},
                   "shapes": {k: list(v.shape) for k, v in shapes.items()},
                   "dtypes": {k: str(v.dtype) for k, v in shapes.items()},
                   "cache": {k: js(v)
                             for k, v in flat(m.cache_specs()).items()},
                   "inputs": {}}
            small = kind == "smoke"
            for sname, sh in configs.SHAPES.items():
                b, s = m.input_specs(sh, seq_override=64 if small else None,
                                     batch_override=4 if small else None)
                rec["inputs"][sname] = {
                    "specs": {k: js(v) for k, v in flat(s).items()},
                    "shapes": {k: [list(v.shape), str(v.dtype)]
                               for k, v in flat(b).items()}}
            if not small:
                rec["zero1"], rec["shard_shapes"] = {}, {}
                for mname, (mesh, rules, daxes) in meshes.items():
                    with use_rules(rules):
                        z = zero1_specs(specs, jax.eval_shape(f), mesh,
                                        data_axes=daxes)
                    rec["zero1"][mname] = {k: js(v)
                                           for k, v in flat(z).items()}
                    ss = {}
                    for k, spec in flat(specs).items():
                        try:
                            ss[k] = list(NamedSharding(
                                mesh, logical_to_pspec(spec, rules)
                            ).shard_shape(tuple(shapes[k].shape)))
                        except Exception:
                            ss[k] = None
                    rec["shard_shapes"][mname] = ss
            out[arch + "/" + kind] = rec
    rules = {}
    for kind in ("train", "prefill", "decode"):
        for gb in (1, 4, 32, 128, 256):
            for ms in ({"data": 16, "model": 16},
                       {"pod": 2, "data": 16, "model": 16},
                       {"data": 2, "model": 2}, {"data": 4, "model": 1},
                       {"data": 3, "model": 2}):
                r = rules_for(kind, gb, ms)
                key = kind + "/" + str(gb) + "/" + json.dumps(ms,
                                                              sort_keys=True)
                rules[key] = {k: (list(v) if v else v) for k, v in r.items()}
    out["_rules"] = rules
    logical = set()
    for k, v in out.items():
        if not k.startswith("_"):
            for s in list(v["params"].values()) + list(v["cache"].values()):
                logical.add(tuple(s))
    variants = {"single": DEFAULT_SINGLE_POD, "multi": DEFAULT_MULTI_POD,
                "cp": rules_for("decode", 1, {"data": 16, "model": 16}),
                "host": {"batch": ("data",), "model": None,
                         "expert": None, "seq": None, "kvseq": None}}
    out["_pspecs"] = {
        name: {json.dumps(list(s)): js(tuple(logical_to_pspec(s, r)))
               for s in logical}
        for name, r in variants.items()}
    out["_zero1_axis"] = [
        js(zero1_axis((1024, 512), ("model", None), ["data"],
                      {"data": 16, "model": 16})),
        js(zero1_axis((8,), (None,), ["data"], {"data": 16})),
        js(zero1_axis((4096, 32), (None, None), ["pod", "data"],
                      {"pod": 2, "data": 16, "model": 16})),
        js(zero1_axis((48, 64, 32), (None, ("model",), None), ["data"],
                      {"data": 16, "model": 16})),
        js(zero1_axis((30, 40), (None, None), ["data"], {"data": 4}))]
    print("OUT " + json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import json, torch
    from repro_torch import configs
    from repro_torch.launch.dryrun import _fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import sharding as S
    from repro_torch.models.api import build_model
    out = {}
    for mname, multi in (("single", False), ("multi", True)):
        _fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        rules = S.DEFAULT_MULTI_POD if multi else S.DEFAULT_SINGLE_POD
        for arch in configs.ARCH_IDS:
            params = build_model(configs.get(arch), device="cpu"
                                 ).param_shapes()
            out[arch + "/" + mname] = {
                n: list(S.place(p.detach(), mesh, S.placements(
                    p.logical_axes, mesh, rules)).to_local().shape)
                for n, p in params.named_parameters()}
    print("OUT " + json.dumps(out))
""")


def _run(script, jax_env: bool):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    if jax_env:
        env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("OUT ")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def ref():
    return _run(_REF, True)


@pytest.fixture(scope="module")
def port_local():
    return _run(_PORT, False)


def _cfg(arch, kind):
    return TCFG.smoke(arch) if kind == "smoke" else TCFG.get(arch)


def _tup(spec):
    """A dumped spec as a tuple; a bare mesh-axis name (PartitionSpec's
    short form) as its 1-tuple, as the port writes it."""
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def _phys(spec):
    return tuple((a,) if isinstance(a, str) else a for a in _tup(spec))


def _stack_ref(path: str, plans: dict):
    """The reference path of the port's name ``path`` (its stacks one
    block per layer), and whether that leaf is stacked over periods."""
    parts = path.split(".")
    if parts[0] not in plans:
        return path, False
    plan, i, rest = plans[parts[0]], int(parts[1]), parts[2:]
    n_pre, k = len(plan.prefix_kinds), len(plan.period_kinds)
    if i < n_pre:
        return ".".join([parts[0], "prefix", str(i)] + rest), False
    if i < n_pre + plan.n_periods * k:
        return ".".join([parts[0], "periods", f"b{(i - n_pre) % k}"]
                        + rest), True
    return ".".join([parts[0], "suffix", str(i - n_pre - plan.n_periods * k)]
                    + rest), False


def _plans(cfg):
    plans = {"dec": TT.make_plan(cfg, cfg.n_layers)}
    if cfg.is_encdec:
        plans["enc"] = TT.make_plan(cfg, cfg.enc_layers,
                                    force_dense_pattern=True, moe_ok=False)
    return plans


def _ref_leaf(table: dict, name: str, plans: dict):
    path, stacked = _stack_ref(name, plans)
    v = table[path]
    return (v[1:] if stacked else v), stacked


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(ref, arch, kind):
    cfg = _cfg(arch, kind)
    model = build_model(cfg, device="cpu")
    specs = model.param_specs()
    shapes = dict(model.param_shapes().named_parameters())
    r, plans = ref[f"{arch}/{kind}"], _plans(cfg)
    seen = set()
    for name, spec in specs.items():
        path, stacked = _stack_ref(name, plans)
        seen.add(path)
        want = r["params"][path]
        if stacked:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert spec == _tup(want), (name, spec, want)
        shp = r["shapes"][path][1:] if stacked else r["shapes"][path]
        assert list(shapes[name].shape) == shp, name
        assert str(shapes[name].dtype).removeprefix("torch.") == \
            r["dtypes"][path], name
        assert shapes[name].device.type == "meta"
    assert seen == set(r["params"]), set(r["params"]) ^ seen


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(ref, arch, kind):
    cfg = _cfg(arch, kind)
    specs = build_model(cfg, device="cpu").cache_specs()
    plan = TT.make_plan(cfg, cfg.n_layers)
    r = ref[f"{arch}/{kind}"]["cache"]
    flat = {}
    for i, layer in enumerate(specs):
        for key, v in layer.items():
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    flat[f"dec.{i}.{key}.{k2}"] = v2
            else:
                flat[f"dec.{i}.{key}"] = v
    seen = set()
    for name, spec in flat.items():
        path, stacked = _stack_ref(name, {"dec": plan})
        path = path.removeprefix("dec.")
        seen.add(path)
        want = r[path]
        if stacked:
            assert want[0] is None
            want = want[1:]
        assert spec == _tup(want), (name, spec, want)
    assert seen == set(r)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(ref, arch, kind):
    cfg = _cfg(arch, kind)
    model = build_model(cfg, device="cpu")
    small = kind == "smoke"
    plan = TT.make_plan(cfg, cfg.n_layers)
    for sname, sh in TCFG.SHAPES.items():
        r = ref[f"{arch}/{kind}"]["inputs"][sname]
        batch, specs = model.input_specs(
            sh, seq_override=64 if small else None,
            batch_override=4 if small else None)
        got_specs, got_shapes = {}, {}
        for k, v in specs.items():
            if k == "cache":
                for i, layer in enumerate(v):
                    for c, sp in layer.items():
                        items = sp.items() if isinstance(sp, dict) \
                            else [(None, sp)]
                        for c2, sp2 in items:
                            name = f"dec.{i}.{c}" + (f".{c2}" if c2 else "")
                            t = batch["cache"][i][c]
                            t = t[c2] if c2 else t
                            got_specs[name] = sp2
                            got_shapes[name] = t
            else:
                got_specs[k], got_shapes[k] = v, batch[k]
        for name, spec in got_specs.items():
            if name.startswith("dec."):
                path, stacked = _stack_ref(name, {"dec": plan})
                path = "cache." + path.removeprefix("dec.")
            else:
                path, stacked = name, False
            want, (shp, dt) = r["specs"][path], r["shapes"][path]
            if stacked:
                want, shp = want[1:], shp[1:]
            t = got_shapes[name]
            assert spec == _tup(want), (sname, name)
            assert list(t.shape) == shp, (sname, name)
            assert str(t.dtype).removeprefix("torch.") == dt, (sname, name)
            assert t.device.type == "meta"


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_match_reference(ref, arch, mesh_name):
    cfg = TCFG.get(arch)
    model = build_model(cfg, device="cpu")
    shapes = {n: p.shape for n, p in model.param_shapes().named_parameters()}
    multi = mesh_name == "multi"
    mesh = ({"pod": 2, "data": 16, "model": 16} if multi
            else {"data": 16, "model": 16})
    rules = S.DEFAULT_MULTI_POD if multi else S.DEFAULT_SINGLE_POD
    with S.use_rules(rules):
        z = TO.zero1_specs(model.param_specs(), shapes, mesh,
                           data_axes=("pod", "data") if multi else ("data",))
    r, plans = ref[f"{arch}/published"]["zero1"][mesh_name], _plans(cfg)
    on_layers = 0
    for name, spec in z.items():
        want, stacked = _ref_leaf(r, name, plans)
        if stacked and r[_stack_ref(name, plans)[0]][0] is not None:
            # the reference put the data axes on its stacked layer axis,
            # which a per-layer leaf does not have (ROADMAP queue 3): the
            # port's spec is the reference's rule on the one layer
            with S.use_rules(rules):
                phys = S.logical_to_pspec(model.param_specs()[name])
            assert spec == _phys(TO.zero1_axis(
                tuple(shapes[name]), phys,
                [a for a in ("pod", "data") if a in mesh], mesh)), name
            assert _phys(want) == phys, name
            on_layers += 1
            continue
        assert spec == _phys(want), (name, spec, want)
    # only small leaves (biases, norms' scales) take that path
    assert on_layers <= len(z) // 2


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shard_shapes_match_reference(ref, port_local, arch,
                                            mesh_name):
    cfg = TCFG.get(arch)
    r = ref[f"{arch}/published"]["shard_shapes"][mesh_name]
    got = port_local[f"{arch}/{mesh_name}"]
    plans, compared = _plans(cfg), 0
    for name, shp in got.items():
        want, _ = _ref_leaf(r, name, plans)
        path, stacked = _stack_ref(name, plans)
        if r[path] is None:     # GSPMD pads a split that does not divide
            continue
        assert shp == (r[path][1:] if stacked else r[path]), name
        compared += 1
    assert compared >= 0.9 * len(got)


def test_rules_for_matches_reference(ref):
    for key, want in ref["_rules"].items():
        kind, gb, ms = key.split("/", 2)
        got = S.rules_for(kind, int(gb), json.loads(ms))
        assert {k: (list(v) if v else v) for k, v in got.items()} == want, \
            key


@pytest.mark.parametrize("variant", ["single", "multi", "cp", "host"])
def test_logical_to_pspec_matches_reference(ref, variant):
    rules = {"single": S.DEFAULT_SINGLE_POD, "multi": S.DEFAULT_MULTI_POD,
             "cp": S.rules_for("decode", 1, {"data": 16, "model": 16}),
             "host": {"batch": ("data",), "model": None, "expert": None,
                      "seq": None, "kvseq": None}}[variant]
    table = ref["_pspecs"][variant]
    assert len(table) > 20
    for spec, want in table.items():
        got = S.logical_to_pspec(tuple(json.loads(spec)), rules)
        assert got == _phys(want), (spec, got, want)
    assert S.logical_to_pspec(("batch", None)) == ()     # no rules


@pytest.mark.parametrize("case", range(5))
def test_zero1_axis_matches_reference(ref, case):
    args = [((1024, 512), ("model", None), ["data"],
             {"data": 16, "model": 16}),
            ((8,), (None,), ["data"], {"data": 16}),
            ((4096, 32), (None, None), ["pod", "data"],
             {"pod": 2, "data": 16, "model": 16}),
            ((48, 64, 32), (None, ("model",), None), ["data"],
             {"data": 16, "model": 16}),
            ((30, 40), (None, None), ["data"], {"data": 4})][case]
    assert TO.zero1_axis(*args) == _tup(ref["_zero1_axis"][case])
    # the same axes from the port's own spec form
    phys = tuple((a,) if isinstance(a, str) else a for a in args[1])
    assert _phys(TO.zero1_axis(args[0], phys, *args[2:])) == \
        _phys(ref["_zero1_axis"][case])


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    m = Mesh()
    assert S.pspec_placements(((("pod", "data")), None, ("model",)), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert S.pspec_placements((None, None), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="not in the mesh"):
        S.pspec_placements((("expert",),), m)
    with pytest.raises(ValueError, match="twice"):
        S.pspec_placements((("model",), ("model",)), m)
