"""The benchmark's driver: one run of one cell.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name in
``BENCHMARK.json`` at the checkout's root:

* the configuration's ``file`` (``bench_port/configs/<name>.json``)
  names a generator of ``generators.py`` and its arguments, and the
  value type the matrix is stored in;
* the traffic mix is ``bench_port/traffic/<name>.json``; its ``kind``
  names the driver (``bench_port/drivers/<kind>.py``) that runs it, and
  the rest of it is that driver's parameters;
* each metric is read by ``bench_port/metrics/<metric name>.py``
  (``read(record) -> float | None``) from the driver's record;
* the limits of the numbers compared with the reference are
  ``bench_port/limits/<cell name>.json``.

So a cell or a metric is added with files and ``BENCHMARK.json``
entries alone.  A run makes its inputs from ``--seed``, sets up (the
generator, the card, the kernels from the checkout's build directory,
the program's set-up, a warm call of the cell's own shape), measures
for ``--seconds`` seconds, checks what the timed calls produced against
the reference, and prints an earlier line ``{"run": {...}}`` and then
the result as the last line of standard output.  With ``--trace 1`` a
profiled slice runs before the window, and the metrics are the cell's
per-layer ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import pathlib
import platform
import subprocess
import sys
import time

import numpy as np

__all__ = ["main", "run_cell", "Ctx", "forbidden_modules", "find_cell",
           "metrics_of_cell", "sub_seed"]

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules that are JAX, its libraries or
    the JAX package (and its bench), compared whole: ``repro_torch`` is
    not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed derived from the run's seed and a stream's keys."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *keys])
    return int(ss.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def _read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell ``name`` with its configuration (manifest entry and
    file), traffic mix and limits."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(cells[name])
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    cell["config_entry"] = conf
    cell["config_data"] = _read_json(root / conf["file"])
    cell["traffic_data"] = _read_json(
        root / "bench_port" / "traffic" / f"{cell['traffic']}.json")
    cell["limits"] = _read_json(root / "bench_port" / "limits"
                                / f"{name}.json")["limits"]
    return cell


def metrics_of_cell(manifest: dict, name: str, trace: bool) -> list:
    """The manifest's metrics that cell ``name`` reports: its end-to-end
    ones, or with ``trace`` its per-layer ones (those that list it, or
    that list no cells and move a metric the cell reports)."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def _reader(metric: str, root: pathlib.Path):
    path = root / "bench_port" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_port.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(spec):
    """``"module:function"`` -> the function (a test's fault hook), or
    None."""
    if spec is None:
        return None
    mod, _, fn = spec.partition(":")
    return getattr(importlib.import_module(mod), fn)


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell, the run's arguments, the device
    (for a driver that starts rank processes, the kind of card they
    take), the clock of the process's start, and a test's fault hook as
    ``"module:function"`` (:func:`resolve`; ``fault(point, value)``
    returns the value the run goes on with: the four-rank driver offers
    each rank's communicator, as ``"comm"``)."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    device: object
    age_at_top: float
    t_top: float
    tmpdir: str
    root: pathlib.Path = ROOT
    fault: str | None = None
    overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def traffic(self) -> dict:
        return self.cell["traffic_data"]

    @property
    def config(self) -> dict:
        c = dict(self.cell["config_data"])
        c["args"] = {**c["args"], **self.overrides}
        return c

    def setup_s_now(self) -> float:
        return self.age_at_top + (time.perf_counter() - self.t_top)

    def seed_of(self, *keys: int) -> int:
        return sub_seed(self.seed, *keys)

    def generate(self):
        """The configuration's CSR arrays from the run's seed, values in
        the configuration's storage type."""
        from bench_port import generators as G
        c = self.config
        indptr, indices, data, shape = G.generate(
            c["generator"], c["args"], self.seed_of(0))
        return indptr, indices, data.astype(c["value_dtype"]), shape


def _setup_env(root: pathlib.Path) -> str:
    """Caches inside the checkout or the run's TMPDIR; no tuning result
    outlives a run; no library loads JAX for the program."""
    tmp = os.environ.get("TMPDIR") or "/tmp"
    tune = pathlib.Path(tmp) / "bench_port_tune_cache.json"
    tune.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(tune)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "bench_port"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "bench_port"
                                         / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    for p in (str(root), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    return tmp


def card_info() -> dict:
    """``nvidia-smi``'s name, power limit and clocks, and the host's CPU
    model and load."""
    out = {}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        out["nvidia_smi"] = q.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    try:
        with open("/proc/cpuinfo") as f:
            info = [ln.split(":", 1) for ln in f if ":" in ln]
        keys = ("model name", "cpu model", "hardware", "cpu part")
        out["cpu"] = next((v.strip() for k, v in info
                           if k.strip().lower() in keys), platform.machine())
        with open("/proc/loadavg") as f:
            out["loadavg"] = f.read().split()[:3]
        out["cpus"] = os.cpu_count()
    except OSError:
        pass
    return out


def _checks(rec: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: each number compared
    must be there, finite and at most its limit."""
    got = rec.get("compared", {})
    out, ok = {}, bool(got)
    for name, limit in limits.items():
        v = got.get(name)
        out[name] = {"value": v, "limit": limit}
        if v is None or not math.isfinite(v) or v > limit:
            ok = False
    return ok, out


def finish(ctx: Ctx, manifest: dict, rec: dict, out=sys.stdout,
           err=sys.stderr) -> int:
    """Read the metrics, print the run's lines; exit code."""
    correct, checks = _checks(rec, ctx.cell["limits"])
    metrics = {}
    for m in metrics_of_cell(manifest, ctx.workload, ctx.trace):
        v = _reader(m["name"], ctx.root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    found = forbidden_modules()
    found += [f"{r}: {n}" for r, ns in rec.get("rank_forbidden", {}).items()
              for n in ns]
    if found:
        print(f"forbidden modules loaded: {found}", file=err)
        return 3
    device = {"platform": "gpu" if rec.get("device_kind") else "cpu",
              "kind": rec.get("device_kind"), "count": ctx.cell["chips"],
              "memory_peak_bytes": rec.get("memory_peak_bytes")}
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": device}
    tr = rec.get("trace")
    if ctx.trace and tr:
        # the card-only slice's, averaged over the cards where several ran
        card = tr.get("card_only") or tr
        device["busy_s"], device["window_s"] = rec.get(
            "device_busy", (card["busy_s"], card["window_s"]))
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    run = {"workload": ctx.workload, "seed": ctx.seed,
           "seconds": ctx.seconds, "trace": int(ctx.trace),
           **card_info(), **rec.get("info", {})}
    print(json.dumps({"run": run}), file=out)
    print(json.dumps(result), file=out)
    out.flush()
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    return 0


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: pathlib.Path = ROOT, device=None, fault=None,
             overrides=None, age_at_top: float = 0.0, t_top=None,
             out=sys.stdout, err=sys.stderr) -> int:
    """One run of ``workload``.  ``device``, ``fault`` and ``overrides``
    (generator arguments) are for the tests: the command line runs on
    the card, at the configuration's size, with no fault."""
    t_top = time.perf_counter() if t_top is None else t_top
    manifest = _read_json(root / "BENCHMARK.json")
    cell = find_cell(manifest, workload, root)
    tmp = _setup_env(root)
    t0 = time.perf_counter()
    import torch
    parts = {"before_torch_s": age_at_top + (t0 - t_top),
             "import_torch_s": time.perf_counter() - t0}
    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell["chips"]:
            print(f"{workload} needs {cell['chips']} CUDA card(s); "
                  f"this machine has {n}", file=err)
            return 2
        device = torch.device("cuda", 0)
    ctx = Ctx(workload=workload, seed=seed, seconds=seconds, trace=trace,
              cell=cell, device=torch.device(device), age_at_top=age_at_top,
              t_top=t_top, tmpdir=tmp, root=root, fault=fault,
              overrides=dict(overrides or {}))
    driver = importlib.import_module(
        f"bench_port.drivers.{cell['traffic_data']['kind']}")
    rec = driver.run(ctx)
    rec.setdefault("info", {})["setup_parts"] = parts
    return finish(ctx, manifest, rec, out=out, err=err)


def main(argv=None, *, age_at_top: float = 0.0, t_top=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    return run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                    age_at_top=age_at_top, t_top=t_top)
