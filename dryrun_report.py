"""The dry run's tables, from the records a sweep wrote.

    PYTHONPATH=src python3 dryrun_report.py [--out experiments/dryrun_torch]
    PYTHONPATH=src python3 dryrun_report.py --short-prefill 2048

Reads ``OUT/<mesh>/<arch>__<shape>.json`` (``python -m
repro_torch.launch.dryrun``'s records, a cell a process; the sweep's
command is in the README) and prints, as markdown:

* every cell's record, a row per (config, shape) with both meshes:
  flops a rank, argument / peak / unfused / collective GiB, the
  variants' trace seconds, and the three-term roofline bound of a rank
  (``perf_model.roofline_terms(cost["flops"], cost["bytes"],
  cost["collective_bytes"], chips=1)``, H100) with its dominant term;
* in a last column, where ``OUT/full`` holds the cell's full-depth
  record on (16, 16) (``--no-cost``), the record against it: the
  largest relative gap of flops, unfused bytes and collective bytes,
  the gaps of the temporaries (peak less arguments) and of the peak,
  whether the collective counts, argument and output bytes are equal,
  and the full trace's seconds.

``--short-prefill N`` instead runs, for every config, a prefill of ``N``
tokens (batch 32) on the (16, 16) mesh at full depth, from the depth
plan and traced whole, and prints the same comparison: the prefill
shapes whose full depth traces in seconds.

It needs no card.  Every count is a CPU count of the rank's local
shapes, not a device measurement.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MESHES = ("single", "multi")
GIB = 2 ** 30
CARD_BYTES = 80 * 10 ** 9      # an H100's memory, as sold


def _cells():
    from repro_torch import configs
    return [(a, s, m) for m in MESHES for s in configs.SHAPES
            for a in configs.ARCH_IDS]


def _record(out: pathlib.Path, arch, shape, mesh):
    f = out / mesh / f"{arch}__{shape}.json"
    return json.loads(f.read_text()) if f.exists() else None


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1)


def _cell_row(rec) -> list:
    from repro_torch.core.perf_model import roofline_terms
    mem, c = rec["memory"], rec["cost"]
    rl = roofline_terms(c["flops"], c["bytes"], c["collective_bytes"],
                        chips=1)
    return [f"{rec['flops_per_rank']:.3e}",
            f"{mem['argument_size_in_bytes'] / GIB:.2f}",
            f"{mem['peak_bytes'] / GIB:.2f}",
            f"{rec['hlo_bytes_raw'] / GIB:.1f}",
            f"{rec['collective_raw']['total'] / GIB:.3f}",
            f"{rec['trace_s']}",
            f"{rl.bound_s * 1e3:.2f} {rl.dominant}"]


def tables(out: pathlib.Path) -> int:
    """Print the sweep's tables; returns the number of cells that ended
    neither ``ok`` nor ``skipped``."""
    from repro_torch import configs
    status = {}
    print("Each entry: (16, 16) / (2, 16, 16).  CPU count, no device.\n")
    print("| Config | Shape | flops a rank | args GiB | peak GiB | unfused "
          "GiB | coll GiB | trace s | bound ms | vs full trace: count / "
          "temp / peak gap, equal, s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    gaps = []
    for shape in configs.SHAPES:
        for arch in configs.ARCH_IDS:
            cols = []
            for mesh in MESHES:
                rec = _record(out, arch, shape, mesh)
                st = rec["status"] if rec else "missing"
                status[(arch, shape, mesh)] = st
                cols.append(_cell_row(rec) if st == "ok" else [st] * 7)
            if all(status[(arch, shape, m)] == "skipped" for m in MESHES):
                continue
            rec = _record(out, arch, shape, "single")
            full = _record(out / "full", arch, shape, "single")
            vs = "-"
            if full and rec and full["status"] == rec["status"] == "ok":
                g = _gaps(rec, full)
                gaps.append(g)
                vs = (f"{g[0]:.0e} / {g[2]:+.0e} / {g[3]:+.0e}, "
                      f"{g[1]}, {full['trace_s']}")
            print(f"| {arch} | {shape} | " + " | ".join(
                f"{a} / {b}" for a, b in zip(*cols)) + f" | {vs} |")
    if gaps:
        print(f"\n{len(gaps)} full traces; largest count gap "
              f"{max(g[0] for g in gaps):.1e}, largest temp gap "
              f"{max(abs(g[2]) for g in gaps):.2e}, largest peak gap "
              f"{max(abs(g[3]) for g in gaps):.2e}, all equal: "
              f"{all(g[1] for g in gaps)}")
    n = {k: sum(v == k for v in status.values()) for k in ("ok", "skipped")}
    bad = len(status) - n["ok"] - n["skipped"]
    print(f"\n{n['ok']} ok, {n['skipped']} skipped, {bad} neither\n")
    over = [f"{a} {s} {m}" for (a, s, m), st in status.items()
            if st == "ok" and _record(out, a, s, m)["memory"]["peak_bytes"]
            > CARD_BYTES]
    print(f"{len(over)} cells peak above a card's 80 GB: "
          f"{', '.join(over)}")
    return bad


def _gaps(rec, full) -> list:
    """The record against the full trace: the largest relative count
    gap, whether counts / arguments / output are equal, the temporaries'
    and the peak's relative gaps."""
    fm, em = full["memory"], rec["memory"]
    gap = max(_rel(rec["flops_per_rank"], full["flops_per_rank"]),
              _rel(rec["hlo_bytes_raw"], full["hlo_bytes_raw"]),
              _rel(rec["collective_raw"]["total"],
                   full["collective_raw"]["total"]))
    same = (rec["collective_raw"]["counts"]
            == full["collective_raw"]["counts"]
            and em["argument_size_in_bytes"] == fm["argument_size_in_bytes"]
            and em["output_size_in_bytes"] == fm["output_size_in_bytes"])
    return [gap, same,
            (em["temp_size_in_bytes"] - fm["temp_size_in_bytes"])
            / fm["temp_size_in_bytes"],
            (em["peak_bytes"] - fm["peak_bytes"]) / fm["peak_bytes"]]


def compare(pairs) -> None:
    """Print each ``(label, record, full trace)`` whose two ended ok."""
    rows = [(label, *_gaps(rec, full), full["trace_s"], rec["trace_s"],
             rec["cost"].get("wall_s"))
            for label, rec, full in pairs
            if full and rec and full["status"] == rec["status"] == "ok"]
    if not rows:
        return
    print("| Config | Shape | Mesh | largest count gap | counts, args, "
          "output equal | temp gap | peak gap | full trace s | variants s "
          "(sum) | wall s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        wall = f"{r[7]:.1f}" if r[7] is not None else "-"
        print(f"| {r[0]} | {r[1]:.1e} | {r[2]} | {r[3]:+.2e} | "
              f"{r[4]:+.2e} | {r[5]} | {r[6]} | {wall} |")
    print(f"\n{len(rows)} full traces; largest count gap "
          f"{max(r[1] for r in rows):.1e}, largest temp gap "
          f"{max(abs(r[3]) for r in rows):.2e}, largest peak gap "
          f"{max(abs(r[4]) for r in rows):.2e}, all equal: "
          f"{all(r[2] for r in rows)}")


def short_prefill(seq: int) -> None:
    """Every config's prefill of ``seq`` tokens on the (16, 16) mesh,
    from the depth plan against a trace of the full depth."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import dryrun_cell
    name = f"prefill_{seq}"
    configs.SHAPES[name] = configs.ShapeConfig(name, seq, 32, "prefill")
    pairs = [(f"{a} | {name} | single",
              dryrun_cell(a, name, "single"),
              dryrun_cell(a, name, "single", with_cost=False))
             for a in configs.ARCH_IDS]
    compare(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--short-prefill", type=int, default=None,
                    help="trace every config's prefill of this many "
                    "tokens both ways instead")
    args = ap.parse_args(argv)
    if args.short_prefill:
        short_prefill(args.short_prefill)
        return 0
    return 1 if tables(pathlib.Path(args.out).resolve()) else 0


if __name__ == "__main__":
    sys.exit(main())
