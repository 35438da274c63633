#!/usr/bin/env python3
"""The sharded-against-one-device parity rows of ``dist_serve.py`` and
``dist_train.py`` alone, on four ranks: a numerics check after a change
to the model or the layouts, in a few minutes of four cards where the
two scripts take about twelve.

    python3 experiments/parity_rows.py                        # 4 cards
    python3 experiments/parity_rows.py --backend gloo --smoke # 4 CPU procs

Runs ``dist_serve.serve_parity`` over ``dist_serve.PARITY`` and
``dist_train.train_parity`` over ``dist_train.PARITY_ROWS``, each row in
the dtype the scripts hold it in, with TF32 off; then the Mamba rows
again in float32, reported and not held: the rounding floor that made
the scripts run them in float64 (``dist_train.PARITY_F64``).  A layout
fault parts the two devices by as much in float64 as in float32;
rounding parts them less.  Prints one JSON line per script, the cards'
``nvidia-smi`` line and last ``{"ok": ...}``; exits 1 if a held row
is out of its bound.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import dist_serve as DS  # noqa: E402
import dist_train as DT  # noqa: E402


def worker(rank: int, world: int, a: dict, store_path: str, out_dir: str,
           tag: str) -> None:
    sys.path.insert(0, str(DT.SRC))
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import mesh as LM
    from repro_torch.models import sharding as S

    dev = LM.join("cpu" if a["backend"] == "gloo" else None, rank=rank,
                  world=world, store=dist.FileStore(store_path, world),
                  timeout=datetime.timedelta(seconds=a["timeout"]))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def cfg_of(name, **kw):
        c = configs.smoke(name) if a["smoke"] else configs.get(name)
        return dataclasses.replace(c, **kw)

    out = {"serve": {}, "train": {}, "fails": []}
    for name, shape, b, s, max_len, layers in DS.PARITY:
        if a["smoke"]:
            b, s, max_len = DS.SMOKE_PARITY.get(name, (b, 16, 48))
        held = DS.PARITY_DTYPE.get(name, DT.PARITY_F32)
        for dt in [held] + ([DT.PARITY_F32] if held != DT.PARITY_F32
                            else []):
            cfg = cfg_of(name, n_layers=layers, **dt)
            row, fail = DS.serve_parity(cfg, shape, b, s,
                                        max_len or s + DS.PARITY_STEPS,
                                        dev, rank)
            row["held"] = dt is held
            out["serve"][f"{cfg.name}:{cfg.param_dtype}"] = row
            if fail and row["held"]:
                out["fails"].append(fail)
    seq = 32 if a["smoke"] else 256
    rules = dict(S.DEFAULT_SINGLE_POD)
    for _, name, shape, held in DT.PARITY_ROWS:
        for dt in [held] + ([DT.PARITY_F32] if held != DT.PARITY_F32
                            else []):
            cfg = cfg_of(name, n_layers=2, **dt)
            row, fail = DT.train_parity(cfg, shape, dev, rank, seq, rules)
            row["held"] = dt is held
            out["train"][f"{cfg.name}:{cfg.param_dtype}"] = row
            if fail and row["held"]:
                out["fails"].append(fail)
    (pathlib.Path(out_dir) / f"{tag}_rank{rank}.json").write_text(
        json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--smoke", action="store_true",
                    help="the families' smoke configs (rehearsal)")
    ap.add_argument("--timeout", type=int, default=600)
    a = ap.parse_args()
    import torch
    if a.backend == "nccl" and torch.cuda.device_count() < DT.RANKS:
        print(f"parity_rows: {DT.RANKS} ranks need {DT.RANKS} CUDA cards",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="parity_rows_") as tmp:
        ranks = DT.run_world(torch.multiprocessing.get_context("spawn"),
                             DT.RANKS, vars(a), tmp, "parity",
                             time.monotonic() + a.timeout, target=worker,
                             name="parity_rows")
    if ranks is None:
        return 1
    label = "smoke" if a.smoke else "published"
    for key in ("serve", "train"):
        print(json.dumps({"phase": f"parity_rows:{key}", "configs": label,
                          "rows": ranks[0][key]}), flush=True)
    if a.backend == "nccl":
        print(DT.nvidia_smi_line(), flush=True)
    fails = ranks[0]["fails"]
    if fails:
        print(f"parity_rows: failed: {fails}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "backend": a.backend, "ranks": DT.RANKS,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
