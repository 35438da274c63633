"""The reductions that the metric files (``bench_port/metrics/<name>.py``)
apply to a driver's record.  Each returns None where the record holds
nothing to read, and the harness then leaves the metric out."""
from __future__ import annotations

from bench_port import roofline as RF
from bench_port.tracing import idle_share

__all__ = ["setup_s", "solve_ms", "gflops", "operand_bytes_per_nnz",
           "stored_slots_per_nnz", "span_s", "mean_of_solves",
           "cg_iter_roofline", "cg_kernel_roofline", "span_roofline",
           "enqueue_us", "exchange_ms", "idle_share"]


def setup_s(rec):
    return rec.get("setup_s")


def solve_ms(rec):
    """The window's milliseconds over the solves that ended converged
    and certified in it."""
    ok = sum(1 for s in rec.get("solves", ()) if s["ok"])
    return 1e3 * rec["window_s"] / ok if ok else None


def gflops(rec):
    """2 nnz per product, all products of the window, over the window."""
    p = rec.get("products")
    if not p:
        return None
    return 2.0 * rec["nnz"] * p / rec["window_s"] / 1e9


def operand_bytes_per_nnz(rec):
    b = rec.get("operand_bytes")
    return None if b is None else b / rec["nnz"]


def stored_slots_per_nnz(rec):
    s = rec.get("stored_slots")
    return None if s is None else s / rec["nnz"]


def span_s(rec, name):
    t = rec.get("spans", {}).get(name)
    return float(sum(t)) if t else None


def mean_of_solves(rec, key):
    vals = [s[key] for s in rec.get("solves", ()) if s.get(key) is not None]
    return sum(vals) / len(vals) if vals else None


def cg_iter_roofline(rec):
    """% of the bandwidth bound of the window's CG iterations, over the
    whole window (right-hand sides, host reads and certification in)."""
    if not rec.get("iters"):
        return None
    b = RF.bound_seconds(RF.cg_iteration_bytes(rec["n_rows"], rec["nnz"]))
    return 100.0 * b * rec["iters"] / rec["window_s"]


def cg_kernel_roofline(rec):
    """% of the bandwidth bound of the card-only slice's CG iterations,
    over the card's busy time in that slice."""
    tr = (rec.get("trace") or {}).get("card_only")
    if not tr or not tr.get("iters") or not tr.get("busy_s"):
        return None
    b = RF.bound_seconds(RF.cg_iteration_bytes(rec["n_rows"], rec["nnz"]))
    return 100.0 * b * tr["iters"] / tr["busy_s"]


def span_roofline(rec, span):
    """% of the bandwidth bound of one product (A x or A^T y) over the
    device time of the operations launched inside the span ``span``."""
    tr = rec.get("trace")
    if not tr:
        return None
    t = tr["span_device_s"].get(span)
    n = tr["span_calls"].get(span)
    if not t or not n:
        return None
    b = RF.bound_seconds(RF.spmv_bytes(rec["n_rows"], rec["n_cols"],
                                       rec["nnz"]))
    return 100.0 * b * n / t


def enqueue_us(rec):
    e = rec.get("enqueue_s")
    return None if e is None else 1e6 * e


def exchange_ms(rec):
    """Rank 0's device milliseconds in NCCL kernels per product."""
    tr = rec.get("trace")
    if not tr or not tr.get("calls") or not tr.get("nccl_s"):
        return None
    return 1e3 * tr["nccl_s"] / tr["calls"]
