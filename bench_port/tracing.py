"""Spans around the calls into the program, and the reduction of a
``torch.profiler`` trace to device numbers.

Spans are the benchmark's own: :class:`Spans` times each call into a
layer on the host clock (generate, tune, build, each solve, each
product) and, while a trace slice records, marks it with
``torch.profiler.record_function("bench.<name>")``.  The program is not
instrumented here.

:func:`summarize` reads the Chrome trace that ``torch.profiler`` exports
over one slice of the run (wrapped in the span ``bench.slice``):

* ``window_s``: the slice's length, ``busy_s``: the time in which any
  operation (kernel, copy, fill) ran on the card, the union over
  streams (with the profiler's host cost in: :func:`device_busy` reads
  a second, card-only slice for the idle share);
* ``span_device_s``: per span name, the device time of the operations
  that were launched inside that span, matched through the launch's
  correlation id;
* ``device_ops``: device seconds by operation name; ``idle_gaps``: the
  idle time of the card by what the host was doing at the start of each
  gap (the innermost span, and the innermost operator inside it).
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import time

__all__ = ["Spans", "TraceSlice", "summarize", "device_busy", "idle_share",
           "top"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Host seconds per span name (``times[name]`` one entry a call);
    ``mark`` turns the profiler annotation on for a traced slice."""

    def __init__(self):
        self.times = collections.defaultdict(list)
        self.mark = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.mark:
            import torch
            ctx = torch.profiler.record_function("bench." + name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.times[name].append(time.perf_counter() - t0)

    def total(self, name: str) -> float | None:
        t = self.times.get(name)
        return float(sum(t)) if t else None


class TraceSlice:
    """``with TraceSlice(spans, device, path) as ts: ...`` profiles the
    body (synchronised at both ends) and leaves :func:`summarize`'s dict
    in ``ts.summary``; the exported trace file is removed after it is
    read.

    With ``host=False`` only the card's operations are recorded (no
    host events, no spans, so none of the profiler's host cost per
    operator), the window is the host clock's from synchronisation to
    synchronisation, and the summary holds ``window_s`` and ``busy_s``
    alone: the idle share as the untraced loop has it.  That slice needs
    a card; without one ``summary`` stays None."""

    def __init__(self, spans: Spans, device, path: str, host: bool = True):
        self.spans, self.device, self.path = spans, device, path
        self.host = host
        self.enabled = host or device.type == "cuda"
        self.summary = None

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU] if self.host else []
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        if self.host:
            self.spans.mark = True
            self.ann = torch.profiler.record_function("bench.slice")
            self.ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self.t0
        if self.host:
            self.ann.__exit__(None, None, None)
            self.spans.mark = False
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(self.path)
            try:
                with open(self.path) as f:
                    trace = json.load(f)
            finally:
                os.remove(self.path)
            self.summary = (summarize(trace) if self.host
                            else device_busy(trace, window))
        return False


def device_busy(trace: dict, window_s: float) -> dict:
    """``{"window_s", "busy_s"}`` of a card-only trace: the union of its
    operations' intervals over the host clock's window."""
    dev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"
           and e.get("cat") in _DEVICE_CATS]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev])
    return {"window_s": window_s,
            "busy_s": sum(e - s for s, e in busy) * 1e-6}


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class _Cover:
    """The innermost of a set of (start, end, name) events (µs) that
    covers a time: the shortest among the last 64 to start before it
    (host events nest, so a covering one started recently)."""

    def __init__(self, events):
        self.events = sorted(events)
        self.starts = [e[0] for e in self.events]

    def find(self, t):
        i = bisect.bisect_right(self.starts, t)
        best = None
        for s, e, name in self.events[max(0, i - 64):i]:
            if e >= t and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return None if best is None else best[2]


def summarize(trace: dict) -> dict:
    """Device numbers of one exported slice (see the module docstring).
    Times in the result are seconds."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    sl = [e for e in evs if e.get("name") == "bench.slice"
          and e.get("cat") == "user_annotation"]
    if not sl:
        raise ValueError("the trace holds no bench.slice span")
    w0 = float(sl[0]["ts"])
    w1 = w0 + float(sl[0]["dur"])
    dev = [e for e in evs if e.get("cat") in _DEVICE_CATS]
    ivals = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]),
                                           w1)) for e in dev]
    busy = _union([(s, e) for s, e in ivals if e > s])
    busy_us = sum(e - s for s, e in busy)

    by_name = collections.defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) * 1e-6

    # launches inside each bench span -> their operations' device time
    anns = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("tid")) for e in evs
            if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("bench.")
            and e["name"] != "bench.slice"]
    dev_by_corr = collections.defaultdict(float)
    for e in dev:
        c = (e.get("args") or {}).get("correlation")
        if c is not None:
            dev_by_corr[c] += float(e["dur"])
    launches = sorted((float(e["ts"]), e.get("tid"),
                       (e.get("args") or {}).get("correlation"))
                      for e in evs if e.get("cat") in _LAUNCH_CATS)
    span_us = collections.defaultdict(float)
    span_calls = collections.Counter()
    starts = [t for t, _, _ in launches]
    for s, e, name, tid in anns:
        span_calls[name[len("bench."):]] += 1
        lo = bisect.bisect_left(starts, s)
        hi = bisect.bisect_right(starts, e)
        for t, ltid, corr in launches[lo:hi]:
            if ltid == tid and corr is not None:
                span_us[name[len("bench."):]] += dev_by_corr.get(corr, 0.0)

    # idle gaps, named by the host's innermost span and operator
    host_spans = _Cover([(s, e, n) for s, e, n, _ in anns])
    ops = _Cover([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in evs if e.get("cat") == "cpu_op"])
    gaps = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 - g0 <= 0:
            continue
        span = host_spans.find(g0) or "outside any span"
        op = ops.find(g0)
        gaps[span + (f" > {op}" if op else "")] += (g1 - g0) * 1e-6

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": top(by_name),
        "idle_gaps": top(gaps),
        "span_device_s": {k: v * 1e-6 for k, v in span_us.items()},
        "span_calls": dict(span_calls),
        "n_device_events": len(dev),
        "n_launches": len(launches),
        "nccl_s": sum(v for k, v in by_name.items() if "nccl" in k.lower()),
    }


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest entries of ``{name: seconds}``, as
    ``[[name, seconds], ...]``."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def idle_share(rec: dict) -> float | None:
    """The share of the card-only slice, in %, in which no operation ran
    on the card (rank 0's where several ran)."""
    b = (rec.get("trace") or {}).get("card_only")
    if not b or not b["busy_s"]:
        return None
    return 100.0 * (1.0 - b["busy_s"] / b["window_s"])
