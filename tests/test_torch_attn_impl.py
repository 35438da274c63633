"""The attention schedule switch (``use_attn_impl`` / ``get_attn_impl``)
against the reference's, and the dry run's ``attn_impl`` knob.

Under ``use_attn_impl("qloop")`` ``flash_attention`` runs a stream per q
chunk over exactly its kv range.  On inputs drawn from numpy seeds
(causal, a window, non-causal, a ``kv_offset`` and a softcap):

* the port's q-loop against the reference's ``flash_attention`` under
  its own ``use_attn_impl("qloop")``: max|d| <= QLOOP_TOL * max|ref|,
  the forward and the gradients of ``sum(out * cot)`` (``jax.grad``);
* the port's q-loop against its pair loop: the same bits, forward and
  gradient (both visit the same pairs in the same order with the same
  operations; the reference's two schedules agree only to ~1e-5,
  since XLA fuses them apart);
* the switch: a name other than ``"pairs"`` / ``"qloop"`` raises, and
  the previous schedule comes back after an exception in the block;
* ``attend`` over DTensors runs the chosen schedule on each rank's
  shard;
* ``dryrun_cell(..., attn_impl=...)`` on minicpm-2b cut to 4 layers, a
  short prefill on the fake (16, 16) mesh, in a subprocess (PyTorch's
  fake process group must not enter a test worker): both records carry
  ``"attn_impl"``, every trace process reports the schedule it ran
  under, flops, collectives and the peak are the same, and the q-loop's
  unfused bytes are a little lower -- it divides each chunk's
  accumulator as the chunk ends, where the pair loop first stacks the
  chunks' sums -- which a trace that ignored the switch would not show.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.models import attention as TA

ROOT = pathlib.Path(__file__).resolve().parents[1]
QLOOP_TOL = 1e-5      # max|port - reference| <= QLOOP_TOL * max|reference|

# (sq, sk, hq, hkv, causal, window, softcap, q_chunk, k_chunk, kv_offset)
CASES = {
    "causal": (24, 24, 4, 2, True, None, 0.0, 8, 8, 0),
    "window": (24, 24, 6, 2, True, 7, 0.0, 8, 4, 0),
    "non-causal": (24, 24, 4, 1, False, None, 0.0, 8, 6, 0),
    "kv-offset": (8, 24, 4, 2, True, 10, 0.0, 4, 8, 16),
    "softcap": (24, 24, 4, 2, True, None, 4.0, 6, 8, 0),
}


def _inputs(case, seed=0):
    sq, sk, hq, hkv = case[:4]
    rng = np.random.default_rng(seed)
    shapes = ((2, sq, hq, 8), (2, sk, hkv, 8), (2, sk, hkv, 8),
              (2, sq, hq, 8))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _kw(case):
    _, _, _, _, causal, window, cap, qc, kc, off = case
    return dict(causal=causal, window=window, logit_softcap=cap,
                q_chunk=qc, k_chunk=kc, kv_offset=off)


def _port(case, impl):
    """The port's output and gradients of sum(out * cot) under ``impl``."""
    q, k, v, cot = _inputs(case)
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with TA.use_attn_impl(impl):
        out = TA.flash_attention(*qkv, **_kw(case))
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), qkv)
    return out.detach(), grads


def _reference(case):
    """The reference's q-loop output and ``jax.grad`` of sum(out * cot)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import attention as JA
    q, k, v, cot = (jnp.asarray(a) for a in _inputs(case))
    kw = _kw(case)

    def loss(a, b, c):
        out = JA.flash_attention(a, b, c, **kw)
        return jnp.sum(out * cot), out

    with JA.use_attn_impl("qloop"):      # read as the function traces
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, (0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= QLOOP_TOL * scale, f"{what}: {err} > {QLOOP_TOL} * {scale}"


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_qloop_matches_reference_qloop(case):
    out, grads = _port(case, "qloop")
    want, want_grads = _reference(case)
    _close(out.numpy(), want, "forward")
    for name, g, w in zip("qkv", grads, want_grads):
        _close(g.numpy(), w, f"d{name}")


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_qloop_equals_pair_loop_bit_for_bit(case):
    out_q, grads_q = _port(case, "qloop")
    out_p, grads_p = _port(case, "pairs")
    assert torch.equal(out_q, out_p)
    for name, a, b in zip("qkv", grads_q, grads_p):
        assert torch.equal(a, b), f"d{name}"


def test_switch_names_and_restores():
    assert TA.get_attn_impl() == "pairs"
    with pytest.raises(ValueError):
        with TA.use_attn_impl("flash"):
            pass
    assert TA.get_attn_impl() == "pairs"
    with pytest.raises(RuntimeError):
        with TA.use_attn_impl("qloop"):
            assert TA.get_attn_impl() == "qloop"
            with TA.use_attn_impl("pairs"):
                assert TA.get_attn_impl() == "pairs"
            assert TA.get_attn_impl() == "qloop"
            raise RuntimeError("inside the block")
    assert TA.get_attn_impl() == "pairs"


_SHARDED = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from torch.distributed import FileStore
    from torch.distributed.tensor import Shard
    from repro_torch.launch.mesh import join, make_mesh
    from repro_torch.models import attention as TA
    from repro_torch.models import sharding as S

    join("cpu", rank=0, world=1, store=FileStore(sys.argv[1], 1))
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 24, 4, 8), (2, 24, 2, 8), (2, 24, 2, 8)))
    streams = []
    plain_qloop = TA._flash_qloop

    def counted(*a, **kw):
        streams.append(1)
        return plain_qloop(*a, **kw)
    TA._flash_qloop = counted
    pl = [Shard(0), Shard(2)]
    out = {}
    for impl in ("pairs", "qloop"):
        n0 = len(streams)
        with TA.use_attn_impl(impl):
            y = TA.attend(*(S.place(t, mesh, pl) for t in (q, k, v)),
                          causal=True, window=7, q_chunk=8, k_chunk=8)
        out[impl] = {"streams": len(streams) - n0,
                     "dtensor": S.is_dtensor(y),
                     "equal_plain": torch.equal(
                         y.full_tensor(), TA.flash_attention(
                             q, k, v, causal=True, window=7, q_chunk=8,
                             k_chunk=8))}
    print("OUT " + json.dumps(out))
""")


def test_sharded_attend_runs_the_chosen_schedule(tmp_path):
    """``attend`` over DTensors (a one-rank gloo (1, 1) mesh, in a
    subprocess) runs the q-loop under ``use_attn_impl("qloop")`` -- one
    stream per call -- and the pair loop otherwise, both bit for bit the
    plain ``flash_attention``."""
    script = tmp_path / "sharded.py"
    script.write_text(_SHARDED)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script),
                           str(tmp_path / "store")], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("OUT "))
    rec = json.loads(line[4:])
    assert rec["pairs"] == {"streams": 0, "dtensor": True,
                            "equal_plain": True}
    assert rec["qloop"] == {"streams": 1, "dtensor": True,
                            "equal_plain": True}


_DRYRUN = textwrap.dedent("""
    import json
    from repro_torch import configs
    from repro_torch.launch.dryrun import dryrun_cell

    def main():
        configs.SHAPES["prefill_short"] = configs.ShapeConfig(
            "prefill_short", 256, 32, "prefill")
        out = {}
        for impl in ("pairs", "qloop"):
            rec = dryrun_cell("minicpm-2b", "prefill_short", "single",
                              q_chunk=64, k_chunk=64, attn_impl=impl,
                              overrides={"n_layers": 4})
            out[impl] = {k: rec[k] for k in (
                "status", "attn_impl", "flops_per_rank", "hlo_bytes_raw",
                "collective_raw", "memory", "cost")}
        print("OUT " + json.dumps(out))

    if __name__ == "__main__":
        main()
""")


def test_dryrun_cell_attn_impl_reaches_the_trace_processes(tmp_path):
    script = tmp_path / "cell.py"
    script.write_text(_DRYRUN)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("OUT "))
    rec = json.loads(line[4:])
    pairs, qloop = rec["pairs"], rec["qloop"]
    for impl, r in rec.items():
        assert r["status"] == "ok" and r["attn_impl"] == impl
        # the cell is deeper than the plan's configs: every count comes
        # from traces in processes forked from the forkserver
        assert r["cost"]["extrapolated"]
        assert [t["attn_impl"] for t in r["cost"]["traced"]] \
            == [impl] * len(r["cost"]["traced"])
    assert qloop["flops_per_rank"] == pairs["flops_per_rank"]
    assert qloop["collective_raw"] == pairs["collective_raw"]
    assert qloop["memory"] == pairs["memory"]
    assert qloop["hlo_bytes_raw"] < pairs["hlo_bytes_raw"]
    assert qloop["hlo_bytes_raw"] > (1 - 1e-3) * pairs["hlo_bytes_raw"]
