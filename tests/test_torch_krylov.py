"""The fused Krylov loop on the device: the scalar steps and vector
updates of ``kernels/krylov_step.py`` and the chunked drive of
``core/solvers.py``.

* Each plain step (``ref.krylov_step_ref``, float32 0-d tensor ops)
  against the numpy float32 recurrences it replaces -- the host loop's
  CG step and the reference's BiCGStab body, ``_health`` and the exit
  test included -- bit for bit, on a table of inputs: zeros,
  subnormals, NaN / Inf, p.Ap <= 0, divergence, checkpoints at
  ``since`` 499 / 500 / 999 / 1000, ``tol <= 0``, the last iteration,
  and a loop already done.  Bits: equal, or NaN on both sides (NaN
  payloads differ between CPUs and the card).
* Each plain update against numpy with one rounding per operation, bit
  for bit; nothing moves while its flag is set.
* The chunked drive: chunk 1, 7 and 32 give the same x bit for bit and
  the same iterations (masked iterations after the exit change
  nothing), for fused CG and fused BiCGStab.
* On a CUDA card: the step kernels bit-equal to the plain versions on
  the same table, the update kernels bit-equal, K3 with ``done`` clear
  equal to K3 without it and with ``done`` set writing nothing, the
  graph drive at chunk 1 and 32 identical, and no plain call.
"""
import math

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import matrices as TM
from repro_torch.core import solvers as TS
from repro_torch.kernels import fused_iter as TFI
from repro_torch.kernels import krylov_step as KS
from repro_torch.kernels import ref as TR

F32 = np.float32
NAN, INF = float("nan"), float("inf")

# ---- the numpy recurrences ---------------------------------------------
_FS = {"tol": TR.FS_TOL, "b2": TR.FS_B2, "rs": TR.FS_RS,
       "best": TR.FS_BEST, "alpha": TR.FS_ALPHA, "beta": TR.FS_BETA,
       "omega": TR.FS_OMEGA, "rho": TR.FS_RHO, "rhat_v": TR.FS_RHAT_V}
_IS = {"k": TR.IS_K, "maxiter": TR.IS_MAXITER, "flag": TR.IS_FLAG,
       "since": TR.IS_SINCE, "done": TR.IS_DONE, "skip": TR.IS_SKIP}


def _flush(a):
    a = np.asarray(a, F32)
    return np.where(np.abs(a) < np.finfo(F32).tiny, F32(0), a).astype(F32)


def _exit(st):
    """The loop's head test, after an iteration."""
    st["k"] += 1
    go = (st["flag"] == 0 and TS._not_done(st["rs"] / st["b2"], st["tol"])
          and st["k"] < st["maxiter"])
    st["done"] = int(not go)


def np_init(st, dots, tol, maxiter):
    rs, bb = _flush(dots[:2])
    b2 = np.maximum(bb, TS._TINY)
    flag, best, since = TS._health_init(rs / b2, tol)
    one = F32(1)
    st.update(tol=F32(tol), maxiter=maxiter, rs=rs, b2=b2, best=F32(best),
              flag=flag, since=since, k=0, rho=rs, alpha=one, omega=one,
              beta=(rs / TS._safe(rs)) * (one / TS._safe(one)))
    go = flag == 0 and TS._not_done(rs / b2, tol) and 0 < maxiter
    st["done"] = st["skip"] = int(not go)


def np_cg(st, dots):
    """The host loop's fused-CG step (one K3 pass read back)."""
    st["skip"] = st["done"]
    if st["done"]:
        return
    pap, r_ap, apap, rr, _ = _flush(dots)
    check = st["tol"] > 0
    bad = check and bool(pap <= 0 or not np.isfinite(pap))
    alpha = F32(0) if bad else rr / TS._nz(pap)
    rs = np.maximum(rr - F32(2) * alpha * r_ap + alpha * alpha * apap,
                    F32(0))
    st["flag"], st["best"], st["since"] = TS._health(
        st["flag"], rs / st["b2"], st["best"], st["since"], breakdown=bad,
        check=check)
    st.update(alpha=alpha, beta=rs / np.maximum(rr, TS._TINY), rs=rs)
    _exit(st)


def np_bicg1(st, dots):
    if st["done"]:
        return
    rhat_v = _flush(dots)[0]
    st.update(rhat_v=rhat_v, alpha=st["rho"] / TS._safe(rhat_v))


def np_bicg2(st, dots):
    """The reference's fused-BiCGStab body after its second pass."""
    st["skip"] = st["done"]
    if st["done"]:
        return
    t_rhat, t_s, tt, ss, rhat_s = _flush(dots)
    check = st["tol"] > 0
    omega = t_s / TS._safe(tt)
    rs = np.maximum(ss - F32(2) * omega * t_s + omega * omega * tt, F32(0))
    rho = st["rho"]
    rho_next = rhat_s - omega * t_rhat
    bad = bool(abs(rho) <= TS._TINY or abs(st["rhat_v"]) <= TS._TINY
               or abs(tt) <= TS._TINY)
    st["flag"], st["best"], st["since"] = TS._health(
        st["flag"], rs / st["b2"], st["best"], st["since"], breakdown=bad,
        check=check)
    st.update(beta=(rho_next / TS._safe(rho)) * (st["alpha"]
                                                / TS._safe(omega)),
              omega=omega, rho=rho_next, rs=rs)
    _exit(st)


_NP_STEP = {TR.STEP_CG: np_cg, TR.STEP_BICG1: np_bicg1,
            TR.STEP_BICG2: np_bicg2}

# ---- the table of inputs -----------------------------------------------
_DOTS = {
    "normal": [3.25, -1.5, 7.0, 2.0, 0.3],
    "zeros": [0.0, 0.0, 0.0, 0.0, 0.0],
    "subnormal": [1e-40, 2e-41, 1e-39, 3e-40, -1e-41],
    "half_subnormal": [2.5, 1e-40, 1.0, 3e-40, 0.75],
    "negative_pap": [-2.0, 1.0, 3.0, 5.0, 0.0],
    "nan": [NAN, 1.0, 1.0, 1.0, 0.0],
    "inf": [1.0, 1.0, INF, INF, 1.0],
    "diverge": [1.0, 0.0, 0.0, 1e13, 0.0],
    "tiny": [1e-31, 1e-20, 1e-36, 1e-32, 1e-31],
    "converging": [2.0, 1.0, 0.5, 1.0, -0.5],
}

_STATES = {
    "fresh": {},
    "since_499_progress": dict(since=499, best=1e3),
    "since_499_stall": dict(since=499, best=1e-30),
    "since_500": dict(since=500, best=1e-30),
    "since_999_stall": dict(since=999, best=1e-30),
    "since_1000": dict(since=1000, best=1e-30),
    "tol_0": dict(tol=0.0),
    "tol_negative": dict(tol=-1.0),
    "last_iteration": dict(k=99),
    "done": dict(done=1),
    "flagged": dict(flag=3),
}


def _state(**over):
    st = dict(tol=F32(1e-5), b2=F32(1.0), rs=F32(4.0), best=F32(1.0),
              alpha=F32(0.5), beta=F32(0.25), omega=F32(0.75),
              rho=F32(1.5), rhat_v=F32(2.0), k=3, maxiter=100, flag=0,
              since=7, done=0, skip=0)
    st.update({k: (F32(v) if k in _FS else v) for k, v in over.items()})
    return st


def _tensors(st, device="cpu"):
    fs, is_ = KS.new_state(device)
    for k, i in _FS.items():
        fs[i] = torch.tensor(st[k], dtype=torch.float32)
    for k, i in _IS.items():
        is_[i] = int(st[k])
    return fs, is_


def _same_bits(a, b):
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    return bool(np.all((a.view(np.int32) == b.view(np.int32))
                       | (np.isnan(a) & np.isnan(b))))


def _assert_state(fs, is_, st):
    fs, is_ = fs.cpu().numpy(), is_.cpu().numpy()
    for k, i in _FS.items():
        assert _same_bits(fs[i], st[k]), (k, fs[i], st[k])
    for k, i in _IS.items():
        assert int(is_[i]) == int(st[k]), (k, is_[i], st[k])


def _dots(name):
    return torch.tensor(_DOTS[name], dtype=torch.float32)


@pytest.mark.parametrize("state", sorted(_STATES))
@pytest.mark.parametrize("dots", sorted(_DOTS))
def test_plain_cg_step_is_the_numpy_recurrence(dots, state):
    st = _state(**_STATES[state])
    fs, is_ = _tensors(st)
    TR.krylov_step_ref(TR.STEP_CG, fs, is_, _dots(dots))
    with np.errstate(all="ignore"):
        np_cg(st, _DOTS[dots])
    _assert_state(fs, is_, st)


@pytest.mark.parametrize("state", ["fresh", "since_999_stall", "tol_0",
                                   "last_iteration", "done", "flagged"])
@pytest.mark.parametrize("dots", sorted(_DOTS))
def test_plain_bicgstab_steps_are_the_numpy_recurrence(dots, state):
    # pass one's step, then pass two's on the same dots
    st = _state(**_STATES[state])
    fs, is_ = _tensors(st)
    with np.errstate(all="ignore"):
        for kind in (TR.STEP_BICG1, TR.STEP_BICG2):
            TR.krylov_step_ref(kind, fs, is_, _dots(dots))
            _NP_STEP[kind](st, _DOTS[dots])
            _assert_state(fs, is_, st)


@pytest.mark.parametrize("tol,maxiter", [(1e-5, 100), (0.0, 100),
                                         (1e-5, 0)])
@pytest.mark.parametrize("start", [[4.0, 16.0], [0.0, 0.0], [1e-40, 1e-39],
                                   [NAN, 1.0], [1.0, INF], [1e-12, 1.0],
                                   [-0.0, 2.0]])
def test_plain_init_step_is_the_numpy_recurrence(start, tol, maxiter):
    st = _state(since=400, k=17, flag=2, done=1)
    fs, is_ = _tensors(st)
    TR.krylov_step_ref(TR.STEP_INIT, fs, is_,
                       torch.tensor(start, dtype=torch.float32), tol=tol,
                       maxiter=maxiter)
    with np.errstate(all="ignore"):
        np_init(st, start, tol, maxiter)
    _assert_state(fs, is_, st)


def _vectors(n, seed):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(n).astype(F32) for _ in range(5)]
    out[1][:3] = [1e-40, -0.0, 3e38]                # subnormal, -0, near max
    return out


_UPDATES = {
    TR.UPDATE_CG: (3, 1, lambda a, b, o, u, v: (
        u[0] + a * u[2], u[1] - a * v[0], (u[1] - a * v[0]) + b * u[2])),
    TR.UPDATE_BICG_P: (1, 2, lambda a, b, o, u, v: (
        v[0] + b * (u[0] - o * v[1]),)),
    TR.UPDATE_BICG_S: (1, 2, lambda a, b, o, u, v: (v[0] - a * v[1],)),
    TR.UPDATE_BICG_XR: (2, 3, lambda a, b, o, u, v: (
        (u[0] + a * v[0]) + o * v[1], v[1] - o * v[2])),
}


@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("kind", sorted(_UPDATES))
def test_plain_updates_round_each_operation(kind, flag):
    nu, nv, want_fn = _UPDATES[kind]
    vecs = _vectors(64, kind)
    st = _state(alpha=-0.375, beta=1.25, omega=0.625)
    fs, is_ = _tensors(st)
    us = [torch.from_numpy(v.copy()) for v in vecs[:nu]]
    vs = [torch.from_numpy(v.copy()) for v in vecs[nu:nu + nv]]
    TR.krylov_update_ref(kind, torch.tensor([flag], dtype=torch.int32), fs,
                         us, vs)
    with np.errstate(all="ignore"):
        want = want_fn(st["alpha"], st["beta"], st["omega"], vecs[:nu],
                       vecs[nu:nu + nv])
    for got, w, before in zip(us, want, vecs[:nu]):
        assert _same_bits(got.numpy(), before if flag else w)


def test_done_latch_masks_the_plain_fused_pass():
    d = repro_torch.operator(TM.poisson_2d(12, 12), "sell",
                             device="cpu").dev.dev
    v = [torch.ones(d.n_rows_pad) for _ in range(3)]
    y, dots = torch.full((d.n_rows_pad,), 7.0), torch.full((5,), 7.0)
    done = torch.ones(1, dtype=torch.int32)
    TFI.fused_matvec_dots(d, *v, y=y, dots=dots, done=done)
    assert bool((y == 7).all()) and bool((dots == 7).all())
    done.zero_()
    y2, dots2 = TFI.fused_matvec_dots(d, *v, y=y, dots=dots, done=done)
    y_ref, dots_ref = TFI.fused_matvec_dots(d, *v)
    assert y2 is y and torch.equal(y, y_ref) and torch.equal(dots, dots_ref)


_DRIVE = {
    "poisson24:cg": (lambda: TM.poisson_2d(24, 24), "cg"),
    "samg:cg": (lambda: TM.samg(scale=1e-4), "cg"),
    "convection17x19:bicgstab": (
        lambda: TM.convection_poisson(17, 19, beta=0.4), "bicgstab"),
    "poisson24:bicgstab": (lambda: TM.poisson_2d(24, 24), "bicgstab"),
}


@pytest.mark.parametrize("case", sorted(_DRIVE))
def test_chunk_size_changes_no_bit_of_the_solve(case):
    mk, method = _DRIVE[case]
    tm = mk()
    op = repro_torch.operator(tm, "sell", device="cpu")
    mvd = TFI.make_matvec_dots(op.dev.dev)
    b = torch.zeros(mvd.n_pad)
    b[: tm.n_rows] = torch.from_numpy(np.random.default_rng(0)
                                      .standard_normal(tm.n_rows)
                                      .astype(F32))
    fn = TS.fused_cg if method == "cg" else TS.fused_bicgstab
    runs = {c: fn(mvd, b, tol=1e-5, chunk=c) for c in (1, 7, 32)}
    first = runs[1]
    assert first.status == "converged" and first.iters >= 4
    for c, res in runs.items():
        assert res.iters == first.iters and res.status == first.status
        assert torch.equal(res.x, first.x)
        assert res.info["chunk"] == c
        runs_ = res.diagnostics["restarts"] + 1
        assert res.info["host_syncs"] <= (math.ceil(res.iters / c)
                                          + 3 * runs_)
    # a later solve on the same operand reuses the loop: same bits again
    again = fn(mvd, b, tol=1e-5, chunk=7)
    assert torch.equal(again.x, first.x) and again.iters == first.iters
    assert set(mvd.loops) == {(method, 1), (method, 7), (method, 32)}


def test_maxiter_stops_the_device_loop_exactly():
    tm = TM.poisson_2d(24, 24)
    mvd = TFI.make_matvec_dots(repro_torch.operator(tm, "sell",
                                                    device="cpu").dev.dev)
    b = torch.zeros(mvd.n_pad)
    b[: tm.n_rows] = 1.0
    for maxiter in (0, 1, 7, 32, 33):
        res = TS.fused_cg(mvd, b, tol=1e-5, maxiter=maxiter, chunk=8)
        assert res.iters == maxiter and res.status == "maxiter"


# ---- on the card ---------------------------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.cuda
def test_step_kernels_equal_plain_versions_on_card():
    _need_cuda()
    n = 0
    for state in _STATES.values():
        for dots in _DOTS:
            for kinds in ((TR.STEP_CG,), (TR.STEP_BICG1, TR.STEP_BICG2)):
                st = _state(**state)
                fs_c, is_c = _tensors(st)
                fs_k, is_k = _tensors(st, "cuda")
                for kind in kinds:
                    TR.krylov_step_ref(kind, fs_c, is_c, _dots(dots))
                    KS.step_kernel_call(kind, fs_k, is_k, _dots(dots).cuda())
                    n += 1
                assert _same_bits(fs_k.cpu().numpy(), fs_c.numpy())
                assert torch.equal(is_k.cpu(), is_c)
    for start in ([4.0, 16.0], [1e-40, 1e-39], [NAN, 1.0], [1.0, INF]):
        for tol, maxiter in ((1e-5, 100), (0.0, 100), (1e-5, 0)):
            fs_c, is_c = _tensors(_state())
            fs_k, is_k = _tensors(_state(), "cuda")
            d = torch.tensor(start, dtype=torch.float32)
            TR.krylov_step_ref(TR.STEP_INIT, fs_c, is_c, d, tol=tol,
                               maxiter=maxiter)
            KS.step_kernel_call(TR.STEP_INIT, fs_k, is_k, d.cuda(), tol=tol,
                                maxiter=maxiter)
            assert _same_bits(fs_k.cpu().numpy(), fs_c.numpy())
            assert torch.equal(is_k.cpu(), is_c)
    assert n > 300


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 1000, 1 << 20])
def test_update_kernels_equal_plain_versions_on_card(n):
    _need_cuda()
    for kind, (nu, nv, _) in _UPDATES.items():
        for flag in (0, 1):
            vecs = _vectors(n, kind + 10 * flag)
            fs, _ = _tensors(_state(alpha=-0.375, beta=1.25, omega=0.625))
            f = torch.tensor([flag], dtype=torch.int32)
            us_c = [torch.from_numpy(v.copy()) for v in vecs[:nu]]
            vs_c = [torch.from_numpy(v.copy()) for v in vecs[nu:nu + nv]]
            us_k = [t.cuda() for t in us_c]
            vs_k = [t.cuda() for t in vs_c]
            TR.krylov_update_ref(kind, f, fs, us_c, vs_c)
            KS.update_kernel_call(kind, f.cuda(), fs.cuda(), us_k, vs_k)
            for a, b in zip(us_k, us_c):
                assert _same_bits(a.cpu().numpy(), b.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [None, 1 << 16])
def test_k3_done_latch_on_card(sigma):
    # done clear: K3's y and dots bit for bit those of a launch without
    # the latch; done set: nothing written, on both unpermute paths
    _need_cuda()
    tm = TM.samg(scale=0.006)
    d = repro_torch.operator(tm, "sell", sigma=sigma).dev.dev
    rng = np.random.default_rng(3)
    v = [torch.from_numpy(rng.standard_normal(d.n_rows_pad).astype(F32))
         .cuda() for _ in range(3)]
    y0, dots0 = TFI.fused_matvec_dots(d, *v)
    y, dots = torch.full_like(y0, 7.0), torch.full_like(dots0, 7.0)
    done = torch.zeros(1, dtype=torch.int32, device="cuda")
    TFI.fused_matvec_dots(d, *v, y=y, dots=dots, done=done)
    assert torch.equal(y, y0) and torch.equal(dots, dots0)
    done.fill_(1)
    y.fill_(7.0)
    dots.fill_(7.0)
    TFI.fused_matvec_dots(d, *v, y=y, dots=dots, done=done)
    torch.cuda.synchronize()
    assert bool((y == 7).all()) and bool((dots == 7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_DRIVE))
def test_graph_drive_is_chunk_independent_on_card(case):
    _need_cuda()
    mk, method = _DRIVE[case]
    tm = mk()
    mvd = TFI.make_matvec_dots(repro_torch.operator(tm, "sell").dev.dev)
    b = torch.zeros(mvd.n_pad, device="cuda")
    b[: tm.n_rows] = torch.from_numpy(np.random.default_rng(0)
                                      .standard_normal(tm.n_rows)
                                      .astype(F32)).cuda()
    fn = TS.fused_cg if method == "cg" else TS.fused_bicgstab
    fn(mvd, b, tol=1e-5, chunk=32)                  # capture first
    TR.reset_calls()
    k3 = TFI.fused_spmv_dots_kernel_call
    k3.launches = KS.step_kernel_call.launches = 0
    r32 = fn(mvd, b, tol=1e-5, chunk=32)
    r1 = fn(mvd, b, tol=1e-5, chunk=1)
    assert r32.status == r1.status == "converged"
    assert r32.iters == r1.iters and torch.equal(r32.x, r1.x)
    assert r32.info["graph_capture_s"] == 0.0       # reused
    assert r1.info["host_syncs"] >= r1.iters
    assert r32.info["host_syncs"] <= (math.ceil(r32.iters / 32)
                                      + 3 * (r32.diagnostics["restarts"]
                                             + 1))
    assert k3.launches >= r1.iters + r32.iters
    assert KS.step_kernel_call.launches >= r1.iters + r32.iters
    assert not any(f.calls for f in TR._COUNTED)
