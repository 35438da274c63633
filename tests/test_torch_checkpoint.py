"""The port's checkpoint store, synthetic data pipeline and resume
(``repro_torch.checkpoint.store``, ``repro_torch.data.pipeline``,
``repro_torch.train.loop``) on the CPU.

The reference's store cases (round trip, uncommitted directories
ignored, async save, a leaf-count mismatch raising), here with bf16
leaves kept bit for bit; ``SyntheticLM`` batches bit for bit against the
reference's, with the state-dict round trip; and a run resumed from its
step-2 checkpoint in fresh objects (model, optimizer, pipeline) whose
losses, params and optimizer state equal the uninterrupted run's bit for
bit.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch import nn

import repro_torch.configs as TCFG
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import SyntheticLM, for_config
from repro_torch.models.api import build_model
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamW
from repro_torch.train.schedules import wsd
from repro_torch.train.step import make_train_step


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(8, 16, generator=g),
        "nested": {"b": torch.randint(0, 9, (4,), generator=g,
                                      dtype=torch.int32),
                   "h": torch.randn(3, 5, generator=g).bfloat16()},
        "mods": nn.ParameterDict({"w": nn.Parameter(torch.randn(
            2, 2, generator=g))}),
    }


def _equal_trees(a, b):
    la, lb = store.leaves(a), store.leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), n


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 7, t, extra={"data": {"seed": 1, "step": 7}})
    assert store.latest_step(str(tmp_path)) == 7
    target = _tree(seed=1)
    restored, extra = store.restore(str(tmp_path), 7, target)
    assert restored is target
    _equal_trees(restored, t)
    assert extra["data"]["step"] == 7
    man = json.loads((tmp_path / "step_0000000007" / "manifest.json")
                     .read_text())
    kinds = {m["name"]: m["dtype"] for m in man["leaves"]}
    assert kinds == {"a": "float32", "nested/b": "int32",
                     "nested/h": "bfloat16", "mods/w": "float32"}
    # bf16 is stored as its uint16 bits
    h = np.load(tmp_path / "step_0000000007" / "leaf_2.npy")
    assert h.dtype == np.uint16
    np.testing.assert_array_equal(h, t["nested"]["h"].view(torch.int16)
                                  .numpy().view(np.uint16))


def test_latest_ignores_uncommitted(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 3, t)
    torn = tmp_path / "step_0000000009"      # a torn write
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    (tmp_path / "step_0000000011.tmp").mkdir()
    assert store.latest_step(str(tmp_path)) == 3
    assert store.latest_step(str(tmp_path / "absent")) is None


def test_async_save_snapshots_at_the_call(tmp_path):
    """The host copy is taken before ``save`` returns: changing the
    tensors afterwards does not reach the checkpoint."""
    t = _tree()
    want = {k: v for k, v in store.leaves(t)}
    want = {k: v.detach().clone() for k, v in want.items()}
    ck = store.AsyncCheckpointer()
    ck.save(str(tmp_path), 5, t)
    with torch.no_grad():
        for _, x in store.leaves(t):
            x.add_(1)
    ck.wait()
    assert store.latest_step(str(tmp_path)) == 5
    got, _ = store.restore(str(tmp_path), 5, _tree(seed=2))
    for n, x in store.leaves(got):
        assert torch.equal(x, want[n]), n


def test_async_save_failure_raises_at_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = store.AsyncCheckpointer()
    ck.save(str(blocker), 1, _tree())
    with pytest.raises(OSError):
        ck.wait()


def test_leaf_count_mismatch_raises(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 1, t)
    with pytest.raises(ValueError):
        store.restore(str(tmp_path), 1, {"only": t["a"]})
    bad = _tree()
    bad["a"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape"):
        store.restore(str(tmp_path), 1, bad)


@pytest.mark.parametrize("arch", ["minicpm-2b", "llava-next-mistral-7b",
                                  "seamless-m4t-medium"])
def test_synthetic_lm_matches_reference(arch):
    pytest.importorskip("jax")
    from repro import configs
    from repro.data.pipeline import for_config as jfor
    want = jfor(configs.smoke(arch), batch=3, seq=12, seed=7)
    got = for_config(TCFG.smoke(arch), batch=3, seq=12, seed=7)
    for _ in range(3):
        a, b = got.next(), want.next()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert got.state_dict() == want.state_dict() == {"seed": 7, "step": 3}


def test_synthetic_lm_state_dict_round_trip():
    d1 = SyntheticLM(vocab=100, batch=2, seq=8, seed=3)
    batches = [d1.next() for _ in range(4)]
    d2 = SyntheticLM(vocab=100, batch=2, seq=8, seed=0)
    d2.load_state_dict(json.loads(json.dumps({"seed": 3, "step": 2})))
    resumed = d2.next()
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(batches[2][k], resumed[k])
    np.testing.assert_array_equal(resumed["tokens"][0, 1:],
                                  resumed["labels"][0, :-1])


def _run(ckpt_dir, steps, log):
    """A fresh model, optimizer and pipeline; train to ``steps`` with a
    checkpoint every 2 steps.  Returns (params, opt_state, history)."""
    cfg = TCFG.smoke("minicpm-2b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr_fn=wsd(1e-2, warmup=1, stable=2, decay=2))
    state = opt.init(params)
    data = for_config(cfg, batch=2, seq=16)
    return train(step_fn=make_train_step(model, opt, q_chunk=8, k_chunk=8),
                 params=params, opt_state=state, data=data, steps=steps,
                 ckpt_dir=ckpt_dir, ckpt_every=2, log_fn=log.append)


def test_resume_is_bit_for_bit(tmp_path):
    full, part = tmp_path / "full", tmp_path / "part"
    log = []
    p_full, s_full, h_full = _run(str(full), 4, log)
    assert store.latest_step(str(full)) == 4
    assert len(h_full["losses"]) == 4 and all(np.isfinite(h_full["losses"]))
    assert h_full["losses"][-1] < h_full["losses"][0]
    # the step-2 checkpoint alone, then a fresh process state
    shutil.copytree(full / "step_0000000002", part / "step_0000000002")
    man = store.manifest(str(part), 2)
    assert man["extra"]["data"] == {"seed": 0, "step": 2}
    log = []
    p_res, s_res, h_res = _run(str(part), 4, log)
    assert log[0] == "[resume] restored step 2"
    assert h_res["losses"] == h_full["losses"][2:]
    assert h_res["grad_norms"] == h_full["grad_norms"][2:]
    assert h_res["lrs"] == h_full["lrs"][2:]
    _equal_trees((p_res, s_res), (p_full, s_full))
    # and the final checkpoints are the same bits
    for meta in store.manifest(str(full), 4)["leaves"]:
        assert torch.equal(store.load_leaf(str(full), 4, meta),
                           store.load_leaf(str(part), 4, meta)), meta["name"]
