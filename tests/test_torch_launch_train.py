"""The training launcher (``repro_torch.launch.train``) on the CPU: a
smoke run end to end with a checkpoint, auto-resume, and the options
that raise."""
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.launch import train as LT


def test_smoke_run_trains_and_checkpoints(tmp_path, capsys):
    argv = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--ckpt", str(tmp_path)]
    hist = LT.main(argv + ["--steps", "3"])
    assert len(hist["losses"]) == len(hist["times"]) == 3
    assert all(torch.isfinite(torch.tensor(hist["losses"])))
    assert len(hist["grad_norms"]) == len(hist["lrs"]) == 3
    assert hist["lrs"][0] == pytest.approx(3e-4)     # warmup of 1 step
    assert store.latest_step(str(tmp_path)) == 3
    out = capsys.readouterr().out
    assert "arch=minicpm-2b-smoke" in out and "device=cpu" in out
    # a second launch resumes at the last step and trains on
    hist2 = LT.main(argv + ["--steps", "4"])
    assert "[resume] restored step 3" in capsys.readouterr().out
    assert len(hist2["losses"]) == 1
    assert store.latest_step(str(tmp_path)) == 4


def test_cosine_schedule_runs():
    hist = LT.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--device",
                    "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                    "--schedule", "cosine"])
    assert len(hist["losses"]) == 2


def test_mesh_single_raises_naming_its_item():
    """``--mesh single`` is the production (16, 16) mesh (ROADMAP 1.28):
    off a 256-rank world it raises ``make_production_mesh``'s error, as
    the reference says it is only valid on hardware of that size."""
    with pytest.raises(RuntimeError, match="needs a world of 256 ranks"):
        LT.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                 "--mesh", "single"])


def test_refuses_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LT.main(["--arch", "minicpm-2b", "--smoke", "--steps", "1"])


def test_published_config_is_the_default():
    """Without ``--smoke`` the launcher builds the published config:
    minicpm-2b's 40 layers at d_model 2304 (checked without building
    it)."""
    built = []

    class Stop(Exception):
        pass

    def fake_build(cfg, device=None):
        built.append(cfg)
        raise Stop

    mp = pytest.MonkeyPatch()
    mp.setattr(LT, "build_model", fake_build)
    try:
        with pytest.raises(Stop):
            LT.main(["--arch", "minicpm-2b", "--device", "cpu"])
    finally:
        mp.undo()
    cfg = built[0]
    assert (cfg.name, cfg.n_layers, cfg.d_model, cfg.vocab) == \
        ("minicpm-2b", 40, 2304, 122_753)


@pytest.mark.parametrize("arch, argv, want", [
    ("granite-moe-3b-a800m", ["--n-layers", "4"], (4, 0)),
    ("seamless-m4t-medium", ["--n-layers", "2", "--enc-layers", "2"],
     (2, 2)),
])
def test_depth_options_cut_only_the_depth(monkeypatch, arch, argv, want):
    """``--n-layers`` / ``--enc-layers`` cut the published config's
    depth and keep every other field (checked without building it)."""
    import dataclasses
    from repro_torch import configs
    built = []

    class Stop(Exception):
        pass

    def fake_build(cfg, device=None):
        built.append(cfg)
        raise Stop

    monkeypatch.setattr(LT, "build_model", fake_build)
    with pytest.raises(Stop):
        LT.main(["--arch", arch, "--device", "cpu", *argv])
    cfg = built[0]
    assert (cfg.n_layers, cfg.enc_layers) == want
    assert dataclasses.replace(cfg, n_layers=0, enc_layers=0) == \
        dataclasses.replace(configs.get(arch), n_layers=0, enc_layers=0)


def test_depth_option_trains_a_cut_smoke_model():
    hist = LT.main(["--arch", "recurrentgemma-2b", "--smoke", "--device",
                    "cpu", "--steps", "1", "--batch", "2", "--seq", "16",
                    "--n-layers", "3"])
    assert len(hist["losses"]) == 1
