"""Deterministic, checkpointable synthetic data pipeline.

Copy of ``repro/data/pipeline.py`` (pure numpy): the same seed and step
give the reference's batches bit for bit.

Batches are a pure function of (seed, step): restart/resume reproduces
the exact stream with no stored buffers (counter-based Philox), which is
what makes the data state trivially part of a fault-tolerance checkpoint
— the checkpoint stores just ``{"seed", "step"}``.

Produces LM batches (tokens/labels = next-token targets) plus the stub
frontend embeddings for the vlm/audio archs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0
    frontend: str | None = None
    frontend_seq: int = 0
    d_model: int = 0
    encdec: bool = False

    def next(self) -> dict:
        rng = np.random.default_rng([self.seed, self.step])
        # zipf-ish marginals so the loss curve is non-trivial
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        tokens = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        out = {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:].copy(),
        }
        if self.frontend == "vision":
            out["frontend"] = rng.standard_normal(
                (self.batch, self.frontend_seq, self.d_model)
            ).astype(np.float32)
        if self.encdec:
            out["enc_frames"] = rng.standard_normal(
                (self.batch, self.seq, self.d_model)).astype(np.float32)
        self.step += 1
        return out

    # ------------------------------------------------------ checkpointing
    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.seed = int(d["seed"])
        self.step = int(d["step"])


def for_config(cfg, batch: int, seq: int, seed: int = 0) -> SyntheticLM:
    return SyntheticLM(
        vocab=cfg.vocab, batch=batch, seq=seq, seed=seed,
        frontend=cfg.frontend if cfg.frontend == "vision" else None,
        frontend_seq=cfg.frontend_seq, d_model=cfg.d_model,
        encdec=cfg.is_encdec,
    )
