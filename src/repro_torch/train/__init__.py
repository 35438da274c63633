"""Training: AdamW with float32 masters, schedules, the step and the
loop (port of ``repro/train/``)."""
from .loop import Watchdog, train
from .optimizer import AdamW, AdamWState, global_norm, trainable
from .schedules import constant, cosine, wsd
from .step import make_train_step

__all__ = ["AdamW", "AdamWState", "Watchdog", "constant", "cosine",
           "global_norm", "make_train_step", "train", "trainable", "wsd"]
