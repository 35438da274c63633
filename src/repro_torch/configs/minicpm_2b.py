"""minicpm-2b [dense]: llama-like architecture trained with the WSD
(warmup-stable-decay) schedule — the schedule is implemented in
``repro.train.schedules`` and exercised by the training example.

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753. [arXiv:2404.06395]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122_753,
    head_dim=64,
    act="silu",
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE_CONFIG = ArchConfig(
    name="minicpm-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=72,
    n_heads=6,
    n_kv_heads=6,
    d_ff=144,
    vocab=512,
    head_dim=12,
    act="silu",
    tie_embeddings=True,
    subquadratic=False,
    param_dtype="float32",
    activation_dtype="float32",
)
