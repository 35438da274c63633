"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000. [arXiv:2402.19427]
Block pattern (recurrent, recurrent, local-attn) repeating; window 2048;
GeGLU MLP; lru_width = d_model. Sub-quadratic -> runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256_000,
    head_dim=256,
    layer_pattern=("recurrent", "recurrent", "local"),
    window=2048,
    act="geglu",
    tie_embeddings=True,
    d_inner=2560,
    conv_width=4,
    subquadratic=True,
)

SMOKE_CONFIG = ArchConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=512,
    head_dim=16,
    layer_pattern=("recurrent", "recurrent", "local"),
    window=16,
    act="geglu",
    tie_embeddings=True,
    d_inner=64,
    conv_width=4,
    subquadratic=True,
    param_dtype="float32",
    activation_dtype="float32",
)
