"""falcon-mamba-7b [ssm]: pure Mamba-1, attention-free.

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16. [arXiv:2410.05355]
d_inner = 2*d_model = 8192, dt_rank = d_model/16 = 256, conv width 4.
Sub-quadratic (O(1) decode state) -> runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    layer_pattern=("mamba",),
    ssm_state=16,
    d_inner=8192,
    conv_width=4,
    dt_rank=256,
    tie_embeddings=False,
    subquadratic=True,
)

SMOKE_CONFIG = ArchConfig(
    name="falcon-mamba-7b-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=512,
    layer_pattern=("mamba",),
    ssm_state=8,
    d_inner=128,
    conv_width=4,
    dt_rank=8,
    tie_embeddings=False,
    subquadratic=True,
    param_dtype="float32",
    activation_dtype="float32",
)
