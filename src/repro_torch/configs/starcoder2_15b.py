"""starcoder2-15b [dense]: GQA + RoPE code model.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152. [arXiv:2402.19173]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    qkv_bias=True,
    rope_theta=100_000.0,
    act="gelu",
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE_CONFIG = ArchConfig(
    name="starcoder2-15b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=16,
    qkv_bias=True,
    act="gelu",
    tie_embeddings=True,
    subquadratic=False,
    param_dtype="float32",
    activation_dtype="float32",
)
