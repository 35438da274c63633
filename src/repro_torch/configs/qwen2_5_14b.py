"""qwen2.5-14b [dense]: GQA with QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064. [hf:Qwen/Qwen2.5]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
    subquadratic=False,
)

SMOKE_CONFIG = ArchConfig(
    name="qwen2.5-14b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    head_dim=16,
    qkv_bias=True,
    act="silu",
    tie_embeddings=False,
    subquadratic=False,
    param_dtype="float32",
    activation_dtype="float32",
)
