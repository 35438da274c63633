"""gemma3-4b [dense]: 5:1 local:global attention, 128k context.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144. [hf:google/gemma-3]
Sliding window 1024 on local layers, qk-norm, GeGLU.  Decode cost is
O(window) for 5/6 of layers -> qualifies for long_500k (DESIGN.md §5).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262_144,
    head_dim=256,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="geglu",
    tie_embeddings=True,
    subquadratic=True,
)

SMOKE_CONFIG = ArchConfig(
    name="gemma3-4b-smoke",
    family="dense",
    n_layers=6,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    head_dim=16,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=16,
    qk_norm=True,
    act="geglu",
    tie_embeddings=True,
    subquadratic=True,
    param_dtype="float32",
    activation_dtype="float32",
)
