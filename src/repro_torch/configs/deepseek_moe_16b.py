"""deepseek-moe-16b [moe]: fine-grained 64 routed experts top-6 + 2 shared.

28L d_model=2048 16H (MHA kv=16) d_ff=1408 (per expert) vocab=102400.
[arXiv:2401.06066]

First layer uses a dense FFN (first_k_dense=1) as in the published model;
dense-layer width = d_ff * (top_k + shared) = 11264 (paper: 10944).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    act="silu",
    tie_embeddings=False,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_k_dense=1,
    # §Perf (EXPERIMENTS.md): per-data-shard sorted dispatch — 15x lower
    # collective bound vs the global sort on the (16,16) mesh
    moe_local_shards=16,
    subquadratic=False,
)

SMOKE_CONFIG = ArchConfig(
    name="deepseek-moe-16b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab=512,
    head_dim=16,
    act="silu",
    tie_embeddings=False,
    n_experts=8,
    n_shared_experts=2,
    top_k=2,
    first_k_dense=1,
    subquadratic=False,
    param_dtype="float32",
    activation_dtype="float32",
)
