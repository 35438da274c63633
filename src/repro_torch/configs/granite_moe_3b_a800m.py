"""granite-moe-3b-a800m [moe]: 40 experts, top-8, fine-grained.

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155.
[hf:ibm-granite/granite-3.0 family]

MoE dispatch uses the sorted-token formulation — the pJDS row-sort idea
applied to expert routing (DESIGN.md §4).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    act="silu",
    tie_embeddings=True,
    n_experts=40,
    top_k=8,
    # §Perf (EXPERIMENTS.md): per-data-shard sorted dispatch
    moe_local_shards=16,
    subquadratic=False,
)

SMOKE_CONFIG = ArchConfig(
    name="granite-moe-3b-a800m-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=512,
    head_dim=16,
    act="silu",
    tie_embeddings=True,
    n_experts=8,
    top_k=2,
    subquadratic=False,
    param_dtype="float32",
    activation_dtype="float32",
)
