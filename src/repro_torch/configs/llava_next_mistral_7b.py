"""llava-next-mistral-7b [vlm]: Mistral-7B backbone + anyres vision stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

The anyres tiling frontend is a STUB per the task spec: ``input_specs``
supplies precomputed patch embeddings (anyres base tile 24x24 = 576
patches) which the model prepends to the text embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
    frontend="vision",
    frontend_seq=576,
    subquadratic=False,
)

SMOKE_CONFIG = ArchConfig(
    name="llava-next-mistral-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    head_dim=16,
    act="silu",
    tie_embeddings=False,
    frontend="vision",
    frontend_seq=16,
    subquadratic=False,
    param_dtype="float32",
    activation_dtype="float32",
)
