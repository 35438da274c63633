"""seamless-m4t-medium [audio]: encoder-decoder multimodal backbone.

12L encoder + 12L decoder, d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=256206. [arXiv:2308.11596]

The speech frontend is a STUB per the task spec: ``input_specs`` supplies
precomputed frame embeddings for the encoder; the decoder is a standard
causal transformer with cross-attention.  Cross-attention K/V are
computed once from the encoder output at prefill and kept on device — the
paper §3 remark that "parts of those vectors may be kept on the device"
applied to serving.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256_206,
    head_dim=64,
    act="gelu",
    tie_embeddings=False,
    frontend="audio",
    frontend_seq=1024,
    subquadratic=False,
)

SMOKE_CONFIG = ArchConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    n_layers=2,
    enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    head_dim=16,
    act="gelu",
    tie_embeddings=False,
    frontend="audio",
    frontend_seq=16,
    subquadratic=False,
    param_dtype="float32",
    activation_dtype="float32",
)
