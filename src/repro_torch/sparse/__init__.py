"""The paper's storage format as an LM feature (port of ``repro/sparse``):
pruned FFN weights as :class:`SparseLinear` modules over the sparse
operator, applied through K5 on the card."""
from .sparse_ffn import (SparseLinear, ops_storage_bytes, sparse_ffn_apply,
                         sparsify_ffn_params)

__all__ = ["SparseLinear", "ops_storage_bytes", "sparse_ffn_apply",
           "sparsify_ffn_params"]
