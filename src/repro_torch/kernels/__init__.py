"""The hand-written CUDA kernels (K1-K3), their plain PyTorch versions and the dispatch layer."""
