"""Rank 0's device ms in NCCL kernels per product."""
from bench_port.readers import exchange_ms as read
