"""2 nnz per product, every product of the window, over the window
(GFLOP/s)."""
from bench_port.readers import gflops as read
