"""2 nnz of the global matrix per distributed product, over the slowest
rank's window (GFLOP/s)."""
from bench_port.readers import gflops as read
