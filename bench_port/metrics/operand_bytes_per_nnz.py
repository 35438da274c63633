"""Card bytes that the program holds for the matrix after set-up, over nnz."""
from bench_port.readers import operand_bytes_per_nnz as read
