"""The bandwidth bound of y = A x over the device time of the operations
launched inside the span around op @ x, in %."""
from bench_port.readers import span_roofline


def read(rec):
    return span_roofline(rec, "spmv")
