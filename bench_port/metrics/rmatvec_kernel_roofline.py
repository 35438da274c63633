"""The bandwidth bound of z = A^T y over the device time of the operations
launched inside the span around op.T @ y, in %."""
from bench_port.readers import span_roofline


def read(rec):
    return span_roofline(rec, "rmatvec")
