"""Host seconds in operator(...) or dist_operator(...) during set-up (rank
0 for the latter)."""
from bench_port.readers import span_s


def read(rec):
    return span_s(rec, "build")
