"""Host seconds in tune.tune_solver during set-up."""
from bench_port.readers import span_s


def read(rec):
    return span_s(rec, "tune")
