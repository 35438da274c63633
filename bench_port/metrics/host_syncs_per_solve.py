"""Host reads a solve, the mean over the window's solves
(info["host_syncs"])."""
from bench_port.readers import mean_of_solves


def read(rec):
    return mean_of_solves(rec, "host_syncs")
