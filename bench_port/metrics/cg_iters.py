"""CG iterations a solve, the mean over the window's solves
(SolveResult.iters)."""
from bench_port.readers import mean_of_solves


def read(rec):
    return mean_of_solves(rec, "iters")
