"""Host-side formats, matrices and perf model, the operator protocol and the solvers."""
