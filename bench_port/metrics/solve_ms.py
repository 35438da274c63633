"""The window's ms over the certified solves that ended in it."""
from bench_port.readers import solve_ms as read
