"""Share of rank 0's traced slice with no operation on its card, in %."""
from bench_port.readers import idle_share as read
