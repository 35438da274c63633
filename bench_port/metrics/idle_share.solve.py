"""Share of the traced slice with no operation on the card, in %."""
from bench_port.readers import idle_share as read
