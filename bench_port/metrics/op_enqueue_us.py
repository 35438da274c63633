"""Host microseconds for op @ x to return, with no synchronisation, the
median of five bursts after a synchronisation."""
from bench_port.readers import enqueue_us as read
