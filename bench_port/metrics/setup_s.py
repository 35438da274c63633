"""Seconds from the process's start to the first timed call."""
from bench_port.readers import setup_s as read
