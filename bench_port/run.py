#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the checkout's root:

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See ``bench_port/harness.py``.
"""
import pathlib
import sys
import time

T_TOP = time.perf_counter()
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from bench_port.harness import main, process_age_s  # noqa: E402

if __name__ == "__main__":
    age = process_age_s() - (time.perf_counter() - T_TOP)
    sys.exit(main(age_at_top=age, t_top=T_TOP))
