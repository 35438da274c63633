"""The bandwidth bound of a CG iteration over the window's time an
iteration, in %."""
from bench_port.readers import cg_iter_roofline as read
