"""The bandwidth bound of a CG iteration over the card's busy time an
iteration, in %."""
from bench_port.readers import cg_kernel_roofline as read
