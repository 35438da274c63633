"""The operand's stored value slots, padding in, over nnz."""
from bench_port.readers import stored_slots_per_nnz as read
