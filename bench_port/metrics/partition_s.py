"""Host seconds in dist_spmv.partition_csr inside dist_operator, rank 0."""


def read(rec):
    return rec.get("partition_s")
