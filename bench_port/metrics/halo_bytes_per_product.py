"""Halo bytes a rank receives per product, from the partition's plan, the
mean over the ranks."""


def read(rec):
    return rec.get("halo_bytes")
