"""K2 (``decode_write.cu``): the least time to read the scan's entropy-
coded bytes and write its coefficient stream once at the card's HBM
bandwidth, over K2's profiler time, in %, over the traced images."""

from benchmark.rooflines import share


def read(rec):
    return share(rec, "decode_write_kernel", "entropy", "coeff")
