"""K3 (``idct_stream.cu``): the least time to read the coefficient stream
and write the planes once at the card's HBM bandwidth, over K3's profiler
time, in %, over the traced images."""

from benchmark.rooflines import share


def read(rec):
    return share(rec, "idct_stream_to_planes_kernel", "coeff", "planes")
