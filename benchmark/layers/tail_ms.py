"""Time in the per-image tails (the ``jpeggpu.tail`` ranges: DC un-delta
and K3, image by image and scan by scan) over the traced window, per traced
image, in ms."""

from benchmark.spans import union_ms


def read(rec):
    return union_ms(rec, "jpeggpu.tail")
