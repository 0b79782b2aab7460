"""Time in the sync rounds' host reads (the ``jpeggpu.sync.read`` ranges:
each round's wait for the device) over the traced window, per traced
image, in ms."""

from benchmark.spans import union_ms


def read(rec):
    return union_ms(rec, "jpeggpu.sync.read")
