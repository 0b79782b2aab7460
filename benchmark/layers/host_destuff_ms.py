"""Time in the port's native host destuff (the ``jpeggpu.destuff.host``
ranges, inside ``jpeggpu.inputs``) over the traced window, per traced
image, in ms."""

from benchmark.spans import union_ms


def read(rec):
    return union_ms(rec, "jpeggpu.destuff.host")
