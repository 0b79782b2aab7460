"""Self time of the port's header walk, plans and grouping (the
``jpeggpu.parse``, ``jpeggpu.plan`` and ``jpeggpu.group`` ranges) over the
traced window, per traced image, in ms."""

from benchmark.spans import self_ms


def read(rec):
    return self_ms(rec, ("jpeggpu.parse", "jpeggpu.plan", "jpeggpu.group"))
