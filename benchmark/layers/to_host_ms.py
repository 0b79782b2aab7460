"""Time copying planes to numpy (the ``jpeggpu.to_host`` ranges, the wait
for the device included) over the traced window, per traced image, in
ms."""

from benchmark.spans import union_ms


def read(rec):
    return union_ms(rec, "jpeggpu.to_host")
