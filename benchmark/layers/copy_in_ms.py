"""Self time of the port's copy to the device (the ``jpeggpu.copy_in``
ranges, symbol-table builds left out) with the host's waits for the
previous copy before the staging buffer is rewritten (the
``jpeggpu.copy_in.wait`` ranges), over the traced window, per traced
image, in ms."""

from benchmark.spans import self_ms


def read(rec):
    return self_ms(rec, ("jpeggpu.copy_in", "jpeggpu.copy_in.wait"))
