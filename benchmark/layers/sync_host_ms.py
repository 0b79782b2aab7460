"""Self time of the sync's host work (the ``jpeggpu.sync`` ranges: a
scan's ``make_ctx``, its rounds' launches and bookkeeping, and
``symbol_offsets``; less the ``jpeggpu.sync.read`` waits for the device and
any other ``jpeggpu.*`` range inside them) over the traced window, per
traced image, in ms."""

from benchmark.spans import self_ms


def read(rec):
    return self_ms(rec, ("jpeggpu.sync",))
