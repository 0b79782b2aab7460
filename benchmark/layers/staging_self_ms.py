"""Self time of the port's host staging (the ``jpeggpu.inputs``: host
destuff and segment tables, ``jpeggpu.merge``, ``jpeggpu.copy_in`` and
``jpeggpu.symtab`` ranges) over the traced window, per traced image, in
ms."""

from benchmark.spans import self_ms


def read(rec):
    return self_ms(rec, ("jpeggpu.inputs", "jpeggpu.merge",
                         "jpeggpu.copy_in", "jpeggpu.symtab"))
