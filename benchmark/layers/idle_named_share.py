"""The device's idle time in the traced window whose innermost host range
is a range of the port other than its root ``jpeggpu.batch``, over all its
idle time, in % (the gaps as ``profiler.idle_gaps`` finds them)."""

from benchmark.spans import named_idle_share


def read(rec):
    if rec.trace is None:
        return None
    return named_idle_share(rec.trace)
