"""1 - the union of the device's kernel and copy intervals over the traced
window's wall time, in %."""

from benchmark.profiler import busy_s


def read(rec):
    if rec.trace is None:
        return None
    return (1.0 - busy_s(rec.trace) / rec.trace.wall_s) * 100.0
