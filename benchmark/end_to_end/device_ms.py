"""The card's time per image over the measured window, in ms: the union of
its kernel and copy intervals while the window ran (the profiler's trace
of the whole window), over the images answered in it. What a card spends
on an image, whatever the host's speed; None where the run recorded no
whole trace of the window."""

from benchmark.profiler import busy_s


def read(rec):
    if rec.window_trace is None or not rec.images:
        return None
    return busy_s(rec.window_trace) / rec.images * 1e3
