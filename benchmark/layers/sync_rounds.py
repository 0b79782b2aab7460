"""Launches of the sync round (K1, ``ops.huffman.subseq_pass.launches``)
per image, the mean over the window; None where the counter did not move
(the plain version on the host counts nothing)."""

import statistics


def read(rec):
    v = rec.counters.get("sync_rounds")
    if not v or not any(v):
        return None
    return statistics.mean(v)
