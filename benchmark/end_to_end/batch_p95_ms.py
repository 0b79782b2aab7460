"""The 95th percentile of the window's batch latencies in ms, each batch
timed from its bytes to its planes in host memory; only where a request
is a batch."""

import numpy as np


def read(rec):
    if rec.batch == 1 or not rec.latencies:
        return None
    return float(np.percentile(rec.latencies, 95)) * 1e3
