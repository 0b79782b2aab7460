"""The 95th percentile of the window's image latencies in ms, each image
timed from its bytes to its planes ready on the card; only where a request
is one image."""

import numpy as np


def read(rec):
    if rec.batch != 1 or not rec.latencies:
        return None
    return float(np.percentile(rec.latencies, 95)) * 1e3
