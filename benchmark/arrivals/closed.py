"""A closed loop of one client: the next request is sent when the last one
is answered (or has failed). A request's latency is its own call's."""

from __future__ import annotations

import time


def drive(w) -> float:
    t_end = time.perf_counter()
    while t_end < w.deadline:
        req = w.stream.next()
        t0 = time.perf_counter()
        try:
            outs = w.loop.serve(req.datas, w.rec)
        except Exception:  # a request that fails is counted, not fatal
            t_end = time.perf_counter()
            w.refused(req)
            continue
        t_end = time.perf_counter()
        w.answered(req, outs, t0, t_end)
    return t_end
