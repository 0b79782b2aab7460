"""Median ms of ``Decoder.decode(device=True)`` and the synchronisation
after it per image (pipeline.decode_pipeline: sync, write, DC, tail), on
the benchmark's span around the call."""


def read(rec):
    return rec.median_ms("decode")
