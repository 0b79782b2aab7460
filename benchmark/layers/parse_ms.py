"""Median ms of ``Decoder.parse_header`` per image (reader.parse,
pipeline.build_plan), on the benchmark's span around the call."""


def read(rec):
    return rec.median_ms("parse_header")
