"""Median ms of ``Decoder.transfer`` per image (pipeline.build_inputs, the
native host destuffer, pipeline.stage_inputs), on the benchmark's span
around the call."""


def read(rec):
    return rec.median_ms("transfer")
