"""Seconds from the start of the process to the start of the window:
imports, the inputs made from the seed, the kernels built or loaded, the
warm-up."""


def read(rec):
    return rec.setup_s
