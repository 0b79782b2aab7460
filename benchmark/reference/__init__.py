"""The benchmark's plain reference: a sequential baseline-JPEG decoder.

A frozen copy of the port's sequential integer decoder (``golden``) and of
what it needs (``reader``, ``tables``, ``idct_int``, ``constants``,
``errors``), kept here so that a later change to the port cannot move the
yardstick. It imports numpy and nothing of the port or of JAX.
:mod:`.parallel` spreads its decodes over worker processes.
"""
