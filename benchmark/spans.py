"""The program's own ranges in a traced window, for the per-layer readers.

The port opens a ``jpeggpu.*`` range at each layer boundary of its host
path (``jpeggpu_tpu_torch/debug.py`` lists them); :mod:`benchmark.profiler`
keeps them in ``Window.ranges`` as ``(name, start, end)`` in microseconds
on the profiler's clock, the clock of the device's work. A range's self
time is its duration less the union of the ``jpeggpu.*`` ranges inside it
(clipped to it). Every reader divides by the traced images, and returns
None where the window holds none of its ranges (a program without them).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from benchmark.profiler import idle_gaps

PREFIX = "jpeggpu."
ROOT = "jpeggpu.batch"

Range = Tuple[str, float, float]


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def program(win) -> List[Range]:
    return [r for r in win.ranges if r[0].startswith(PREFIX)]


def self_us(span: Range, ranges: Sequence[Range]) -> float:
    """``span``'s duration less the union of the other ranges that lie
    inside it, each clipped to it; a range that holds the whole span (an
    ancestor, or itself) is no child."""
    _, a, b = span
    inside = [(max(x, a), min(y, b)) for _, x, y in ranges
              if x < b and y > a and not (x <= a and y >= b)]
    return (b - a) - union_us(inside)


def _per_image_ms(rec, total_us: float) -> Optional[float]:
    n = len(rec.traced_inputs)
    return total_us / 1e3 / n if n else None


def self_ms(rec, names: Sequence[str]) -> Optional[float]:
    """The self time of every range named in ``names``, summed over the
    traced window, per traced image, in ms."""
    if rec.trace is None:
        return None
    ranges = program(rec.trace)
    spans = [r for r in ranges if r[0] in names]
    if not spans:
        return None
    return _per_image_ms(rec, sum(self_us(s, ranges) for s in spans))


def union_ms(rec, name: str) -> Optional[float]:
    """The time inside ranges named ``name`` over the traced window (their
    union, so a nested repeat counts once), per traced image, in ms."""
    if rec.trace is None:
        return None
    spans = [(a, b) for n, a, b in rec.trace.ranges if n == name]
    if not spans:
        return None
    return _per_image_ms(rec, union_us(spans))


def named_idle_share(win) -> Optional[float]:
    """The device's idle time whose innermost host range, as
    :func:`benchmark.profiler.idle_gaps` finds it, is a range of the program
    other than its root ``jpeggpu.batch``, over all its idle time, in %."""
    gaps = idle_gaps(win, top=None)
    idle = sum(s for _, s in gaps)
    if not idle:
        return None
    named = sum(s for name, s in gaps
                if name.startswith(PREFIX) and name != ROOT)
    return named / idle * 100.0
