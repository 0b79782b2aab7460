"""The traced window: a torch.profiler window that has lost no events.

A copy of the port's bench window (``profiled``): the profiler can lose
the first device events of a window (none, the first launch, tens of
them, or all of a short window), so a window opens with marker launches,
which may be lost, and closes with one. It counts where its first and its
last device events are markers and the run showed device work; otherwise
it is taken again with more markers and the host idle for longer at both
ends (``TRIES``), and fails where no window counts.

:func:`profiled` returns the window's device work (kernels and copies,
markers left out), the host's ``jpeggpu.*`` and ``bench.*`` ranges, and
the run's wall time on the host clock.

:class:`DeviceWindow` records the card's work over a whole measured window
(kernels and copies only, no host ranges), for an end-to-end metric whose
source is the device trace; it reads the profiler's raw events, since a
window of some hundred thousand launches is too many to parse into
Python's event objects.
"""

from __future__ import annotations

import dataclasses
import re
import sys
import time
from typing import Callable, List, Tuple

MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
MARKER_CYCLES = 1000
# one try each: (host seconds idle before the first launch of a window and
# after its last, marker launches that open the window)
TRIES = ((0.0, 64), (0.01, 256), (0.1, 1024), (1.0, 4096))
RANGE_PREFIXES = ("jpeggpu.", "bench.")


@dataclasses.dataclass
class Window:
    """One traced window; times in microseconds on the profiler's clock."""

    device: List[Tuple[str, float, float]]  # (name, start, end)
    ranges: List[Tuple[str, float, float]]  # host ranges
    wall_s: float  # the run on the host clock, synchronised
    lost: int  # windows taken again


def _on_card(e) -> bool:
    """A profiler event that is device work: a kernel or a copy, not the
    device-side range of a scope."""
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not e.is_user_annotation


def _marker(dev) -> None:
    import torch

    with torch.cuda.device(dev):
        torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize(dev)


def profiled(dev, run: Callable[[], None]) -> Window:
    """One `run()` (which synchronises at its end) in a profiler window that
    saw all of its device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt, (pad, lead) in enumerate(TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(lead):
                _marker(dev)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            _marker(dev)
            time.sleep(pad)
        events = prof.events()
        card = sorted((e for e in events if _on_card(e)),
                      key=lambda e: e.time_range.start)
        work = [e for e in card if MARKER not in e.name]
        seen = len(card) - len(work)
        if (card and MARKER in card[0].name and MARKER in card[-1].name
                and work):
            ranges = [(e.name, e.time_range.start, e.time_range.end)
                      for e in events
                      if e.device_type == DeviceType.CPU
                      and e.name.startswith(RANGE_PREFIXES)]
            return Window(
                device=[(kernel_name(e.name), e.time_range.start,
                         e.time_range.end) for e in work],
                ranges=ranges, wall_s=wall, lost=attempt)
        print(f"profiler window {attempt + 1} of {len(TRIES)} (host idle "
              f"{pad * 1e3:.0f} ms at each end, {lead} + 1 markers) lost "
              f"device events: {seen} markers and {len(work)} events of the "
              f"run seen", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler saw no whole window of device work "
                       f"in {len(TRIES)} tries")


class DeviceWindow:
    """The card's kernels and copies while the block runs: ``device``
    (as :class:`Window`'s, markers left out), or None where the trace lost
    events, at its start (the first event seen is not one of the markers
    that open it) or its end (the closing marker is missing).

    Entered before the measured window opens and left once its last
    answer came, so that the profiler's start and the marker launches
    fall outside the window's clock."""

    LEAD = 256

    def __init__(self, dev):
        self.dev = dev
        self.device = None
        self.events = 0
        self._prof = None

    def __enter__(self) -> "DeviceWindow":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(0.01)
        for _ in range(self.LEAD):
            _marker(self.dev)
        return self

    def __exit__(self, *exc) -> bool:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.dev)
        _marker(self.dev)
        time.sleep(0.01)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        card = sorted(
            (e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in self._prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation())
        self._prof = None
        self.events = len(card)
        if card and MARKER in card[0][2] and MARKER in card[-1][2]:
            self.device = [(kernel_name(n), a, b) for a, b, n in card
                           if MARKER not in n]
        return False


def kernel_name(name: str) -> str:
    """A profiler event's kernel without its template and parameter lists:
    ``void jpeggpu::subseq_pass_kernel<true>(...)`` ->
    ``jpeggpu::subseq_pass_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return re.split(r"[<(]", name)[0].strip()


def busy_intervals(win: Window) -> List[Tuple[float, float]]:
    """The union of the device work's intervals, in order."""
    out: List[List[float]] = []
    for _, a, b in sorted(win.device, key=lambda d: d[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(win: Window) -> float:
    return sum(b - a for a, b in busy_intervals(win)) / 1e6


def device_ops(win: Window, top: int = 10) -> List[List]:
    """[kernel, seconds] of the device work that took most time."""
    tot: dict = {}
    for name, a, b in win.device:
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def idle_gaps(win: Window, top: int = 10) -> List[List]:
    """[host range, seconds]: the device's idle time between its first and
    its last work, by the innermost host range open at each gap's middle
    ("host" where none is), largest first."""
    busy = busy_intervals(win)
    tot: dict = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        inside = [r for r in win.ranges if r[1] <= mid <= r[2]]
        name = min(inside, key=lambda r: r[2] - r[1])[0] if inside else "host"
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]
