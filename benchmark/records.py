"""What a run records for its metrics, and how metric files are found.

A :class:`Records` holds the spans and counters of the measured window
(taken by the benchmark around its calls into the port, and from the
port's own counters), the card's work over the whole window where an
end-to-end metric of the cell reads the device trace, and, in a traced run,
the profiler window (:mod:`benchmark.profiler`) with the images it
decoded. Each per-layer metric is a file ``layers/<name>.py`` and each
end-to-end metric a file ``end_to_end/<name>.py``, found by the name in
``BENCHMARK.json``; each defines ``read(rec)``, which returns a number, or
None where the run gave it nothing to read (the metric is then left out of
the line).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Records:
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    # per request: (images, the BatchDecoder's routes)
    routes: List[Tuple[int, list]] = dataclasses.field(default_factory=list)
    # the measured window
    latencies: List[float] = dataclasses.field(default_factory=list)
    batch: int = 1
    images: int = 0
    pixels: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    # the card's work over the whole measured window, where an end-to-end
    # metric of the cell reads it (a profiler.Window with no host ranges)
    window_trace: Optional[object] = None
    # the traced window, where there is one
    trace: Optional[object] = None  # profiler.Window
    traced_inputs: Sequence[bytes] = ()
    device_kind: str = ""

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def count(self, name: str, n: int) -> None:
        self.counters.setdefault(name, []).append(n)

    def median_ms(self, name: str) -> Optional[float]:
        v = self.spans.get(name)
        return statistics.median(v) * 1e3 if v else None

    def kernel_s(self, name: str) -> float:
        """Seconds of the traced window's launches whose kernel name holds
        `name`."""
        return sum(b - a for k, a, b in self.trace.device if name in k) / 1e6

    def peak(self, key: str) -> Optional[float]:
        """`key` of this card's entry in ``peaks.json``."""
        table = json.loads((HERE / "peaks.json").read_text())
        for entry in table["cards"]:
            if entry["match"] in self.device_kind:
                return entry[key]
        return None


def load_reader(kind: str, name: str):
    """``read`` of ``<kind>/<name>.py`` beside this file."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
