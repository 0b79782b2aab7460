"""Small parameters of each cell, for runs on the host."""

import json
import pathlib

from benchmark.run import load_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]

# configuration, mixes and metrics kept for cells of a later PR (PERF.md,
# Open questions): the tests run them as entries of a copy of
# BENCHMARK.json
LATER = {
    "configs": [
        {"name": "photo12mp", "source": "https://github.com/nolmoonen/"
         "jpeggpu benchmark/benchmark_jpeggpu.hpp",
         "file": "benchmark/configs/photo12mp.json", "reduced": [],
         "why": "one large photo at a time"},
    ],
    "workloads": [
        {"name": "photo12mp.rst", "config": "photo12mp", "traffic": "rst",
         "chips": 1, "why": "12 MP, RST every MCU row, rows reordered per "
         "request, through Decoder"},
        {"name": "imagenet_loader.single", "config": "imagenet_loader",
         "traffic": "single", "chips": 1, "why": "the loader's images one "
         "at a time through Decoder"},
        {"name": "photo12mp.norst", "config": "photo12mp",
         "traffic": "norst", "chips": 1,
         "why": "12 MP with no restart markers"},
    ],
    "end_to_end": [
        {"name": "image_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["photo12mp.rst"]},
    ],
}
CELLS = ("photo12mp.rst", "imagenet_loader.b32", "imagenet_loader.single",
         "photo12mp.norst")


def bench() -> dict:
    """BENCHMARK.json with the later entries added where it lacks them."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in LATER.items():
        names = {e["name"] for e in b[key]}
        b[key] += [e for e in entries if e["name"] not in names]
    return b


def small_params(cell: str) -> dict:
    """The cell's parameters with its images cut to a few hundred pixels
    a side: the same mix, order, loop and encoder."""
    _, params = load_cell(cell, bench())
    if cell.startswith("photo12mp"):
        params["geometry"] = [{"share": 1.0, "width": 160, "height": 96}]
    else:
        params["pool"] = 8
        params["geometry"] = [
            {"share": 0.5, "width": 64, "height": 48},
            {"share": 0.25, "width": 48, "height": 64},
            {"share": 0.25, "width": [30, 70], "height": [30, 70]}]
        params["batch"] = min(int(params["batch"]), 4)
        params["warmup"] = 2
    params["sample"] = 3
    return params
