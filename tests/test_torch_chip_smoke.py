"""PyTorch port, the helpers of the card check (``chip_smoke.py``) on the
CPU: its images against the port's numpy golden decoder, its symbol count,
its profiler window (the host's events standing in for the card's), its
refusal without a card, and the planes' hash of the multi-process run
(``parallel/weakscale.py``). No JAX.

Tolerance: none, every comparison of planes is ``np.array_equal``.
"""

import contextlib
import importlib.util
import io
import pathlib
import sys

import numpy as np
import pytest
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import constants as C
from jpeggpu_tpu_torch import golden
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.parallel import weakscale

_S420 = [(2, 2), (1, 1), (1, 1)]
_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py as a module (it runs only on a CUDA device; its image
    and symbol-count helpers are plain numpy / torch)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    """Plain decodes on one intra-op thread: beside the test run's other
    busy workers, a pool of spinning threads makes them some ten times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def strip(chip_smoke):
    """A 3-MCU-row strip, 48 wide, restart interval one MCU row."""
    img = chip_smoke.synthetic_image(48, 48, seed=5)
    return encode(img, EncodeSpec(sampling=_S420, restart_interval=3,
                                  quality=90))


@pytest.mark.parametrize("height", [
    40,    # 2.5 MCU rows: the last row partial (as 2136 = 133.5 x 16)
    112,   # 7 MCU rows: no whole number of 3-row strips (as 5104, 2136)
    144,   # 3 whole strips
])
def test_repeat_strip_any_height(chip_smoke, strip, height):
    """The strip's rows repeat cyclically by MCU row, cropped to the SOF
    height: golden of the whole image == the strip's planes tiled and
    cropped (``tiled_golden``), and the segments cycle through the
    strip's."""
    tall = chip_smoke.repeat_strip(strip, height)
    stream = T.parse(tall)
    assert stream.size_y == height
    scan, short = stream.scans[0], T.parse(strip).scans[0]
    assert scan.num_segments == -(-height // 16)
    segs = [tall[scan.begin + a:scan.begin + b] for a, b in scan.seg_raw]
    rows = [strip[short.begin + a:short.begin + b] for a, b in short.seg_raw]
    assert segs == [rows[r % 3] for r in range(len(segs))]
    expect = golden.decode(tall)
    got = chip_smoke.tiled_golden(strip, height)
    assert [p.shape for p in got] == [p.shape for p in expect]
    for a, b in zip(got, expect):
        assert np.array_equal(a, b)


def test_repeat_strip_partial_row_decodes(chip_smoke, strip):
    """The port decodes the image with a partial last MCU row == golden."""
    tall = chip_smoke.repeat_strip(strip, 40)
    for a, b in zip(T.decode(tall, device="cpu"), golden.decode(tall)):
        assert np.array_equal(a, b)


def test_repeat_strip_refuses_other_restart_intervals(chip_smoke):
    img = chip_smoke.synthetic_image(32, 48, seed=5)
    data = encode(img, EncodeSpec(sampling=_S420, restart_interval=2))
    with pytest.raises(ValueError, match="one MCU row"):
        chip_smoke.repeat_strip(data, 64)


def test_chip_smoke_repeat_strip(chip_smoke):
    """A strip whose restart interval is one MCU row, repeated to a taller
    image: a valid JPEG whose planes are the strip's rows in turn."""
    img = chip_smoke.synthetic_image(32, 48, seed=7)
    strip = encode(img, EncodeSpec(sampling=_S420, restart_interval=3,
                                   quality=90))
    tall = chip_smoke.repeat_strip(strip, 160)  # 10 MCU rows from 2
    assert T.parse(tall).size_y == 160
    rows = T.decode(strip, device="cpu")
    planes = T.decode(tall, device="cpu")
    for a, b in zip(golden.decode(tall), planes):
        assert np.array_equal(a, b)
    for r, p in zip(rows, planes):
        assert np.array_equal(np.tile(r, (5, 1)), p)


@pytest.mark.parametrize("quality", [90, 30])
def test_card_strip_decodes_to_tiled_golden(chip_smoke, one_thread,
                                            quality):
    """The strip of the card check's images (`make_image`) at both of its
    qualities, narrowed to 64 columns: taken to three strips' height by
    `repeat_strip`, the port's decode == `tiled_golden`, the expectation
    that the card check's 12 MP verdicts are built from."""
    height = 3 * 16 * chip_smoke.STRIP_ROWS
    strip, _ = chip_smoke.make_image(2024, quality, width=64, height=height)
    tall = chip_smoke.repeat_strip(strip, height)
    stream = T.parse(tall)
    assert (stream.size_x, stream.size_y) == (64, height)
    expect = chip_smoke.tiled_golden(strip, height)
    got = T.decode(tall, device="cpu")
    assert [p.shape for p in got] == [p.shape for p in expect]
    for a, b in zip(got, expect):
        assert np.array_equal(a, b)


def test_chip_smoke_count_symbols(chip_smoke):
    """Hand-made data units: DC + EOB; a lone coefficient at zigzag 63
    (three ZRL, no EOB); coefficients at zigzag 1 and 18 (one ZRL, EOB)."""
    blocks = torch.zeros(3, 64, dtype=torch.int16)
    blocks[0, 0] = 5
    blocks[1, C.ORDER_NATURAL[63]] = -1
    blocks[2, C.ORDER_NATURAL[1]] = 2
    blocks[2, C.ORDER_NATURAL[18]] = 3
    assert chip_smoke.count_symbols(blocks[:1].reshape(-1)) == 2
    assert chip_smoke.count_symbols(blocks[1:2].reshape(-1)) == 5
    assert chip_smoke.count_symbols(blocks[2:].reshape(-1)) == 5
    assert chip_smoke.count_symbols(blocks.reshape(-1)) == 12


@pytest.fixture
def host_markers(chip_smoke, monkeypatch):
    """`chip_smoke.profiled` on the host: the host's `aten::add` stands in
    for the marker launch and `aten::add` / `aten::mul` for device work, so
    that the window logic runs without a card. Returns the marker calls
    to drop (a window of the first try: two opening, one closing), a list
    the test fills."""
    drop = []
    calls = iter(range(1 << 20))
    x = torch.ones(4)

    def marker(dev):
        if next(calls) not in drop:
            torch.add(x, 1)

    monkeypatch.setattr(chip_smoke, "_marker", marker)
    monkeypatch.setattr(chip_smoke, "MARKER", "aten::add")
    monkeypatch.setattr(chip_smoke, "PROFILER_TRIES", ((0.0, 2),) * 3)
    monkeypatch.setattr(chip_smoke, "on_card",
                        lambda e: e.name in ("aten::add", "aten::mul"))
    monkeypatch.setattr(chip_smoke, "windows_lost", 0)
    monkeypatch.setattr(chip_smoke, "markers_lost_max", 0)
    return drop


@pytest.mark.parametrize("dropped, lost, markers_lost", [
    ([], 0, 0),          # a whole window
    ([0], 0, 1),         # one opening marker lost, one left
    ([0, 1], 1, 0),      # the first window lost both opening markers
    ([2, 5], 2, 0),      # the first two lost their closing marker
])
def test_profiled_takes_lost_windows_again(chip_smoke, host_markers,
                                           dropped, lost, markers_lost):
    """A profiler window counts only where its first and last device events
    are markers; one that lost either end is taken again, counted in
    `windows_lost`, and the run's events come back without the markers.
    The opening markers lost in the window that counted are kept."""
    host_markers.extend(dropped)
    x = torch.ones(4)
    events = chip_smoke.profiled(torch.device("cpu"),
                                 lambda: torch.mul(x, 2))
    assert [e.name for e in events] == ["aten::mul"]
    assert chip_smoke.windows_lost == lost
    assert chip_smoke.markers_lost_max == markers_lost


def test_profiled_fails_without_device_work(chip_smoke, host_markers):
    """A run that shows no device work in any window fails after one
    window for each of `PROFILER_TRIES`."""
    with pytest.raises(AssertionError, match="no whole window"):
        chip_smoke.profiled(torch.device("cpu"), lambda: None)
    assert chip_smoke.windows_lost == len(chip_smoke.PROFILER_TRIES)


def test_device_work_names_each_launch(chip_smoke, host_markers):
    """`device_work` gives (name, ms) for each event of the run, in order,
    and leaves the markers out."""
    x = torch.ones(4)

    def run():
        torch.mul(x, 2)
        torch.mul(x, 3)

    work = chip_smoke.device_work(torch.device("cpu"), run)
    assert [name for name, _ in work] == ["aten::mul", "aten::mul"]
    assert all(isinstance(ms, float) and ms >= 0 for _, ms in work)


def test_main_needs_cuda(chip_smoke, monkeypatch):
    """Without a CUDA device the card check returns 1 at once and says
    why."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert chip_smoke.main() == 1
    assert "needs a CUDA device" in err.getvalue()


def _planes():
    return [np.arange(12, dtype=np.uint8).reshape(3, 4),
            np.full((2, 2), 7, np.uint8)]


@pytest.mark.parametrize("change", ["shape", "dtype", "value"])
def test_planes_sha256_tells_planes_apart(change):
    """The multi-process run's only equality check: the hash of a decode's
    planes changes when only a plane's shape, only its dtype (the same
    bytes), or only one of its values changes."""
    base = weakscale.planes_sha256(_planes())
    assert weakscale.planes_sha256(_planes()) == base
    planes = _planes()
    if change == "shape":
        planes[0] = planes[0].reshape(4, 3)
    elif change == "dtype":
        planes[0] = planes[0].view(np.int8)
    else:
        planes[1][1, 0] += 1
    assert weakscale.planes_sha256(planes) != base
