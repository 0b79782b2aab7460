"""PyTorch port, the bench (``python -m jpeggpu_tpu_torch.bench``) on the
CPU at tiny sizes: its images against the port's numpy golden decoder, the
JSON line of its default mode, and its gate. No JAX: the bench has no JAX
counterpart to compare with (the JAX package's ``bench.py`` reads an image
this repo does not have).

Tolerance: none, every comparison of planes is ``np.array_equal``.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import bench, golden
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode

_S420 = [(2, 2), (1, 1), (1, 1)]
_ROOT = pathlib.Path(__file__).resolve().parent.parent
# the smallest image the bench takes: two MCU rows of two MCUs
_SIZE, _W, _H = "32x32", 32, 32


@pytest.fixture(scope="module")
def strip():
    """A 3-MCU-row strip, 48 wide, restart interval one MCU row."""
    img = bench.synthetic_image(48, 48, seed=5)
    return encode(img, EncodeSpec(sampling=_S420, restart_interval=3,
                                  quality=90))


@pytest.mark.parametrize("height", [
    40,    # 2.5 MCU rows: the last row partial (as 2136 = 133.5 x 16)
    112,   # 7 MCU rows: no whole number of 3-row strips (as 5104, 2136)
    144,   # 3 whole strips
])
def test_repeat_strip_any_height(strip, height):
    """The strip's rows repeat cyclically by MCU row, cropped to the SOF
    height: golden of the whole image == the strip's planes tiled and
    cropped (``tiled_golden``), and the segments cycle through the
    strip's."""
    tall = bench.repeat_strip(strip, height)
    stream = T.parse(tall)
    assert stream.size_y == height
    scan, short = stream.scans[0], T.parse(strip).scans[0]
    assert scan.num_segments == -(-height // 16)
    segs = [tall[scan.begin + a:scan.begin + b] for a, b in scan.seg_raw]
    rows = [strip[short.begin + a:short.begin + b] for a, b in short.seg_raw]
    assert segs == [rows[r % 3] for r in range(len(segs))]
    expect = golden.decode(tall)
    got = bench.tiled_golden(strip, height)
    assert [p.shape for p in got] == [p.shape for p in expect]
    for a, b in zip(got, expect):
        assert np.array_equal(a, b)


def test_repeat_strip_partial_row_decodes(strip):
    """The port decodes the image with a partial last MCU row == golden."""
    tall = bench.repeat_strip(strip, 40)
    for a, b in zip(T.decode(tall, device="cpu"), golden.decode(tall)):
        assert np.array_equal(a, b)


def test_repeat_strip_refuses_other_restart_intervals():
    img = bench.synthetic_image(32, 48, seed=5)
    data = encode(img, EncodeSpec(sampling=_S420, restart_interval=2))
    with pytest.raises(ValueError, match="one MCU row"):
        bench.repeat_strip(data, 64)


@pytest.mark.parametrize("encoder", ["pil", "numpy"])
def test_frame_segments_all_differ(encoder, monkeypatch):
    """The full frame at a small size, by either encoder: decodes ==
    golden, and no two restart segments are alike."""
    if encoder == "pil" and bench.frame_encoder() != "pil":
        pytest.skip("PIL is not installed on this host")
    monkeypatch.setattr(bench, "frame_encoder", lambda: encoder)
    data = bench.make_frame(7, width=48, height=64)
    stream = T.parse(data)
    scan, = stream.scans
    assert (stream.size_x, stream.size_y) == (48, 64)
    assert [(c.ss_x, c.ss_y) for c in stream.components] == _S420
    assert stream.restart_interval == scan.num_mcus_x == 3
    body = data[scan.begin:scan.end]
    segments = [body[a:b] for a, b in scan.seg_raw]
    assert len(segments) == 4 and len(set(segments)) == len(segments)
    for a, b in zip(T.decode(data, device="cpu"), golden.decode(data)):
        assert np.array_equal(a, b)


def test_frame_noise_grows_by_band():
    """The frame's noise steps by band from sigma 1 to 12: the last band's
    rows are rougher than the first's."""
    band = np.arange(96) * bench.FRAME_BANDS // 96
    sigma = 1 + 11 * band / (bench.FRAME_BANDS - 1)
    img = bench.synthetic_image(96, 64, 3, sigma).astype(np.int32)
    rough = np.abs(np.diff(img, axis=1)).mean(axis=(1, 2))
    assert rough[-8:].mean() > 3 * rough[:8].mean()


def test_image_cache(tmp_path):
    """An image and golden's SHA-256 are written once and read back."""
    first = bench.strip_image(11, _W, _H, cache=tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"{first.name}.jpg", f"{first.name}.sha256"]
    again = bench.strip_image(11, _W, _H, cache=tmp_path)
    assert again == first
    assert first.sha256 == bench.planes_sha256(golden.decode(first.data))


# every key of the default mode's line; the comparators are null where
# the host lacks them (torchvision, and nvJPEG off the card)
_KEYS = {
    "metric", "value", "unit", "vs_baseline", "device", "card",
    "power_limit", "image", "encoder", "bytes", "mp",
    "latency_from_bytes_ms", "stages_from_bytes_ms", "latency_device_ms",
    "device_busy_ms", "device_kernels", "stream_mps",
    "single_dispatch_avg_ms", "single_dispatch_max_ms",
    "single_dispatch_mps", "sync_rounds", "lanes", "symbols",
    "symbols_per_lane_max", "symbols_per_lane_median", "batch_mps",
    "batch_size", "batch_vs_baseline", "batch_per_img_ms",
    "batch_staged_per_img_ms", "batch_device_busy_ms", "entropy_gbs",
    "coeff_gbs", "pil_cpu_mps", "nvjpeg_mps", "frame", "iters", "seed"}
_DEVICE_ONLY = ("latency_device_ms", "device_busy_ms", "device_kernels",
                "batch_device_busy_ms", "card", "power_limit", "nvjpeg_mps")


@pytest.fixture
def one_thread():
    """The bench's many small plain decodes on one intra-op thread: beside
    the test run's other busy workers, a pool of spinning threads makes
    them some ten times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_main_cpu_line(tmp_path, one_thread):
    """The default mode on the CPU at a tiny size, one iteration: ONE JSON
    line with every key; the device metrics and nvJPEG null (not measured
    on the host), the host numbers positive."""
    out = tmp_path / "line.json"
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert bench.main(["--device", "cpu", "--size", _SIZE, "--iters",
                           "1", "--cache", str(tmp_path / "cache"),
                           "--out", str(out)]) == 0
    lines = [ln for ln in stdout.getvalue().splitlines() if ln]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert json.loads(out.read_text()) == line
    assert set(line) == _KEYS
    assert line["metric"] == "decode_throughput_32x32_from_bytes"
    assert line["unit"] == "MP/s" and line["device"] == "cpu"
    assert line["value"] > 0 and line["stream_mps"] > 0
    assert line["vs_baseline"] == line["value"] / bench.BASELINE_MPS
    assert line["batch_size"] == bench.DEFAULT_BATCH
    for key in _DEVICE_ONLY:
        assert line[key] is None, key
    frame = line["frame"]
    assert frame["image"].startswith(f"frame_{_SIZE}_q90_seed2024_")
    assert frame["encoder"] == bench.frame_encoder()
    assert frame["latency_device_ms"] is None and frame["mps"] > 0
    assert frame["sync_rounds"] >= 2
    assert 0 < frame["symbols_per_lane_median"] <= frame[
        "symbols_per_lane_max"]


def test_corrupted_hash_fails_the_run(tmp_path):
    """A cached golden SHA-256 that is not the planes' makes the bench exit
    non-zero with no JSON line on stdout."""
    cache = tmp_path / "cache"
    frame = bench.frame_image(2024, _W, _H, cache=cache)
    (cache / f"{frame.name}.sha256").write_text("0" * 64 + "\n")
    run = subprocess.run(
        [sys.executable, "-m", "jpeggpu_tpu_torch.bench", "--device", "cpu",
         "--size", _SIZE, "--iters", "1", "--cache", str(cache)],
        cwd=_ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode != 0
    assert "GoldenMismatch" in run.stderr
    assert not any(ln.startswith("{") for ln in run.stdout.splitlines())


@pytest.fixture
def host_markers(monkeypatch):
    """`bench.profiled` on the host: the host's `aten::add` stands in for
    the marker launch and `aten::add` / `aten::mul` for device work, so
    that the window logic runs without a card. Returns the marker calls
    to drop (a window of the first try: two opening, one closing), a list
    the test fills."""
    drop = []
    calls = iter(range(1 << 20))
    x = torch.ones(4)

    def marker(dev):
        if next(calls) not in drop:
            torch.add(x, 1)

    monkeypatch.setattr(bench, "_marker", marker)
    monkeypatch.setattr(bench, "MARKER", "aten::add")
    monkeypatch.setattr(bench, "PROFILER_TRIES", ((0.0, 2),) * 3)
    monkeypatch.setattr(bench, "on_card",
                        lambda e: e.name in ("aten::add", "aten::mul"))
    monkeypatch.setattr(bench, "windows_lost", 0)
    monkeypatch.setattr(bench, "markers_lost_max", 0)
    return drop


@pytest.mark.parametrize("dropped, lost, markers_lost", [
    ([], 0, 0),          # a whole window
    ([0], 0, 1),         # one opening marker lost, one left
    ([0, 1], 1, 0),      # the first window lost both opening markers
    ([2, 5], 2, 0),      # the first two lost their closing marker
])
def test_profiled_takes_lost_windows_again(host_markers, dropped, lost,
                                           markers_lost):
    """A profiler window counts only where its first and last device events
    are markers; one that lost either end is taken again, counted in
    `windows_lost`, and the run's events come back without the markers.
    The opening markers lost in the window that counted are kept."""
    host_markers.extend(dropped)
    x = torch.ones(4)
    events = bench.profiled(torch.device("cpu"), lambda: torch.mul(x, 2))
    assert [e.name for e in events] == ["aten::mul"]
    assert bench.windows_lost == lost
    assert bench.markers_lost_max == markers_lost


def test_profiled_fails_without_device_work(host_markers):
    """A run that shows no device work in any window fails after one
    window for each of `PROFILER_TRIES`."""
    with pytest.raises(AssertionError, match="no whole window"):
        bench.profiled(torch.device("cpu"), lambda: None)
    assert bench.windows_lost == len(bench.PROFILER_TRIES)
