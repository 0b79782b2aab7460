"""Runs of each cell on the host at small sizes: the last line's keys, and
``correct`` coming out false when the timed path is broken underneath
(the faults a cell of this benchmark can have) or when the control takes
the program's place."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import check, control, run

from small import CELLS, ROOT, bench, small_params

CPU = torch.device("cpu")
SEED = 2**31 + 77
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small_run(cell, trace=False, seconds=0.5):
    result, lines = run.run_cell(cell, SEED, seconds, trace, CPU,
                                 start=time.perf_counter(), bench=bench(),
                                 params=small_params(cell), workers=1)
    return result, lines


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, lines = small_run(cell)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    # the card's trace of the window needs the card
    on_card = {m["name"] for m in bench()["end_to_end"]
               if m["source"] == "device_trace"}
    want = set(run.metric_names(bench(), "end_to_end", cell)) - on_card
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert lines == check.lines(result["checks"])
    assert result["checks"]["images_checked"]["value"] == min(
        3, result["attempted"])


@pytest.mark.parametrize("cell", ["photo12mp.rst", "imagenet_loader.b32"])
def test_traced_run_reports_host_layers(cell):
    result, _ = small_run(cell, trace=True)
    assert result["correct"] is True
    names = set(run.metric_names(bench(), "per_layer", cell))
    # the device's numbers need the card; the host's spans are read here
    host = {"served_mps", "merged_share"} & names
    assert host and host <= set(result["metrics"]) <= names


def _stale(original):
    """The answer of the call before, in place of this call's."""
    last = {}

    def fn(self, *a, **k):
        out = original(self, *a, **k)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    return fn


def _half_batch(original):
    """Only the first half of the batch decoded, its answers repeated for
    the rest."""
    def fn(self, datas, *a, **k):
        half = max(1, len(datas) // 2)
        out = original(self, list(datas[:half]), *a, **k)
        return [out[i % half] for i in range(len(datas))]

    return fn


def _altered(original):
    """One value of every image's first plane altered where the tail
    produces it."""
    def fn(*a, **k):
        planes = original(*a, **k)
        planes[0][0, 0] += 1
        return planes

    return fn


FAULTS = [
    ("photo12mp.rst", "stale"), ("photo12mp.rst", "altered"),
    ("photo12mp.norst", "altered"), ("imagenet_loader.single", "stale"),
    ("imagenet_loader.single", "altered"), ("imagenet_loader.b32", "stale"),
    ("imagenet_loader.b32", "half"), ("imagenet_loader.b32", "altered"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from jpeggpu_tpu_torch import api, pipeline
    from jpeggpu_tpu_torch.parallel import batch

    if fault == "altered":
        monkeypatch.setattr(pipeline, "idct_stream_to_planes",
                            _altered(pipeline.idct_stream_to_planes))
    elif fault == "stale" and cell.endswith("b32"):
        monkeypatch.setattr(batch.BatchDecoder, "decode",
                            _stale(batch.BatchDecoder.decode))
    elif fault == "stale":
        monkeypatch.setattr(api.Decoder, "decode",
                            _stale(api.Decoder.decode))
    else:
        monkeypatch.setattr(batch.BatchDecoder, "decode",
                            _half_batch(batch.BatchDecoder.decode))
    result, lines = small_run(cell, seconds=1.5)
    assert result["correct"] is False
    assert result["checks"]["wrong_values"]["value"] > 0
    assert any("wrong_values" in line for line in lines)


def test_failed_request_is_not_correct(monkeypatch):
    from jpeggpu_tpu_torch import api

    def boom(self, *a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(api.Decoder, "transfer", boom)
    params = small_params("photo12mp.rst")
    params["warmup"] = 0
    result, _ = run.run_cell("photo12mp.rst", SEED, 0.2, False, CPU,
                             start=time.perf_counter(), bench=bench(),
                             params=params, workers=1)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] > 0


@pytest.mark.parametrize("cell", ["photo12mp.rst", "imagenet_loader.b32",
                                  "photo12mp.norst"])
def test_control_is_not_correct(cell):
    checks = control.control_run(cell, 5, params=small_params(cell))
    assert not check.passed(checks)
    assert checks["wrong_values"]["value"] > 0
    assert checks["wrong_planes"]["value"] == 0


def test_compare_counts_shapes_and_values():
    a = [np.zeros((4, 4), np.uint8), np.ones((2, 2), np.uint8)]
    assert check.compare(a, a) == (0, 0)
    b = [a[0].copy(), a[1].copy()]
    b[0][1, 1] = 9
    assert check.compare(b, a) == (1, 0)
    assert check.compare(a[:1], a) == (4, 1)
    assert check.compare([a[0], np.ones((2, 3), np.uint8)], a) == (4, 1)


def test_sample_copies_tensor_planes_into_its_slots():
    s = check.Sample(2, 1, slot_bytes=64, device=CPU)
    planes = [torch.arange(48, dtype=torch.uint8).view(6, 8),
              torch.full((2, 4), 7, dtype=torch.uint8)]
    s.offer((0, None), planes)
    s.offer((1, None), [np.zeros((2, 2), np.uint8)])  # numpy: kept as is
    planes[0].zero_()  # the program reuses its buffer
    (_, got), (_, other) = s.kept
    assert got[0].data_ptr() == s.slots[0].data_ptr()
    assert got[0].tolist() == torch.arange(48).view(6, 8).tolist()
    assert got[1].tolist() == [[7] * 4] * 2
    assert isinstance(other[0], np.ndarray)
    too_big = [torch.zeros((9, 8), dtype=torch.uint8)]
    assert check.Sample(1, 1, 64, CPU)._keep(0, too_big) is too_big


def test_sample_is_drawn_from_the_seed():
    def kept(seed):
        s = check.Sample(4, seed)
        for i in range(100):
            s.offer((i, None), None)
        return [k for k, _ in s.kept]

    assert kept(3) == kept(3)
    assert kept(3) != kept(4)
    assert len(kept(3)) == 4


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "imagenet_loader.b32", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_window_traced_where_an_end_to_end_metric_reads_the_card():
    assert run.window_traced(bench(), "photo12mp.rst")
    assert not run.window_traced(bench(), "imagenet_loader.b32")


def test_device_ms_is_the_windows_busy_time_per_image():
    from benchmark.profiler import Window
    from benchmark.records import Records, load_reader

    read = load_reader("end_to_end", "device_ms")
    rec = Records()
    assert read(rec) is None
    rec.window_trace = Window(
        device=[("k1", 0.0, 1_000.0), ("k2", 500.0, 1_500.0),
                ("Memcpy HtoD", 3_000.0, 4_000.0)],
        ranges=[], wall_s=1.0, lost=0)
    assert read(rec) is None  # no image answered
    rec.images = 4
    # busy 1500 + 1000 us over 4 images
    assert read(rec) == pytest.approx(2.5 / 4)


def test_served_mps_reads_as_mps():
    from benchmark.records import Records, load_reader

    rec = Records(pixels=12_000_000, window_s=2.0)
    assert load_reader("layers", "served_mps")(rec) == pytest.approx(6.0)
    assert (load_reader("layers", "served_mps")(rec)
            == load_reader("end_to_end", "mps")(rec))


@pytest.mark.card
def test_device_window_holds_the_windows_work():
    from benchmark import profiler

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    x = torch.ones(1 << 20, device=dev)
    with profiler.DeviceWindow(dev) as win:
        for _ in range(1000):
            x.mul_(1.0)
    assert win.device is not None
    assert len(win.device) == 1000 and win.events >= 1002
    assert all(profiler.MARKER not in name for name, _, _ in win.device)
    whole = profiler.Window(device=win.device, ranges=[], wall_s=1.0,
                            lost=0)
    assert 0 < profiler.busy_s(whole) < 1.0


@pytest.mark.card
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "imagenet_loader.b32", "--seed", "1", "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
