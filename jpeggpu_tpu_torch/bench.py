"""Benchmark of the port: bit-exact baseline-JPEG decode on one CUDA card.

    python -m jpeggpu_tpu_torch.bench                    # the headline line
    python -m jpeggpu_tpu_torch.bench --single | --all | --batch | --e2e
    python -m jpeggpu_tpu_torch.bench --profile DIR
    python -m jpeggpu_tpu_torch.bench --device cpu --size 256x96 --iters 1

The counterpart of the JAX package's ``bench.py``. Every mode prints ONE
JSON line on stdout (the default mode: ``metric``, ``value``, ``unit``,
``vs_baseline`` and the fields below) and its tables on stderr; ``--out
PATH`` writes the same object to a file. ``--device cpu`` runs the plain
versions on the host: then every device metric is ``null`` (not measured).

Images, made in the repo from ``--seed`` (no file is read) and cached with
the SHA-256 of golden's planes in ``.bench_cache/`` (``--cache``):

- the strip image: a 9-MCU-row strip of :func:`synthetic_image` encoded by
  the port's numpy encoder (4:2:0, quality 90, restart interval one MCU
  row), its restart segments repeated cyclically to the height
  (:func:`repeat_strip`); golden's planes are the strip's, repeated
  (:func:`tiled_golden`);
- the full frame: one :func:`synthetic_image` whose noise grows by band
  from sigma 1 to 12, encoded whole (PIL's libjpeg where the host has PIL,
  else the numpy encoder), so that no two restart segments repeat and
  symbol density and sync depth vary across lanes.

The gate: every timed output is held against golden before its time is
kept (the first against the SHA-256, the others against that first). A
mismatch raises :class:`GoldenMismatch`: the run exits non-zero and prints
no JSON line. Nothing is caught.

Modes (default: all of the headline's fields, 12 MP):

- headline ``value``: MP/s from bytes through ``Decoder`` (parse,
  host destuff, copy in, decode, planes copied to the host), the regime of
  the reference's own loop, which times whole iterations;
- ``latency_device_ms``: K decodes from staged inputs back to back between
  two CUDA events, / K; ``device_busy_ms``: the profiler's kernel and copy
  times of one such decode (the median of three profiles);
  ``single_dispatch_avg_ms`` / ``max_ms``: one decode from staged inputs,
  synchronised, on the host clock;
- ``stream_mps``: a depth-2 stream: a host thread parses, plans and
  destuffs image i+1 while image i is copied in, decoded and copied out on
  the main thread's stream;
- ``batch_mps``: ``DEFAULT_BATCH`` distinct images sharing their tables as
  one merged decode from bytes (``BatchDecoder``);
- ``--e2e``: both destuff modes from bytes, in turns, each stage timed;
- ``--all``: 2848x2136, 4032x3024, 6240x4160 and 7644x5104 against the
  reference's MP/s for each size class;
- ``--profile DIR``: a ``debug.profile_trace`` of one decode.

``vs_baseline`` is against the reference's published 12 MP number on an
RTX 2070: 226.66 img/s x 12.08 MP = 2738 MP/s (``BASELINE.md``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import importlib.util
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import constants as C
from . import golden
from .api import Decoder
from .encoder import EncodeSpec, encode
from .ops import huffman as H
from .parallel.batch import BatchDecoder
from .parallel.weakscale import planes_sha256
from .pipeline import build_inputs, build_plan, decode_pipeline, stage_inputs
from .reader import parse

BASELINE_MPS = 226.66 * 12.08  # the reference on an RTX 2070, 12 MP class
ITERS = 20
DEFAULT_BATCH = 16  # bench.py's merged batch of the headline
BATCH_SIZES = (8, DEFAULT_BATCH)
FULL_W, FULL_H, QUALITY = 4032, 3024, 90
STRIP_ROWS = 9
S420 = [(2, 2), (1, 1), (1, 1)]
CACHE = pathlib.Path(__file__).resolve().parent.parent / ".bench_cache"
# bench.py's sizes (the reference's size classes) and the reference's MP/s
# for each class, from its README table (bench.py:258)
ALL_SIZES = (("06mp", 2848, 2136), ("12mp", 4032, 3024),
             ("26mp", 6240, 4160), ("39mp", 7644, 5104))
REF_MPS = {"06mp": 3420.0, "12mp": 2738.0, "26mp": 1800.0, "39mp": 6200.0}
FRAME_SIGMAS = (1.0, 12.0)  # noise of the full frame's first and last band
FRAME_BANDS = 12


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --- images -----------------------------------------------------------------

def synthetic_image(h: int, w: int, seed: int, sigma=4.2) -> np.ndarray:
    """Photo-like RGB test image: a smooth random field (bilinear
    interpolation of a coarse grid) plus Gaussian noise of deviation
    ``sigma``, a number or one per row."""
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3)).astype(np.float32)
    ys = np.arange(h, dtype=np.float32) / 32.0
    xs = np.arange(w, dtype=np.float32) / 32.0
    y0, x0 = ys.astype(np.int64), xs.astype(np.int64)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
    bot = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
    sigma = np.asarray(sigma, np.float32)
    if sigma.ndim:
        sigma = sigma[:, None, None]
    img = top * (1 - fy) + bot * fy + rng.normal(0, 1, top.shape) * sigma
    return np.clip(img, 0, 255).astype(np.uint8)


def _sof_height(head: bytearray, height: int) -> None:
    pos = 2
    while head[pos + 1] != C.MARKER_SOF0:
        pos += 2 + int.from_bytes(head[pos + 2:pos + 4], "big")
    head[pos + 5:pos + 7] = height.to_bytes(2, "big")


def repeat_strip(strip: bytes, height: int) -> bytes:
    """A JPEG of `height` lines from a strip JPEG whose restart interval is
    one MCU row: the strip's restart segments (independent by construction)
    are repeated in turn, one per MCU row of the new image, RSTn renumbered
    mod 8, the SOF height patched. A height that is no whole number of MCU
    rows ends in a partial row, which the decoder crops."""
    stream = parse(strip)
    scan, = stream.scans
    if stream.restart_interval != scan.num_mcus_x:
        raise ValueError("the strip's restart interval is not one MCU row")
    rows = -(-height // (8 * stream.ss_max_y))
    head = bytearray(strip[:scan.begin])
    _sof_height(head, height)
    body = strip[scan.begin:scan.end]
    segs = [body[a:b] for a, b in scan.seg_raw]
    out = bytearray(head)
    for r in range(rows):
        if r:
            out += bytes([0xFF, C.MARKER_RST0 + ((r - 1) & 7)])
        out += segs[r % len(segs)]
    out += bytes([0xFF, C.MARKER_EOI])
    return bytes(out)


def tiled_golden(strip: bytes, height: int) -> List[np.ndarray]:
    """Golden's planes of ``repeat_strip(strip, height)``: each MCU row is
    a restart segment of its own, so the image's planes are the strip's,
    repeated cyclically and cropped to the components' heights (golden
    decodes only the strip)."""
    planes = golden.decode(strip)
    stream = parse(strip)
    out = []
    for p, comp in zip(planes, stream.components):
        comp_h = -(-height * comp.ss_y // stream.ss_max_y)
        out.append(np.tile(p, (-(-comp_h // p.shape[0]), 1))[:comp_h])
    return out


def make_image(seed: int, quality: int, strip_rows: int = STRIP_ROWS,
               width: int = FULL_W, height: int = FULL_H):
    """The strip image: a strip of `strip_rows` MCU rows of
    :func:`synthetic_image` encoded with the numpy encoder (4:2:0, restart
    interval one MCU row), and the image of `height` lines that repeats
    its restart segments. Returns (strip, image), made once per set of
    arguments."""
    return _make_image(seed, quality, strip_rows, width, height)


@functools.lru_cache(maxsize=None)
def _make_image(seed, quality, strip_rows, width, height):
    t0 = time.perf_counter()
    strip_img = synthetic_image(16 * strip_rows, width, seed)
    strip = encode(strip_img, EncodeSpec(
        quality=quality, sampling=S420, restart_interval=-(-width // 16)))
    data = repeat_strip(strip, height)
    log(f"{width}x{height} JPEG at quality {quality}: {len(data)} bytes "
        f"from a {strip_rows}-row strip, made in "
        f"{time.perf_counter() - t0:.1f} s")
    return strip, data


def frame_encoder() -> str:
    """The encoder of the full frame: "pil" where the host has PIL, else
    "numpy" (the port's encoder)."""
    return "pil" if importlib.util.find_spec("PIL") else "numpy"


def make_frame(seed: int, width: int = FULL_W, height: int = FULL_H,
               quality: int = QUALITY) -> bytes:
    """The full frame: one :func:`synthetic_image` whose noise steps from
    sigma 1 to 12 over `FRAME_BANDS` bands of rows, encoded whole (4:2:0,
    restart interval one MCU row, standard tables) by
    :func:`frame_encoder`'s encoder: every restart segment is its own
    rows."""
    band = np.arange(height) * FRAME_BANDS // height
    lo, hi = FRAME_SIGMAS
    img = synthetic_image(height, width, seed,
                          lo + (hi - lo) * band / (FRAME_BANDS - 1))
    if frame_encoder() == "pil":
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality,
                                  subsampling=2, restart_marker_rows=1)
        return buf.getvalue()
    return encode(img, EncodeSpec(quality=quality, sampling=S420,
                                  restart_interval=-(-width // 16)))


@dataclasses.dataclass(frozen=True)
class BenchImage:
    """One benchmark image: its JPEG bytes, the SHA-256 of golden's planes
    (:func:`planes_sha256`) and what made it."""

    name: str
    data: bytes
    sha256: str
    encoder: str

    @property
    def mp(self) -> float:
        s = parse(self.data)
        return s.size_x * s.size_y / 1e6


def _cached(name: str, encoder: str, make: Callable[[], bytes],
            expect: Callable[[bytes], List[np.ndarray]],
            cache: pathlib.Path) -> BenchImage:
    """`name` from the cache (``<name>.jpg`` and ``<name>.sha256``), else
    made by `make`, its golden planes by `expect`, and both written."""
    jpg, sha = cache / f"{name}.jpg", cache / f"{name}.sha256"
    if jpg.exists() and sha.exists():
        return BenchImage(name, jpg.read_bytes(), sha.read_text().strip(),
                          encoder)
    data = make()
    t0 = time.perf_counter()
    digest = planes_sha256(expect(data))
    log(f"{name}: golden's SHA-256 in {time.perf_counter() - t0:.1f} s")
    cache.mkdir(parents=True, exist_ok=True)
    jpg.write_bytes(data)
    sha.write_text(digest + "\n")
    return BenchImage(name, data, digest, encoder)


def strip_image(seed: int, width: int = FULL_W, height: int = FULL_H,
                quality: int = QUALITY, cache: pathlib.Path = CACHE
                ) -> BenchImage:
    """The strip image of `seed` (:func:`make_image`), gated by
    :func:`tiled_golden`."""
    return _cached(
        f"strip{STRIP_ROWS}_{width}x{height}_q{quality}_seed{seed}", "numpy",
        lambda: make_image(seed, quality, STRIP_ROWS, width, height)[1],
        lambda _: tiled_golden(
            make_image(seed, quality, STRIP_ROWS, width, height)[0], height),
        cache)


def frame_image(seed: int, width: int = FULL_W, height: int = FULL_H,
                cache: pathlib.Path = CACHE) -> BenchImage:
    """The full frame of `seed` (:func:`make_frame`), gated by golden of
    the whole image."""
    enc = frame_encoder()

    def make():
        t0 = time.perf_counter()
        data = make_frame(seed, width, height)
        log(f"{width}x{height} full frame at quality {QUALITY}: "
            f"{len(data)} bytes, encoder {enc}, made in "
            f"{time.perf_counter() - t0:.1f} s")
        return data

    return _cached(f"frame_{width}x{height}_q{QUALITY}_seed{seed}_{enc}",
                   enc, make, golden.decode, cache)


# --- the gate ---------------------------------------------------------------

class GoldenMismatch(AssertionError):
    """A timed output differs from golden's planes."""


class Gate:
    """Holds a decode's outputs of one image against golden: the first
    output on each device (or on the host, for numpy planes) against the
    SHA-256 of golden's planes, and every later one against that first,
    which it keeps."""

    def __init__(self, image: BenchImage):
        self.image = image
        self._held: Dict[str, List] = {}

    def __call__(self, planes: Sequence) -> None:
        tensors = isinstance(planes[0], torch.Tensor)
        key = str(planes[0].device) if tensors else "host"
        held = self._held.get(key)
        if held is None:
            host = [p.contiguous().cpu().numpy() if tensors else p
                    for p in planes]
            got = planes_sha256(host)
            if got != self.image.sha256:
                raise GoldenMismatch(
                    f"{self.image.name}: the planes' SHA-256 {got} is not "
                    f"golden's {self.image.sha256}")
            self._held[key] = [p.clone() if tensors else p.copy()
                               for p in planes]
            return
        same = len(planes) == len(held) and all(
            (a.shape == b.shape and a.dtype == b.dtype
             and (torch.equal(a, b) if tensors else np.array_equal(a, b)))
            for a, b in zip(planes, held))
        if not same:
            raise GoldenMismatch(f"{self.image.name}: a decode's planes "
                                 f"differ from golden's")


# --- timing -----------------------------------------------------------------

def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _stats(times):
    med = sorted(times)[len(times) // 2]
    return dict(med_ms=med * 1e3,
                avg_ms=sum(times) / len(times) * 1e3,
                max_ms=max(times) * 1e3)


def _time_loop(run_once, iters, warmup=2, check=None):
    """`run_once()` `warmup` times, then `iters` times on the host clock;
    `check` takes each output, off the clock."""
    for _ in range(warmup):
        out = run_once()
        if check:
            check(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = run_once()
        times.append(time.perf_counter() - t0)
        if check:
            check(out)
    return _stats(times)


def _roofline(stream, mps):
    """Bandwidth implied by an MP/s number: entropy-stream bytes/s (what
    the bit-serial Huffman stages chew through) and coefficient bytes/s
    (the int16 stream the write and IDCT stages move, at least one write
    and one read)."""
    mp = stream.size_x * stream.size_y / 1e6
    entropy_b = sum(s.end - s.begin for s in stream.scans)
    plan = build_plan(stream)
    coeff_b = sum(sp.cfg.total_positions * 2 for sp in plan.signature.scans)
    img_s = mps / mp
    return dict(entropy_gbs=round(entropy_b * img_s / 1e9, 3),
                coeff_gbs=round(coeff_b * img_s / 1e9, 3))


def _prepare(data: bytes, dev: torch.device):
    """One image staged once on `dev`. Returns its MP, `decode()`, which
    enqueues a decode from the staged inputs and returns the planes on the
    device, and `run_once()`, the same synchronised on the output."""
    stream = parse(data)
    mp = stream.size_x * stream.size_y / 1e6
    plan = build_plan(stream)
    staged = stage_inputs(build_inputs(data, plan), plan, dev)

    def decode():
        return decode_pipeline(plan.signature, staged["scans"],
                               staged["qtables"])

    def run_once():
        out = decode()
        sync(dev)
        return out

    return mp, decode, run_once


def _bench_one(image: BenchImage, gate: Gate, dev: torch.device,
               iters: int = ITERS, warmup: int = 2):
    """Single dispatch: one decode from staged inputs at a time."""
    mp, _, run_once = _prepare(image.data, dev)
    s = _time_loop(run_once, iters, warmup=warmup, check=gate)
    s["mps"] = mp / (s["med_ms"] / 1e3)
    s["img_s"] = 1e3 / s["med_ms"]
    s["mp"] = mp
    return s


def on_card(e) -> bool:
    """A profiler event that is device work: a kernel or a copy, not the
    device-side range of a `jpeggpu.*` scope (`debug.scope`), whose time
    is that of the kernels inside it."""
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not e.is_user_annotation


MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
MARKER_CYCLES = 1000
# one try each: (host seconds idle before the first launch of a profiler
# window and after its last, marker launches that open the window)
PROFILER_TRIES = ((0.0, 64), (0.01, 256), (0.1, 1024), (1.0, 4096))
# profiler windows taken again because they lost device events, and the
# most opening markers a window that counted lost
windows_lost = 0
markers_lost_max = 0


def _marker(dev: torch.device) -> None:
    """One short launch that brackets a profiler window, synchronised."""
    with torch.cuda.device(dev):
        torch.cuda._sleep(MARKER_CYCLES)
    sync(dev)


def profiled(dev: torch.device, run) -> List:
    """The device events (`on_card`) of one `run()` in a torch.profiler
    window, in order of their start, marker launches left out.

    The profiler can lose the first device events of a window: none, the
    first launch, tens of them, or all of a short window. So a window opens
    with marker launches, which may be lost, and closes with one: it counts
    where its first and its last device events are markers and `run`
    showed some device work. A window that does not count is logged,
    counted in
    `windows_lost` and taken again, with more markers to open it and the
    host idle for longer at both ends (`PROFILER_TRIES`); fails where no
    window counts. The most opening markers lost in a window that counted
    is kept in `markers_lost_max`."""
    from torch.profiler import ProfilerActivity, profile

    global windows_lost, markers_lost_max
    for attempt, (pad, lead) in enumerate(PROFILER_TRIES, 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(lead):
                _marker(dev)
            run()
            sync(dev)
            _marker(dev)
            time.sleep(pad)
        events = sorted((e for e in prof.events() if on_card(e)),
                        key=lambda e: e.time_range.start)
        work = [e for e in events if MARKER not in e.name]
        opened = bool(events) and MARKER in events[0].name
        closed = bool(events) and MARKER in events[-1].name
        seen = len(events) - len(work)
        if opened and closed and work:
            markers_lost_max = max(markers_lost_max, lead + 1 - seen)
            return work
        windows_lost += 1
        log(f"profiler window {attempt} of {len(PROFILER_TRIES)} (host idle "
            f"{pad * 1e3:.0f} ms at each end, {lead} + 1 markers) lost "
            f"device events: {seen} markers and {len(work)} events of the "
            f"run seen, the first "
            + ", ".join(f"{e.name[:40]} at {e.time_range.start:.1f} us"
                        for e in events[:3]))
    raise AssertionError(f"the profiler saw no whole window of device work "
                         f"in {len(PROFILER_TRIES)} tries")


def device_work(dev: torch.device, run):
    """(kernel name, device ms) of each launch the profiler sees in one
    `run()` (`profiled`)."""
    return [(e.name, e.self_device_time_total / 1e3)
            for e in profiled(dev, run)]


def _bench_device(image: BenchImage, gate: Gate, dev: torch.device,
                  iters: int = ITERS):
    """The device time of one decode from staged inputs: `iters` decodes
    back to back between two CUDA events, / `iters` (each decode's sync
    rounds still read their flags); and the device busy time of one decode,
    the sum of the profiler's kernel and copy times. None on the CPU."""
    if dev.type != "cuda":
        return dict(device_ms=None, busy_ms=None, kernels=None)
    mp, decode, run_once = _prepare(image.data, dev)
    gate(run_once())
    # once off the clock with every output kept, so that the caching
    # allocator holds the memory of `iters` outputs before the timed pass
    outs = [decode() for _ in range(iters)]
    sync(dev)
    del outs
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [decode() for _ in range(iters)]
    end.record()
    sync(dev)
    ms = start.elapsed_time(end) / iters
    for out in outs:
        gate(out)
    del outs
    # the profile whose busy time is the median of three
    work = sorted((device_work(dev, run_once) for _ in range(3)),
                  key=lambda w: sum(t for _, t in w))[1]
    kernels: Dict[str, Dict] = {}
    for name, t in work:
        k = kernels.setdefault(_kernel_name(name), dict(launches=0, ms=0.0))
        k["launches"] += 1
        k["ms"] += t
    return dict(device_ms=ms, mps=mp / (ms / 1e3),
                busy_ms=sum(t for _, t in work), kernels=kernels)


def _kernel_name(name: str) -> str:
    """A profiler event's kernel without its template and parameter lists:
    ``void jpeggpu::subseq_pass_kernel<true>(...)`` ->
    ``jpeggpu::subseq_pass_kernel``, ``Memcpy DtoH (Device -> Pinned)`` ->
    ``Memcpy DtoH``."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return re.split(r"[<(]", name)[0].strip()


def _stage_host(data: bytes):
    """The host half of one image's staging: parse, plan, host inputs."""
    plan = build_plan(parse(data))
    return plan, build_inputs(data, plan)


def _bench_stream(image: BenchImage, gate: Gate, dev: torch.device,
                  iters: int = ITERS):
    """A depth-2 stream of `iters` images from bytes: a host thread stages
    image i+1 (parse, plan, host destuff) while image i is copied in,
    decoded and copied out on the main thread, all on its stream. The
    planes reach the host, as from ``Decoder.decode``. The host inputs stay
    in pageable memory: copying them into pinned buffers made the thread's
    stage ~2 ms longer and the stream ~20% slower on the card than the
    pageable copy in it saves (PERF.md)."""
    mp = image.mp

    def run(n):
        outs = []
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            nxt = pool.submit(_stage_host, image.data)
            for i in range(n):
                plan, inputs = nxt.result()
                if i + 1 < n:
                    nxt = pool.submit(_stage_host, image.data)
                staged = stage_inputs(inputs, plan, dev)
                planes = decode_pipeline(plan.signature, staged["scans"],
                                         staged["qtables"])
                outs.append([p.contiguous().cpu().numpy() for p in planes])
        return outs

    for out in run(2):
        gate(out)
    t0 = time.perf_counter()
    outs = run(iters)
    dt = (time.perf_counter() - t0) / iters
    for out in outs:
        gate(out)
    return dict(mp=mp, ms=dt * 1e3, mps=mp / dt, img_s=1 / dt)


def _bench_e2e(image: BenchImage, gate: Gate, dev: torch.device,
               iters: int = ITERS, modes=(True, False)):
    """From bytes through the public five-phase API, planes on the host,
    per image, nothing excluded: ``parse_header``, ``transfer`` and
    ``decode`` each timed. One ``Decoder`` per destuff mode (`modes`:
    ``host_destuff`` values), the modes taking turns."""
    mp = image.mp
    decoders = {m: Decoder(device=dev, host_destuff=m) for m in modes}
    stages = ("parse_header", "transfer", "decode")
    times = {m: {k: [] for k in stages + ("total",)} for m in modes}
    for it in range(iters + 2):
        for m, d in decoders.items():
            t = [time.perf_counter()]
            d.parse_header(image.data)
            t.append(time.perf_counter())
            d.transfer()
            t.append(time.perf_counter())
            planes = d.decode()
            t.append(time.perf_counter())
            gate(planes)
            if it < 2:  # warmup
                continue
            for k, a, b in zip(stages, t, t[1:]):
                times[m][k].append(b - a)
            times[m]["total"].append(t[-1] - t[0])
    out = {}
    for m in modes:
        s = _stats(times[m]["total"])
        s.update(mp=mp, mps=mp / (s["med_ms"] / 1e3),
                 img_s=1e3 / s["med_ms"],
                 stages_med_ms={k: _stats(times[m][k])["med_ms"]
                                for k in stages})
        out["host_destuff" if m else "device_destuff"] = s
    return out


def lane_profile(data: bytes, dev: torch.device) -> Dict[str, int]:
    """The sync depth and lane skew of an image's one scan: K1's launches
    (the blind round, the shifted round and the Jacobi rounds), and the
    symbols per lane (``m`` of K4's records, the committed symbols) at
    most and at the median over the real lanes."""
    stream = parse(data)
    plan = build_plan(stream)
    staged = stage_inputs(build_inputs(data, plan), plan, dev)
    sp, = plan.signature.scans
    cfg, arrs = sp.cfg, staged["scans"][0]
    ctx = H.make_ctx(cfg, arrs)
    record: Dict = {}
    p, c, z, n = H.sync_states(cfg, arrs, ctx, record=record)
    n_off = H.symbol_offsets(cfg, arrs, n)
    _, m = H.decode_write_emit(cfg, arrs, ctx, p, c, z, n_off)
    m = m[:stream.scans[0].num_subsequences].cpu().numpy()
    return dict(sync_rounds=2 + sum(record["rounds"].values()),
                lanes=int(m.size), symbols=int(m.sum()),
                symbols_per_lane_max=int(m.max()),
                symbols_per_lane_median=int(np.median(m)))


def bench_batch(images: Sequence[BenchImage], dev: torch.device,
                iters: int = ITERS):
    """B images of one geometry that share their tables, from bytes as one
    merged decode (``BatchDecoder``; planes on the host) and from staged
    merged inputs (``decode_merged``, planes on the device). ms per batch
    and per image, MP/s; the device busy time of the staged decode."""
    from .parallel import batch as BT

    B = len(images)
    gates = [Gate(im) for im in images]
    datas = [im.data for im in images]
    mp = sum(im.mp for im in images)
    dec = BatchDecoder(device=dev)

    def check(outs):
        for g, planes in zip(gates, outs):
            g(planes)

    def from_bytes():
        out = dec.decode(datas)
        if dec.routes != [("merged", tuple(range(B)))]:
            raise AssertionError(f"the batch is not one merged decode: "
                                 f"{dec.routes}")
        return out

    s = _time_loop(from_bytes, iters, check=check)
    group, = dec._groups(datas)
    sig = group.plan.signature
    scans, qtables = BT.stage_merged(sig, group.inputs, dev)

    def staged():
        out = BT.decode_merged(sig, scans, qtables)
        sync(dev)
        return out

    def check_staged(comps):
        # per component [B, h, w]: image b's planes are index b
        check([[p[b] for p in comps] for b in range(B)])

    st = _time_loop(staged, iters, check=check_staged)
    busy = (sum(t for _, t in device_work(dev, staged))
            if dev.type == "cuda" else None)
    result = dict(batch=B, mp=mp, ms=s["med_ms"], max_ms=s["max_ms"],
                  per_img_ms=s["med_ms"] / B, mps=mp / (s["med_ms"] / 1e3),
                  staged_ms=st["med_ms"], staged_per_img_ms=st["med_ms"] / B,
                  staged_mps=mp / (st["med_ms"] / 1e3), device_busy_ms=busy)
    log(f"batch B={B} merged, from bytes: {result['ms']:.2f} ms = "
        f"{result['per_img_ms']:.2f} ms per image = {result['mps']:.1f} "
        f"MP/s; from staged inputs {result['staged_ms']:.2f} ms = "
        f"{result['staged_mps']:.1f} MP/s; device busy "
        f"{fmt_ms(busy)} ms")
    return result


def fmt_ms(v, digits=3) -> str:
    return "not measured" if v is None else f"{v:.{digits}f}"


def comparators(image: BenchImage, dev: torch.device,
                iters: int = ITERS) -> Dict[str, Optional[float]]:
    """MP/s of the same bytes through the decoders this host has, timed
    here and used nowhere in the port (their outputs are RGB, so no gate):
    PIL's libjpeg on the host and ``torchvision.io.decode_jpeg`` on the card
    (nvJPEG, the reference's own comparator). None where absent."""
    mp = image.mp
    out: Dict[str, Optional[float]] = dict(pil_cpu_mps=None, nvjpeg_mps=None)
    if importlib.util.find_spec("PIL"):
        from PIL import Image

        def pil():
            with Image.open(io.BytesIO(image.data)) as im:
                im.load()

        out["pil_cpu_mps"] = mp / (_time_loop(pil, iters)["med_ms"] / 1e3)
    if dev.type == "cuda" and importlib.util.find_spec("torchvision"):
        from torchvision.io import decode_jpeg

        raw = torch.frombuffer(bytearray(image.data), dtype=torch.uint8)

        def nvjpeg():
            decode_jpeg(raw, device=dev)
            sync(dev)

        out["nvjpeg_mps"] = mp / (_time_loop(nvjpeg, iters)["med_ms"] / 1e3)
    return out


def smi(query: str) -> str:
    """One line of `nvidia-smi --query-gpu=<query>` for the card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def card_fields(dev: torch.device) -> Dict[str, Optional[str]]:
    """The device the numbers were taken on: the card's name and power
    limit from nvidia-smi, or the host's CPU."""
    if dev.type != "cuda":
        return dict(device="cpu", card=None, power_limit=None)
    name, limit = (v.strip() for v in smi("name,power.limit").split(","))
    return dict(device=torch.cuda.get_device_name(dev), card=name,
                power_limit=limit)


# --- modes ------------------------------------------------------------------

def image_fields(image: BenchImage, dev: torch.device, iters: int):
    """Every per-image number of the headline: from bytes (host destuff),
    single dispatch, the device time and busy time, the stream, and the
    image's sync depth and lane skew."""
    gate = Gate(image)
    e2e = _bench_e2e(image, gate, dev, iters, modes=(True,))["host_destuff"]
    log(f"{image.name}: from bytes {e2e['med_ms']:.2f} ms = "
        f"{e2e['mps']:.1f} MP/s (stages {e2e['stages_med_ms']})")
    lat = _bench_one(image, gate, dev, iters)
    log(f"{image.name}: single dispatch from staged inputs: avg "
        f"{lat['avg_ms']:.2f} ms, max {lat['max_ms']:.2f} ms")
    dv = _bench_device(image, gate, dev, iters)
    log(f"{image.name}: {iters} decodes back to back: "
        f"{fmt_ms(dv['device_ms'])} ms each; device busy "
        f"{fmt_ms(dv['busy_ms'])} ms")
    s = _bench_stream(image, gate, dev, iters)
    log(f"{image.name}: depth-2 stream {s['ms']:.2f} ms per image = "
        f"{s['mps']:.1f} MP/s")
    lanes = lane_profile(image.data, dev)
    log(f"{image.name}: {lanes}")
    return dict(image=image.name, encoder=image.encoder,
                bytes=len(image.data), mp=e2e["mp"], mps=e2e["mps"],
                latency_from_bytes_ms=e2e["med_ms"],
                stages_from_bytes_ms=e2e["stages_med_ms"],
                latency_device_ms=dv["device_ms"],
                device_busy_ms=dv["busy_ms"], device_kernels=dv["kernels"],
                stream_mps=s["mps"], single_dispatch_avg_ms=lat["avg_ms"],
                single_dispatch_max_ms=lat["max_ms"],
                single_dispatch_mps=lat["mps"], **lanes)


def run_headline(dev: torch.device, iters: int, seed: int, width: int,
                 height: int, cache: pathlib.Path) -> Dict:
    """The default mode: the headline on the strip image, the full frame's
    numbers beside it, the merged batch of ``DEFAULT_BATCH``, the
    comparators and the card."""
    frame = frame_image(seed, width, height, cache=cache)
    full = image_fields(frame, dev, iters)
    strip = strip_image(seed, width, height, cache=cache)
    head = image_fields(strip, dev, iters)
    batch = bench_batch([strip] + [
        strip_image(seed + k, width, height, cache=cache)
        for k in range(1, DEFAULT_BATCH)], dev, max(iters // 2, 1))
    mps = head.pop("mps")
    return dict(
        metric=f"decode_throughput_{_size_name(width, height)}_from_bytes",
        value=mps, unit="MP/s", vs_baseline=mps / BASELINE_MPS,
        **card_fields(dev), **head,
        batch_mps=batch["mps"], batch_size=batch["batch"],
        batch_vs_baseline=batch["mps"] / BASELINE_MPS,
        batch_per_img_ms=batch["per_img_ms"],
        batch_staged_per_img_ms=batch["staged_per_img_ms"],
        batch_device_busy_ms=batch["device_busy_ms"],
        **_roofline(parse(strip.data), mps),
        **comparators(strip, dev, iters), frame=full, iters=iters, seed=seed)


def _size_name(width: int, height: int) -> str:
    if (width, height) == (FULL_W, FULL_H):
        return "12mp"
    return f"{width}x{height}"


def run_single(dev, iters, seed, width, height, cache) -> Dict:
    """--single: one decode from staged inputs at a time, as the line."""
    image = strip_image(seed, width, height, cache=cache)
    s = _bench_one(image, Gate(image), dev, iters)
    log(f"single: {s['img_s']:.2f} img/s, avg {s['avg_ms']:.2f} ms, max "
        f"{s['max_ms']:.2f} ms, {s['mps']:.1f} MP/s")
    return dict(
        metric=f"decode_throughput_{_size_name(width, height)}_single_dispatch",
        value=s["mps"], unit="MP/s", vs_baseline=s["mps"] / BASELINE_MPS,
        **card_fields(dev), image=image.name, **s,
        **_roofline(parse(image.data), s["mps"]))


def run_e2e(dev, iters, seed, width, height, cache) -> Dict:
    """--e2e: from bytes in both destuff modes, in turns, on the strip
    image and the full frame."""
    out = {}
    for image in (strip_image(seed, width, height, cache=cache),
                  frame_image(seed, width, height, cache=cache)):
        r = _bench_e2e(image, Gate(image), dev, iters)
        for mode, s in r.items():
            log(f"e2e {image.name}, {mode}: {s['med_ms']:.2f} ms = "
                f"{s['mps']:.1f} MP/s, stages "
                f"{s['stages_med_ms']}")
        out[image.name] = r
    first = next(iter(out.values()))["host_destuff"]["mps"]
    return dict(
        metric=f"decode_throughput_{_size_name(width, height)}_from_bytes_e2e",
        value=first, unit="MP/s", vs_baseline=first / BASELINE_MPS,
        **card_fields(dev), images=out)


def run_batch(dev, iters, seed, width, height, cache) -> Dict:
    """--batch: the merged batch at each of ``BATCH_SIZES``."""
    images = [strip_image(seed + k, width, height, cache=cache)
              for k in range(max(BATCH_SIZES))]
    out = {str(b): bench_batch(images[:b], dev, iters) for b in BATCH_SIZES}
    best = out[str(DEFAULT_BATCH)]["mps"]
    return dict(
        metric=f"decode_throughput_{_size_name(width, height)}_batch",
        value=best, unit="MP/s", vs_baseline=best / BASELINE_MPS,
        batch_size=DEFAULT_BATCH, **card_fields(dev), batches=out)


def run_all(dev, iters, seed, cache) -> Dict:
    """--all: bench.py's four sizes (strip images), each from bytes, single
    dispatch and by device time, against the reference's MP/s for its size
    class (from bytes)."""
    log(f"{'config':8s} {'MP':>6s} {'bytes ms':>9s} {'MP/s':>8s} "
        f"{'staged ms':>10s} {'dev ms':>8s} {'busy ms':>8s} {'vs ref':>7s}")
    results = {}
    for name, w, h in ALL_SIZES:
        image = strip_image(seed, w, h, cache=cache)
        gate = Gate(image)
        e2e = _bench_e2e(image, gate, dev, iters,
                         modes=(True,))["host_destuff"]
        lat = _bench_one(image, gate, dev, iters)
        dv = _bench_device(image, gate, dev, iters)
        r = dict(image=image.name, mp=e2e["mp"], mps=e2e["mps"],
                 latency_from_bytes_ms=e2e["med_ms"],
                 stages_from_bytes_ms=e2e["stages_med_ms"],
                 single_dispatch_avg_ms=lat["avg_ms"],
                 single_dispatch_max_ms=lat["max_ms"],
                 latency_device_ms=dv["device_ms"],
                 device_busy_ms=dv["busy_ms"], ref_mps=REF_MPS[name],
                 vs_ref_size=e2e["mps"] / REF_MPS[name])
        results[name] = r
        log(f"{name:8s} {r['mp']:6.2f} {r['latency_from_bytes_ms']:9.2f} "
            f"{r['mps']:8.1f} {r['single_dispatch_avg_ms']:10.2f} "
            f"{fmt_ms(r['latency_device_ms'], 2):>8s} "
            f"{fmt_ms(r['device_busy_ms'], 2):>8s} {r['vs_ref_size']:7.3f}")
    v = results["12mp"]["mps"]
    return dict(metric="decode_throughput_by_size_from_bytes", value=v,
                unit="MP/s", vs_baseline=v / BASELINE_MPS,
                **card_fields(dev), sizes=results)


def run_profile(dev, log_dir, seed, width, height, cache) -> Dict:
    """--profile DIR: a ``debug.profile_trace`` of one decode from bytes
    and one from staged inputs, after a warm-up outside the trace."""
    from .debug import profile_trace

    image = strip_image(seed, width, height, cache=cache)
    gate = Gate(image)
    before = set(pathlib.Path(log_dir).glob("*.json")) if os.path.isdir(
        log_dir) else set()
    _bench_e2e(image, gate, dev, 1, modes=(True,))
    _bench_one(image, gate, dev, iters=2)
    with profile_trace(log_dir):
        _bench_e2e(image, gate, dev, 1, modes=(True,))
        _bench_one(image, gate, dev, iters=1, warmup=0)
    traces = sorted(str(p) for p in set(
        pathlib.Path(log_dir).glob("*.json")) - before)
    log(f"profiler trace written to {traces}")
    return dict(metric="profile_trace", value=len(traces), unit="traces",
                vs_baseline=None, **card_fields(dev), image=image.name,
                traces=traces)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jpeggpu_tpu_torch.bench",
        description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--single", action="store_true")
    mode.add_argument("--all", action="store_true")
    mode.add_argument("--batch", action="store_true")
    mode.add_argument("--e2e", action="store_true")
    mode.add_argument("--profile", metavar="DIR")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--size", default=f"{FULL_W}x{FULL_H}",
                    help="WxH of the images (not --all)")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions; default the card")
    ap.add_argument("--cache", default=str(CACHE),
                    help="directory of the cached images and hashes")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    dev = torch.device(args.device) if args.device else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the bench runs on a CUDA device and none is "
                               "available; pass --device cpu for the plain "
                               "versions")
        dev = torch.device("cuda", torch.cuda.current_device())
    width, height = (int(v) for v in args.size.lower().split("x"))
    cache = pathlib.Path(args.cache)
    common = (dev, args.iters, args.seed, width, height, cache)
    if args.single:
        result = run_single(*common)
    elif args.all:
        result = run_all(dev, args.iters, args.seed, cache)
    elif args.batch:
        result = run_batch(*common)
    elif args.e2e:
        result = run_e2e(*common)
    elif args.profile:
        result = run_profile(dev, args.profile, args.seed, width, height,
                             cache)
    else:
        result = run_headline(*common)
    line = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
