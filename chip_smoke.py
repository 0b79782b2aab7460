#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Drives `jpeggpu_tpu_torch` end to end and fails (non-zero exit, no result
line) on the first phase that fails; nothing is caught and carried past:

1. environment: torch / CUDA versions, the card's name and power limit;
2. builds the nine CUDA kernels (K1 with its gathered mode) from
   `jpeggpu_tpu_torch/kernels/csrc` and
   the native host destuffer (the run fails where that one is missing, so
   that every host time below is the native destuffer's);
3. small streams made with the port's encoder from a numpy seed: the whole
   bit-exact matrix of the JAX package's tests and its robustness streams
   that decode (`tests/torch_cases.matrix_streams`: every sampling, restart
   intervals, non-interleaved scans, four components, quality 10 to 100,
   saturated, per-scan and frequency-optimal Huffman tables, a truncated
   scan, a garbage body, a DNL segment, a dangling RST):
   decode on the card == the port's numpy golden decoder, exactly, on the
   default path, sharded over 2 and 4 shards, as one `decode_batch` (pixels
   and, with `with_idct=False`, coefficient planes), and again under a
   plan built with
   `Tuning(write_mode="tiles", tile_mode="super")` (the records write
   path) and again with `tile_mode="lane"` (its per-lane tile shape),
   there also a flat low-entropy image, whose lanes drain through the
   leftover scatter, and a garbage scan body; K7 and K8 are also held
   against their plain versions on made-up inputs that no decoder emits
   (sums that wrap, first data units out of range and unsorted, windows
   that leave the lanes; K8 with and without `reach`), and so are K1, K2
   and K4 (random words, random states and entry states, saturated tables,
   garbage DC categories and codes of up to 16 bits, whose symbols escape
   the one-lookup symbol table or take the reader's seek; K1's flags and
   the whole sync loop included), K3 (`phase_k3_any_input`: 4:2:0, 4:2:2,
   4:4:0, 4:1:1, 4:4:4, gray and non-interleaved geometries, MCU rows of
   1, R-1, R and R+1 MCUs for a run of R, coefficients and DC at +-32767
   and -32768, table bytes at and above 128; all components in one launch
   and each alone, one image and a batch of three with their own tables;
   `phase_k3_batch`: sixteen images of `imagenet_loader.b32`'s 500x375
   shape in one launch, against the plain version and sixteen one-image
   launches, timed warm and cold beside its byte bound and beside its
   one-image launch) and K9 (made-up planes, one at a time and of mixed
   shapes in one launch);
4. a 4032x3024 (12 MP) interleaved 4:2:0 JPEG, restart interval 252,
   quality 90, made from a seed: a strip of MCU rows is encoded with the
   numpy encoder and its restart segments are repeated to 189 rows. At
   these shapes each kernel's wrapper is held against its plain PyTorch
   version on the same CUDA tensors (all exact, max_abs_err must be 0): K1,
   the whole sync round in one launch, on the blind and on a shifted round
   (states and convergence flag), K2 on the whole coefficient stream, K3
   (one launch for all three components, and each component alone), and
   the records write path's K4
   (from the converged states), K5 (from the preparation of K4's records)
   and K6 (from K5's supertiles). The strip itself is checked against
   the golden decoder, and `jpeggpu_tpu_torch.decode` of the 12 MP image
   against the plain path (the same pipeline on CPU tensors);
5. the main paths, each with every launch count set to 0 just before and
   read just after: `jpeggpu_tpu_torch.decode(data)` must launch K1 once
   per sync round (as many as `sync_states` alone takes on the image), K2
   once, K3 once per scan (covering every component once) and none of
   K4-K9; `decode_jpeg_device(data, plan=build_plan(
   parse(data), tuning=Tuning(write_mode="tiles")))`, and a `Decoder`
   under `set_default_tuning`, must launch K1, K4, K5, K6 and K3 and not
   K2, K7 or K8, and give the same planes;
5b. the sparse 12 MP image: the same generator and seed at quality 30,
   where `tile_mode="auto"` must resolve to the per-lane shape. At its
   shapes K7 (from the preparation of K4's records) and K8 (from K7's
   tiles, with the `reach` that the path passes and at the full tile
   depth: the same rows) are held against their plain versions (exact),
   and K8's bound is given both ways. Then the third
   main path, `decode_jpeg_device(data, plan=build_plan(parse(data),
   tuning=Tuning(write_mode="tiles")))` on this image, counted as above:
   it must launch K1, K4, K7, K8 and K3 and none of K2, K5, K6, and equal
   the default path and the plain path. The default path, the forced
   supertile shape and `auto` are timed on this image side by side;
6. times, each beside its bound. Every kernel is timed twice with the
   host's enqueue cost off the clock (launches queued behind a spinning
   kernel): with L2 warm (CUDA events around 20 identical launches, median
   of 5 such runs) and with L2 cold (128 MB written between launches, each
   launch between its own pair of events, median of 20). `ms` in the
   `kernels` line is the cold time for K2-K8, whose inputs in a decode
   were last touched tens of MB earlier, and the warm time for K1, whose
   rounds follow each other over the same 2.6 MB of words; both times are
   in the line. The kernels' times inside a real decode (the profiler's)
   are printed beside them (and kept in the `kernels` line for K1, K2 and
   the records path's K4-K8), and K1's and K2's cycles per symbol of the
   longest lane (in-decode time x `clocks.sm` from nvidia-smi, read while
   the card decodes, / the longest lane's symbols). The profiler's window
   of one `sync_states` must show one K1 launch per round and, besides the
   one read per round, no more than a set-up of two launches. Every
   profiler window is bracketed by marker launches (`profiled`): one
   that lost its opening or closing markers, or all device work, is taken
   again with more opening markers and the host idle longer at both ends,
   up to four windows, and then fails the run; the number taken again is
   logged at the end. Also end-to-end ms and MP/s with and without host
   staging, and one `reader.parse`, which must take the native header pass
   (`reader.parses`) and whose every scan the native segment walk
   (`reader.walks`);
6b. the batch path (`parallel/batch.py`): eight 12 MP images at quality
   90 (seeds seed .. seed+7) through `BatchDecoder(device=dev).decode`, one
   merged group at 8 x lanes: K1 held against its plain version on a round
   at that width, K2 on the merged stream, K3 on the last image's slice of
   it and the group's tail (one DC un-delta, one K3 launch) on all of it;
   the merged sync's rounds against each image's own; K1 and K2 at
   widths of 1, 2, 4 and 8 images; the path counted (K1 once per merged
   round, K2 once, K3 once for the eight, nothing else), each image == its own
   decode; its times against the same images' single decodes in turns,
   its device busy share, its host stages and peak memory. Then the batch
   under `set_default_tuning(Tuning(write_mode="tiles"))` (supertiles on
   the eight, per-lane tiles on four quality-30 images), the mesh route
   (three images over two entries of the card, padded to four) and
   `with_idct=False`, each counted or == the single decodes;
6c. the device destuff (`Decoder(host_destuff=False)`, `ops/destuff.py`,
   tensor code): on every small stream `destuff_scan` on the card == the
   host destuffer's words, and the decode == golden on the default path
   and under `Tuning(write_mode="tiles")`; on both 12 MP images its
   launches are the default path's (K1 once per round, K2, K3;
   `launches_device_destuff_path` in the `kernels` line) and its planes
   the default path's; then both destuff modes in turns (decode from bytes
   and from staged inputs), the host stage the device destuff replaces
   beside the destuff's device time, launches and byte bound, the bytes
   copied in, and peak device memory beside `get_buffer_size()`;
6d. the rest of the Decoder API: `decode_into` into pitched CUDA tensors
   (uint8 and int16, two images into the same memory, the pitch untouched,
   no launch beyond the default path's, InvalidArgument for a host tensor
   and a pitch below the width), `decode(donate=True)` (the staged words
   freed, peak memory beside a decode without it), debug mode on the small
   streams with the device destuff (and a corrupted destuff caught),
   `python -m jpeggpu_tpu_torch.decode_tool`, and `debug.profile_trace`,
   whose trace must hold the `jpeggpu.*` ranges and the kernels' names;
6e. the compacted sync tiers (`Tuning(sync_tiers="classic")` and
   `"ladder"`, the JAX package's tiers): K1's gathered mode
   (`ops.huffman.subseq_pass_at`, the pass of a compacted round) against
   its plain version on made-up inputs at widths 32, 80 and 5120 (lane 0,
   the last lane, segment firsts, inactive columns, both made-up tables);
   every small stream under both shapes at tiny widths == golden; on both
   12 MP images the states under both shapes == the Jacobi's, their
   rounds `(it0, it)`, K1's launches by mode and host reads, the widest
   tier's first gathered launch held against its plain version and timed
   beside its bound, the gathered launches' device time, the decode under each
   shape counted (K1 whole and gathered, K2, K3, nothing else) and ==
   golden, and `sync_states` of the three in turns; a subsequence-granular
   `decode_sharded` and the records path under the ladder == golden. The
   default path's launches stay the Jacobi's (no gathered launch on any
   other path);
6f. the multi-process batch: `python -m jpeggpu_tpu_torch.parallel.
   weakscale`'s `launch` with 1 and then 2 processes (gloo) on the one
   card, each decoding 2 of the batch's 12 MP images through `MultiHostBatchDecoder`
   and holding its planes against golden's SHA-256 (golden of a 12 MP
   image is its strip's planes repeated, `tiled_golden`, checked against
   golden of the whole image first); process 0's launches counted;
6g. the frame of the `photo12mp.rst` cell (`benchmark.inputs`, the cell's
   parameters: PIL's libjpeg, noise stepping by bands of rows, so that no
   two restart segments repeat) == golden on the paths the cell bypasses:
   the default path, under `Tuning(write_mode="auto")` (K2 launched, not
   K4), through the records path (`tile_mode="auto"`) and with the device
   destuff; its `reader.parse`, which must take the native header pass,
   timed on the card's host (median of 20);
6h. the host staging (`staging.py`): at 12 MP the pinned staging
   region's device views torch.equal to one pageable copy per array, in
   two copies; a transfer whose copy waits behind device work, then the
   same decoder's next transfer, leaves the first image's staged inputs
   as they were; two Decoders alternating over 50 images of three sizes,
   each transfer before the other's decode, every plane == golden,
   `staging.h2d_copies` two an image and `staging.host_allocs` none after
   each decoder's first image;
7. one JSON line listing the kernels, the card's name and power limit, and
   the result line.

`bound_ms` of a kernel is the larger of (bytes it must move: each input
read once, each output written once) / 3.35 TB/s and (integer operations it
does on this run's data) / 33.5e12 per second, the rate of one operation
per FP32 lane per clock that the card's 67 TFLOP/s (two per fused
multiply-add) implies. Symbols are counted from this run's coefficient
stream; operations per symbol and per pixel are counts of the kernels'
source statements, stated below.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import constants as C
from jpeggpu_tpu_torch import (convert, golden, kernels, native, pipeline,
                               reader)
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.ops import dc as DC
from jpeggpu_tpu_torch.ops import destuff as DS
from jpeggpu_tpu_torch.ops import huffman as H
from jpeggpu_tpu_torch.ops import idct as I
from jpeggpu_tpu_torch.ops import write as W
from jpeggpu_tpu_torch.parallel import BatchDecoder, decode_batch, make_mesh
from jpeggpu_tpu_torch.parallel import batch as BT
from jpeggpu_tpu_torch.parallel import segments as SEG

# the matrix of small streams (tests/torch_cases.py, shared with the CPU
# tests)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
import torch_cases  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
# integer operations per decoded symbol, counted from the source. K1 and
# K2 (kernels/csrc/subseq_pass.cu, decode_write.cu and next_symbol in
# huffman_common.cuh) for a symbol that does not escape: peek and table
# index 5, the load and the half 3, escape test 2, length, run and EOB 6,
# crossing test and state update 9, buffer shift and refill (amortised) 8;
# the write adds the category and EXTEND 12, the store address and bound
# 10. K4 (emit_pass.cu, the same next_symbol): K1's 33, the category and
# EXTEND 12, the record 11 (the value gated by the bound 2, the pack 4, the
# store and the 64-bit step to the next slot 3, the slot count and its cap
# 2)
K1_OPS_PER_SYMBOL = 33
K2_OPS_PER_SYMBOL = 55
K4_OPS_PER_SYMBOL = 56
# per pixel, from kernels/csrc/idct_stream.cu and idct_common.cuh: two
# 8-point passes of 62 operations per 8 values, the unpack 0.5 (one shift
# per two values), dequantise and wrap 2, clamp and pack 0.5 (one
# instruction per two pixels; the level shift rides on the rounding bias),
# the reordering of the unit's chunks read from shared memory 1.5 (96
# selects per unit)
K3_OPS_PER_PIXEL = 20
# K5, from kernels/csrc/supertiles.cu: unpack, gate, address and add
# per record 10, zero and pack per output cell 2. K6, from
# kernels/csrc/expand_supertiles.cu: per output cell one add per matching
# supertile row and the pack, 3, plus the window walk per 8 cells
K5_OPS_PER_RECORD, K5_OPS_PER_CELL = 10, 2
K6_OPS_PER_CELL = 4
# K7, from kernels/csrc/tiles.cu: K5's counts. K8, from
# kernels/csrc/expand_tiles.cu: per output row and candidate lane one test
# by one of the row's threads, 11 (the window's shared load, two compares
# and their and, the vote, its byte shifted and masked, widened and or-ed
# into the 64-bit mask 4); per tile row read and cell 4 (per thread and hit
# 30 over its 8 cells: the mask's test, lowest bit and its clearing 6, the
# row address 5, the load, four pairs unpacked and added 16, rounded up);
# per output cell the pack and the store 2
K7_OPS_PER_RECORD, K7_OPS_PER_CELL = 10, 2
K8_OPS_PER_CANDIDATE, K8_OPS_PER_HIT_CELL, K8_OPS_PER_CELL = 11, 4, 2
# K9, from kernels/csrc/idct_blocks.cu: K3's arithmetic without the
# reordering, rounded up
K9_OPS_PER_PIXEL = 19

TILES = T.Tuning(write_mode="tiles", tile_mode="super")
LANE = T.Tuning(write_mode="tiles", tile_mode="lane")
AUTO = T.Tuning(write_mode="tiles")

FULL_W, FULL_H, QUALITY = 4032, 3024, 90
STRIP_ROWS = 9
S420 = [(2, 2), (1, 1), (1, 1)]
QUALITY_SPARSE = 30  # the same image with > 55 data units per subsequence
SHARDS = 4  # shards of the sharded decode, all on the one card
BATCH = 8  # images of the batch, the reference bench's default
BATCH_SPARSE = 4  # images of the quality-30 batch (per-lane tiles)


def log(msg: str) -> None:
    print(msg, flush=True)


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
    stream = T.parse(strip)
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


def tiled_golden(strip: bytes, height: int):
    """Golden's planes of ``repeat_strip(strip, height)``: each MCU row is
    a restart segment of its own, so the image's planes are the strip's,
    repeated cyclically and cropped to the components' heights (golden
    decodes only the strip)."""
    planes = golden.decode(strip)
    stream = T.parse(strip)
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


def small_streams(seed: int):
    """Every stream of the bit-exact matrix and the robustness streams that
    decode (``tests/torch_cases.matrix_streams``: 4:4:4 to 4:1:1 and mixed
    samplings, restarts, non-interleaved, four components, quality 10 to
    100, frequency-optimal and saturated Huffman tables, per-scan tables, a
    truncated scan, a garbage body, a DNL segment, a dangling RST), made
    from this script's images."""
    rng = np.random.default_rng(seed)
    img = synthetic_image(45, 67, seed, sigma=6.0)
    noise = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
    return torch_cases.matrix_streams(img, noise)


# --- helpers ----------------------------------------------------------------

def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def smi(query: str) -> str:
    """One line of `nvidia-smi --query-gpu=<query>` for the card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


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


def profiled(dev: torch.device, run):
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


def time_ms(fn, dev: torch.device, launches: int = 20, reps: int = 5):
    """Median device time of one call of `fn` with L2 warm, in ms, and the
    time of a single call as the host sees it (between two events with the
    device idle, so the wrapper's enqueue cost is on the clock).

    For the device time, `launches` calls are queued behind a spinning
    kernel and timed by CUDA events as one run: the host enqueues them
    while the device spins, so they execute back to back."""
    fn()
    sync(dev)
    batched, single = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms, covers the enqueue below
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        batched.append(start.elapsed_time(end) / launches)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        single.append(start.elapsed_time(end))
    return statistics.median(batched), statistics.median(single)


def time_cold_ms(fn, dev: torch.device, launches: int = 20) -> float:
    """Median device time of one call of `fn` with L2 cold, in ms: before
    each call 128 MB (more than twice the card's L2) are written, and each
    call stands between its own pair of events. All of it is queued behind
    a spinning kernel, so the device never waits for the host."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    fn()
    sync(dev)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(launches)]
    torch.cuda._sleep(80_000_000)  # ~40 ms, covers the enqueue below
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(dev)
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def count_symbols(coeffs: torch.Tensor) -> int:
    """Huffman symbols of the scan that decodes to `coeffs` (natural order,
    DC difference-coded): one DC symbol per data unit, one per nonzero AC
    coefficient, one ZRL per 16 zeros of a run, one EOB per data unit whose
    last coefficient is zero."""
    dev = coeffs.device
    natural = torch.from_numpy(np.array(C.ORDER_NATURAL, np.int64)).to(dev)
    nz = coeffs.view(-1, 64)[:, natural] != 0
    nz[:, 0] = True  # the DC symbol is always there and anchors the runs
    idx = torch.arange(64, device=dev)
    last = torch.cummax(torch.where(nz, idx, -1), dim=1).values
    prev = torch.cat([last[:, :1], last[:, :-1]], dim=1)
    zrl = torch.where(nz, (idx - prev - 1).clamp(min=0) // 16, 0)
    zrl[:, 0] = 0
    eob = ~nz[:, 63]
    return int(nz.sum().item() + zrl.sum().item() + eob.sum().item())


def bound(bytes_moved: int, ops: int):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def check_equal_numpy(name, got, expect) -> None:
    if len(got) != len(expect):
        raise AssertionError(f"{name}: {len(got)} planes, expected {len(expect)}")
    for i, (a, b) in enumerate(zip(got, expect)):
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{name}: plane {i} differs")


# --- phases -----------------------------------------------------------------

def phase_environment(dev: torch.device) -> str:
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    card = smi("name,power.limit")
    log(card)
    return card


def phase_build(dev: torch.device) -> None:
    built = ("jpeggpu_subseq_pass", "jpeggpu_decode_write",
             "jpeggpu_idct_stream_to_planes", "jpeggpu_emit_pass",
             "jpeggpu_supertiles", "jpeggpu_expand_supertiles",
             "jpeggpu_tiles", "jpeggpu_expand_tiles",
             "jpeggpu_dequant_idct_planes")
    for fn in built + ("jpeggpu_subseq_pass_at",):
        kernels.get(fn)
    for entry in kernels.build_log:
        for line in entry.splitlines():
            if line.startswith("---") or "registers" in line or "error" in line:
                log(f"  {line.strip()}")
    log(f"set-up: built {len(built)} kernels with nvcc, all compilers "
        f"started together, in {kernels.build_seconds:.1f} s")
    if native.get_lib() is None:
        raise AssertionError("the native host destuffer did not build: no "
                             "C++ compiler on this machine")
    log("host destuffer: native C++ (jpeggpu_tpu_torch/native/destuff.cpp)")


def leftover_streams(seed: int):
    """Streams for the records write path's leftover route: a flat gray
    image (about 3 bits per data unit, so a subsequence spans more data
    units than a supertile holds) and a random scan body behind a valid
    header."""
    flat = encode(np.full((128, 136), 130, np.uint8), EncodeSpec(quality=50))
    data = encode(synthetic_image(45, 67, seed, sigma=6.0)[..., 0],
                  EncodeSpec(restart_interval=3))
    scan = T.parse(data).scans[0]
    body = np.random.default_rng(seed + 1).integers(
        0, 255, scan.end - scan.begin, dtype=np.uint8)
    body[body == 0xFF] = 0x7F
    garbled = data[:scan.begin] + body.tobytes() + data[scan.end:]
    return [("flat_gray_q50", flat), ("garbage_body", garbled)]


def decode_tiles(data: bytes, dev: torch.device, tuning=TILES):
    """One decode through the records write path."""
    plan = pipeline.build_plan(T.parse(data), tuning=tuning)
    return pipeline.decode_jpeg_device(data, device=dev, plan=plan)


def phase_small_streams(dev: torch.device, seed: int) -> None:
    streams = small_streams(seed)
    for name, data in streams:
        check_equal_numpy(name, T.decode(data, device=dev), golden.decode(data))
        log(f"small stream {name}: decode on {dev.type} == golden")
    for name, data in streams + leftover_streams(seed):
        expect = golden.decode(data)
        check_equal_numpy(name, decode_tiles(data, dev), expect)
        log(f"small stream {name}: decode on {dev.type} through the records "
            f"write path == golden, {W.scatter_leftover.lanes} leftover "
            f"lane(s) in the last scan")
        if name == "flat_gray_q50" and not W.scatter_leftover.lanes:
            raise AssertionError("the flat image took no leftover lane")
        check_equal_numpy(name, decode_tiles(data, dev, LANE), expect)
        log(f"small stream {name}: decode on {dev.type} through the records "
            f"write path's per-lane shape == golden, "
            f"{W.scatter_leftover.lanes} leftover lane(s) in the last scan")
        if name == "flat_gray_q50" and not W.scatter_leftover.lanes:
            raise AssertionError("the flat image took no leftover lane in "
                                 "the per-lane shape")
    # geometry overrides: a supertile of 512 rows needs 128 KB of dynamic
    # shared memory in K5, a window of 3 and groups of 128 data units
    name, data = leftover_streams(seed)[0]
    wide = T.Tuning(write_mode="tiles", tile_mode="super", super_d=512,
                    super_g=2, super_w=3, group_du=128)
    check_equal_numpy(name, decode_tiles(data, dev, wide), golden.decode(data))
    log(f"small stream {name} with super_d=512, super_g=2, super_w=3, "
        f"group_du=128: == golden, {W.scatter_leftover.lanes} leftover lane(s)")
    name = "noise_q98"
    data = dict(streams)[name]
    trimmed = T.Tuning(write_mode="tiles", tile_mode="super", s_trim=128)
    check_equal_numpy(name, decode_tiles(data, dev, trimmed),
                      golden.decode(data))
    log(f"small stream {name} with s_trim=128: == golden, "
        f"{W.scatter_leftover.lanes} leftover lane(s)")
    if not W.scatter_leftover.lanes:
        raise AssertionError("s_trim=128 sent no lane to the leftover scatter")


def phase_lane_kernels_any_input(dev: torch.device, seed: int) -> None:
    """K7 and K8 against their plain versions on made-up inputs that no
    decoder emits: several records on one cell (sums that wrap), inert
    slots, excluded lanes, rows outside the tile, first data units that are
    negative or huge and not sorted, windows that leave the lanes; K8 with
    and without `reach`, which here falls anywhere: before the lane's first
    data unit, inside its tile, past it, -1, INT_MIN and INT_MAX."""
    rng = np.random.default_rng(seed)
    lanes, s_cap = 256, 96
    i32 = np.iinfo(np.int32)
    for tile_d in (32, 96, 512):
        du0 = np.sort(rng.integers(0, 4000, lanes)).astype(np.int32)
        du0[[3, 77, 200]] = [-5, i32.max, i32.min]
        wpos = (du0[None, :].astype(np.int64) * 64
                + rng.integers(-256, (tile_d + 4) * 64, (s_cap, lanes)))
        wpos[:, ::7] = wpos[:1, ::7] + rng.integers(0, 3, (s_cap, 1))
        wpos = np.where(rng.random(wpos.shape) < 0.1, -1,
                        wpos.clip(-1, i32.max)).astype(np.int32)
        args = [torch.from_numpy(a).to(dev) for a in (
            rng.integers(-32768, 32768, (s_cap, lanes)).astype(np.int16),
            wpos, rng.integers(0, s_cap + 30, lanes).astype(np.int32), du0,
            rng.random(lanes) < 0.8)]
        tiles = W.tiles_from_records(*args, tile_d)
        err7 = max_abs_err(tiles, W.tiles_from_records_plain(*args, tile_d))
        n_groups = 40
        q = rng.integers(-3, lanes // 32 + 2, n_groups).astype(np.int32)
        stuffed = torch.from_numpy(rng.integers(
            -32768, 32768, tuple(tiles.shape)).astype(np.int16)).to(dev)
        reach = (du0.astype(np.int64) + rng.integers(
            -40, tile_d + 40, lanes)).clip(i32.min, i32.max)
        reach[rng.random(lanes) < 0.1] = -1
        reach[[5, 9, 100, 150]] = [-1, i32.min, i32.max, -(1 << 30)]
        reach_t = torch.from_numpy(reach.astype(np.int32)).to(dev)
        err8 = 0
        for t in (tiles, stuffed):
            kargs = (t, args[3], torch.from_numpy(q).to(dev), n_groups)
            for r in (None, reach_t):
                err8 = max(err8, max_abs_err(W.expand_tiles(*kargs, r),
                                             W.expand_tiles_plain(*kargs, r)))
        sync(dev)
        log(f"K7 / K8 on made-up inputs, tile_d {tile_d}: max_abs_err "
            f"{err7} / {err8} against the plain versions (K8 with and "
            f"without reach)")
        if err7 or err8:
            raise AssertionError("K7 or K8 differs from its plain version "
                                 "on made-up inputs")


def made_up_scan(dev: torch.device, seed: int, kind: str, shard: bool):
    """A scan of 490 subsequences of random words in 512 lanes, cut into
    seven restart segments, with the tables of `H.made_up_tables(kind)`
    (three data units per MCU: slots (0, 1), (0, 1), (2, 3)). With `shard`
    its first segment began three lanes before lane 0, as in a subsequence
    shard: the word before the shard is staged in front of the words
    (`lead_words` 1). Returns (cfg, arrs, ctx)."""
    rng = np.random.default_rng(seed)
    lanes, n_sub, du = 512, 490, 3
    cuts = np.sort(rng.choice(np.arange(1, n_sub), 6, replace=False))
    sizes = np.diff(np.concatenate([[0], cuts, [n_sub]]))
    first = np.concatenate([[0], cuts])
    seg_of = np.full(lanes, len(sizes) - 1, np.int32)
    seg_of[:n_sub] = np.repeat(np.arange(len(sizes)), sizes)
    seg_first = first[seg_of].astype(np.int32)
    seg_nsub = sizes[seg_of].astype(np.int32)
    if shard:
        seg_first[seg_of == 0] -= 3
        seg_nsub[seg_of == 0] += 3
    words = rng.integers(0, 1 << 32, lanes * 32 + 1, dtype=np.uint32)
    maxcode, vsm, huffval, fast = H.made_up_tables(kind)
    cfg = H.ScanConfig(lanes=lanes, num_segments=len(sizes), du_per_mcu=du,
                       mcus_per_seg=2000, total_mcus=2000 * len(sizes),
                       comp_groups=((2, 0, 1), (3, 2, 3)), fast_tables=fast)
    lead = 1 if shard else 0
    words_t = torch.from_numpy(words.view(np.int32)).to(dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    arrs = H.ScanArrays(
        words=words_t[1:] if lead else words_t[:-1],
        seg_of_subseq=t(seg_of), seg_first_lane=t(seg_first),
        seg_num_subseq=t(seg_nsub), maxcode=t(maxcode), vsm=t(vsm),
        huffval=t(huffval),
        symtab=torch.tensor(convert.symbol_table(maxcode, vsm, huffval,
                                                 fast), device=dev),
        lead_words=lead)
    ctx = H.make_ctx(cfg, arrs, num_subseq=n_sub if shard else None)
    return cfg, arrs, ctx


def gated_records(rec: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """K4's records with the slots at and past m[lane] set to the inert
    record: the kernel leaves them unwritten, the plain version fills
    them."""
    slot = torch.arange(rec.shape[0], dtype=torch.int32,
                        device=rec.device)[:, None]
    return torch.where(slot < m[None, :], rec, H._REC_INERT)


def k4_error(got, ref) -> int:
    """max_abs_err of K4's (rec, m) against its plain version's: m, and the
    records slot by slot up to m."""
    return max(max_abs_err(got[1], ref[1]),
               max_abs_err(gated_records(*got), ref[0]))


def gathered_inputs(cfg, ctx, rng, width: int):
    """Made-up inputs of K1's gathered mode at `width` columns: lane 0,
    the last lane, every segment first and the lanes beside it (as many
    as fit), then lanes drawn at random (repeated where the width passes
    the lanes), sorted; starts anywhere in the lane's subsequence from 31
    bits before it (never before its segment) to past its end, or anywhere
    in the next two, as a predecessor's state can be; data units and
    zig-zag indices at random; a fifth of the columns inactive."""
    lanes = cfg.lanes
    firsts = np.flatnonzero(ctx.first_of_seg.cpu().numpy())
    special = np.unique(np.clip(np.concatenate(
        [[0, lanes - 1], firsts, firsts - 1, firsts + 1]), 0, lanes - 1))
    idx = rng.integers(0, lanes, width)
    idx[:min(width, special.size)] = special[:width]
    idx = np.sort(idx).astype(np.int32)
    rel = ctx.rel.cpu().numpy()[idx].astype(np.int64)
    near = np.maximum(rel * 1024 + rng.integers(-31, 1024 + 40, width), 0)
    far = (rel + 1) * 1024 - 31 + rng.integers(0, 2048, width)
    sp = np.where(rng.random(width) < 0.2, far, near).astype(np.int32)
    sc = rng.integers(0, cfg.du_per_mcu, width).astype(np.int32)
    sz = rng.integers(0, 64, width).astype(np.int32)
    active = rng.random(width) >= 0.2
    dev = ctx.rel.device
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (idx, sp, sc, sz, active))


def gathered_any_input(cfg, arrs, ctx, rng):
    """K1's gathered mode against its plain version on made-up inputs at
    the widths of the 12 MP image's tiers (32, 80, 5120): the largest
    error and the widths."""
    err, widths = 0, (32, 80, 5120)
    for width in widths:
        args = gathered_inputs(cfg, ctx, rng, width)
        got = H.subseq_pass_at(cfg, arrs, ctx, *args)
        ref = H.subseq_pass_at_plain(cfg, arrs, ctx, *args)
        err = max(err, max(max_abs_err(a, b) for a, b in zip(got, ref)))
    return err, widths


def phase_entropy_kernels_any_input(dev: torch.device, seed: int) -> None:
    """K1, K2 and K4 against their plain versions on made-up inputs that no
    real stream has: random words, random previous-round states (some past
    their lane's end, some anywhere in the next two subsequences), random
    data units and zig-zag indices, a random entry state, and the tables of
    `H.made_up_tables` (saturated; garbage categories and long codes, whose
    symbols escape the symbol table or take the reader's seek). K1: the
    blind round, two rounds from random states and one from converged
    states, states and flags; the whole sync_states against its plain
    version on CPU copies. K2 and K4: from the random states, with the
    offsets of the round that decoded from them (so that no two lanes write
    one cell), and K4 again from the converged states. K1's gathered mode
    (`gathered_any_input`) at the widths of the compacted tiers."""
    rng = np.random.default_rng(seed + 5)
    cpu = torch.device("cpu")
    for kind in ("saturated", "garbage"):
        for shard in (False, True):
            cfg, arrs, ctx = made_up_scan(dev, seed, kind, shard)
            valid = ctx.lane_valid
            entry = None
            if shard:
                entry = torch.tensor([3 * 1024 - int(rng.integers(0, 32)),
                                      int(rng.integers(0, 3)),
                                      int(rng.integers(0, 64))],
                                     dtype=torch.int32, device=dev)
            errs = []

            def k1_round(prev):
                """One round against its plain version; the blind round
                (no previous states) has no flag and no entry."""
                flag = torch.zeros(1, dtype=torch.int32, device=dev)
                ref_flag = torch.zeros_like(flag)
                kw = {}
                if prev[0] is not None:
                    kw = dict(entry=entry, flag=flag)
                got = H.subseq_pass(cfg, arrs, ctx, *prev, valid, **kw)
                if kw:
                    kw["flag"] = ref_flag
                ref = H.subseq_pass_plain(cfg, arrs, ctx, *prev, valid, **kw)
                errs.append(max(max_abs_err(a, b) for a, b in zip(got, ref)))
                errs.append(max_abs_err(flag, ref_flag))
                return ref, int(ref_flag)

            k1_round((None, None, None))
            rel = ctx.rel.to(torch.int64)
            flags = []
            for r in range(2):
                near = (rel + 1) * 1024 + torch.from_numpy(
                    rng.integers(-31, 40, cfg.lanes)).to(dev)
                far = (rel + 1) * 1024 - 31 + torch.from_numpy(
                    rng.integers(0, 2048, cfg.lanes)).to(dev)
                pick = torch.from_numpy(rng.random(cfg.lanes) < 0.2).to(dev)
                prev = (torch.where(pick, far, near).to(torch.int32),
                        torch.from_numpy(rng.integers(
                            0, cfg.du_per_mcu, cfg.lanes).astype(np.int32)
                        ).to(dev),
                        torch.from_numpy(rng.integers(
                            0, 64, cfg.lanes).astype(np.int32)).to(dev))
                (p, c, z, n), flag = k1_round(prev)
                flags.append(flag)
            # K2 from the last random states, with the offsets of the
            # round that decoded from the same starts
            n_off = H.symbol_offsets(cfg, arrs, n)
            got = H.decode_write(cfg, arrs, ctx, *prev, n_off, entry=entry)
            ref = H.decode_write_plain(cfg, arrs, ctx, *prev, n_off,
                                       entry=entry)
            errs.append(max_abs_err(got, ref))
            written = int((got != 0).sum())
            errs.append(k4_error(
                H.decode_write_emit(cfg, arrs, ctx, *prev, n_off,
                                    entry=entry),
                H.decode_write_emit_plain(cfg, arrs, ctx, *prev, n_off,
                                          entry=entry)))
            # the whole loop (its plain version on the same scan made on
            # the CPU), and one more round from its fixed point
            states = H.sync_states(cfg, arrs, ctx, entry=entry)
            _, cpu_arrs, cpu_ctx = made_up_scan(cpu, seed, kind, shard)
            ref_states = H.sync_states(
                cfg, cpu_arrs, cpu_ctx,
                entry=None if entry is None else entry.cpu())
            errs.append(max(max_abs_err(a.cpu(), b)
                            for a, b in zip(states, ref_states)))
            _, converged = k1_round(states[:3])
            n_off = H.symbol_offsets(cfg, arrs, states[3])
            got = H.decode_write_emit(cfg, arrs, ctx, *states[:3], n_off,
                                      entry=entry)
            errs.append(k4_error(got, H.decode_write_emit_plain(
                cfg, arrs, ctx, *states[:3], n_off, entry=entry)))
            gerr, gwidths = gathered_any_input(cfg, arrs, ctx, rng)
            errs.append(gerr)
            sync(dev)
            log(f"K1's gathered mode on made-up inputs ({kind} tables, "
                f"{'shard' if shard else 'scan'}): widths {gwidths}, "
                f"max_abs_err {gerr} against its plain version")
            log(f"K1 / K2 / K4 on made-up inputs ({kind} tables, fast_tables "
                f"{cfg.fast_tables}, {'shard with entry' if shard else 'scan'}"
                f"): max_abs_err {max(errs)} against the plain versions; "
                f"flags {flags} from random states, {converged} from the "
                f"fixed point; K2 wrote {written} coefficients, K4 emitted "
                f"{int(got[1].sum())} records from the fixed point")
            if max(errs) or converged:
                raise AssertionError("K1, K2 or K4 differs from its plain "
                                     "version on made-up inputs")


def phase_kernels(dev: torch.device, data: bytes, card: str):
    """Each kernel against its plain version at the main path's shapes;
    returns the kernel entries (without launch counts)."""
    plan = pipeline.build_plan(T.parse(data))
    staged = pipeline.stage_inputs(pipeline.build_inputs(data, plan), plan,
                                   dev)
    sp, = plan.signature.scans
    cfg, arrs, qtables = sp.cfg, staged["scans"][0], staged["qtables"]
    ctx = H.make_ctx(cfg, arrs)
    lanes = cfg.lanes
    scan, = plan.stream.scans
    buf = np.frombuffer(data, np.uint8)
    if not native.destuff_words(buf[scan.begin:scan.end], scan.segments[:, 0],
                                scan.num_subsequences, scan.seg_raw,
                                np.empty(lanes * 32, np.uint32)):
        raise AssertionError("the native destuffer refused the 12 MP stream")
    log(f"event pair around nothing, as the cold timing brackets a launch: "
        f"{time_cold_ms(lambda: None, dev):.4f} ms")
    log(f"12 MP shapes: lanes {lanes} ({int(ctx.lane_valid.sum())} valid), "
        f"{cfg.num_segments} segments, {cfg.total_mcus * cfg.du_per_mcu} data "
        f"units, {cfg.total_positions * 2 / 1e6:.1f} MB of coefficients")
    entries = []
    tables = (arrs.maxcode, arrs.vsm, ctx.limits, arrs.huffval, ctx.slots)
    named = {s for g in cfg.comp_groups for s in g[1:]}
    # what a block of K1 or K2 reads of the symbol table: its named slots
    symtab_bytes = 2 * len(named) << H.SYMTAB_BITS

    # K1, the blind round then a shifted round, states and flag
    valid = ctx.lane_valid
    blind = H.subseq_pass(cfg, arrs, ctx, None, None, None, valid)
    rounds = {"blind": (None, None, None), "shifted": blind[:3]}
    k1 = {}
    for which, prev in rounds.items():
        flag = None if which == "blind" else torch.zeros(
            1, dtype=torch.int32, device=dev)
        got = H.subseq_pass(cfg, arrs, ctx, *prev, valid, flag=flag)
        ref_flag = None if flag is None else torch.zeros_like(flag)
        t0 = time.perf_counter()
        ref = H.subseq_pass_plain(cfg, arrs, ctx, *prev, valid, flag=ref_flag)
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_abs_err(a, b) for a, b in zip(got, ref))
        if flag is not None:
            err = max(err, max_abs_err(flag, ref_flag))
            log(f"K1 shifted round: flag {int(flag)}, plain {int(ref_flag)}")

        def launch():
            return H.subseq_pass(cfg, arrs, ctx, *prev, valid, flag=flag)

        ms, call_ms = time_ms(launch, dev)
        cold_ms = time_cold_ms(launch, dev)
        k1[which] = (err, ms, plain_ms, call_ms, cold_ms)
        log(f"K1 subseq_pass {which} round (the whole round): max_abs_err "
            f"{err}, {ms:.4f} ms on the device with L2 warm, {cold_ms:.4f} ms "
            f"cold ({call_ms:.4f} ms a single call), plain {plain_ms:.1f} ms  "
            f"[{card}]")
        if err:
            raise AssertionError(f"K1 differs from its plain version ({which})")

    # converged states, then K2 on the whole stream
    p, c, z, n = H.sync_states(cfg, arrs, ctx)
    n_off = H.symbol_offsets(cfg, arrs, n)
    coeffs = H.decode_write(cfg, arrs, ctx, p, c, z, n_off)
    t0 = time.perf_counter()
    ref = H.decode_write_plain(cfg, arrs, ctx, p, c, z, n_off)
    sync(dev)
    k2_plain = (time.perf_counter() - t0) * 1e3
    k2_err = max_abs_err(coeffs, ref)
    def launch_k2():
        return H.decode_write(cfg, arrs, ctx, p, c, z, n_off)

    k2_warm, k2_call = time_ms(launch_k2, dev)
    k2_cold = time_cold_ms(launch_k2, dev)
    symbols = count_symbols(coeffs)
    log(f"K2 decode_write (zero fill + kernel): max_abs_err {k2_err}, "
        f"{k2_warm:.4f} ms on the device with L2 warm, {k2_cold:.4f} ms cold "
        f"({k2_call:.4f} ms a single call), plain {k2_plain:.1f} ms, "
        f"{symbols} symbols  [{card}]")
    if k2_err:
        raise AssertionError("K2 differs from its plain version")

    # per lane: word_end, seg_base_bits, end_subseq, valid and three states
    # (K1: of the previous round, and rel; K2, K4: the start states); K1
    # writes four states and the flag
    lane_in = (nbytes(ctx.word_end, ctx.seg_base_bits, ctx.end_subseq, valid)
               + 3 * 4 * lanes)
    k1_bytes = (nbytes(arrs.words, *tables, ctx.rel) + symtab_bytes + lane_in
                + 4 * 4 * lanes + 4)
    b_ms, b_by = bound(k1_bytes, symbols * K1_OPS_PER_SYMBOL)
    entries.append(dict(
        name="subseq_pass", route="cuda",
        source="jpeggpu_tpu_torch/kernels/csrc/subseq_pass.cu",
        replaces="jpeggpu_tpu/ops/huffman_pallas.py:213",
        max_abs_err=max(v[0] for v in k1.values()), ms=k1["shifted"][1],
        plain_ms=k1["shifted"][2], bound_ms=b_ms, bound_by=b_by,
        library_ms=None, call_ms=k1["shifted"][3],
        ms_warm_l2=k1["shifted"][1], ms_cold_l2=k1["shifted"][4],
        ms_blind_round=k1["blind"][1], plain_ms_blind_round=k1["blind"][2],
        symbols=symbols))
    k2_bytes = (nbytes(arrs.words, *tables, ctx.natural) + symtab_bytes
                + lane_in + 2 * 4 * lanes + nbytes(coeffs))
    b_ms, b_by = bound(k2_bytes, symbols * K2_OPS_PER_SYMBOL)
    entries.append(dict(
        name="decode_write", route="cuda",
        source="jpeggpu_tpu_torch/kernels/csrc/decode_write.cu",
        replaces="jpeggpu_tpu/ops/huffman_pallas.py:539", max_abs_err=k2_err,
        ms=k2_cold, plain_ms=k2_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, call_ms=k2_call, ms_warm_l2=k2_warm,
        ms_cold_l2=k2_cold, symbols=symbols))

    # K3: one launch for all the scan's components, then each alone
    comp_slots = tuple((k[1], k[2] * k[3]) for k in sp.comps)
    dcv = DC.undelta_dc_values(cfg, comp_slots, coeffs)
    k3_args = (coeffs, qtables, sp.idct_geometry, cfg.du_per_mcu, dcv)
    n_runs = I.stream_runs(sp.num_mcus_x, sp.num_mcus_y, cfg.du_per_mcu)[2]
    planes, timing = measure(
        dev, card, f"K3 idct_stream_to_planes, {len(sp.comps)} components "
        f"in one launch ({n_runs} runs)",
        lambda: I.idct_stream_to_planes(*k3_args),
        lambda: I.idct_stream_to_planes_plain(*k3_args),
        lambda got, ref: max(max_abs_err(a, b) for a, b in zip(got, ref)))
    pixels = sum(pl.numel() for pl in planes)
    b_ms, b_by = bound(pixels * 2 + pixels // 64 * 2 + 64 * 4 * len(planes)
                       + pixels, pixels * K3_OPS_PER_PIXEL)
    log(f"  K3: {pixels * 2 / 1e6:.2f} MB in, {pixels / 1e6:.2f} MB out, "
        f"bound {b_ms:.4f} ms by {b_by}, "
        f"{pixels * K3_OPS_PER_PIXEL / INT_OPS_PER_S * 1e3:.4f} ms by "
        f"operations  [{card}]")
    entries.append(dict(
        name="idct_stream_to_planes", route="cuda",
        source="jpeggpu_tpu_torch/kernels/csrc/idct_stream.cu",
        replaces="jpeggpu_tpu/ops/idct_pallas.py:185", bound_ms=b_ms,
        bound_by=b_by, components=len(planes), **timing))
    for comp in sp.comps:
        args = (coeffs, qtables[comp[6]], sp.num_mcus_x, sp.num_mcus_y,
                cfg.du_per_mcu, comp[1], comp[2], comp[3], dcv)
        got = I.idct_stream_to_plane(*args)
        t0 = time.perf_counter()
        ref = I.idct_stream_to_plane_plain(*args)
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, ref)
        warm_ms, call_ms = time_ms(lambda: I.idct_stream_to_plane(*args), dev)
        cold_ms = time_cold_ms(lambda: I.idct_stream_to_plane(*args), dev)
        pixels = got.numel()
        b_ms, b_by = bound(pixels * 2 + pixels // 64 * 2 + 64 * 4 + pixels,
                           pixels * K3_OPS_PER_PIXEL)
        log(f"K3 idct_stream_to_plane (one component alone) {comp[0]} "
            f"{tuple(got.shape)}: max_abs_err {err}, {warm_ms:.4f} ms on the "
            f"device with L2 warm, {cold_ms:.4f} ms cold ({call_ms:.4f} ms a "
            f"single call), plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms  "
            f"[{card}]")
        if err:
            raise AssertionError(
                f"K3 differs from its plain version (component {comp[0]})")
        entries.append(dict(
            name=f"idct_stream_to_plane/component{comp[0]}", route="cuda",
            source="jpeggpu_tpu_torch/kernels/csrc/idct_stream.cu",
            replaces="jpeggpu_tpu/ops/idct_pallas.py:185", max_abs_err=err,
            ms=cold_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, call_ms=call_ms, ms_warm_l2=warm_ms,
            ms_cold_l2=cold_ms, slot=comp[1]))

    entries += records_path_kernels(dev, card, plan, arrs, ctx,
                                    (p, c, z, n_off), coeffs, symbols,
                                    nbytes(arrs.words, *tables) + lane_in)
    return entries


def host_ms(fn, dev: torch.device, reps: int = 7):
    """Median host-clock time of `fn` ending in a synchronise, in ms, and
    its last result: for stages that read from the device themselves and
    so cannot be queued behind a spinning kernel."""
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def measure(dev, card, label, launch, plain, compare):
    """One kernel against its plain version on the same tensors, then its
    times: returns the kernel's result and its entry's measured keys."""
    got = launch()
    t0 = time.perf_counter()
    ref = plain()
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare(got, ref)
    del ref
    warm_ms, call_ms = time_ms(launch, dev)
    cold_ms = time_cold_ms(launch, dev)
    log(f"{label}: max_abs_err {err}, {warm_ms:.4f} ms on the device "
        f"with L2 warm, {cold_ms:.4f} ms cold ({call_ms:.4f} ms a single "
        f"call), plain {plain_ms:.1f} ms  [{card}]")
    if err:
        raise AssertionError(f"{label} differs from its plain version")
    return got, dict(max_abs_err=err, ms=cold_ms, plain_ms=plain_ms,
                     library_ms=None, call_ms=call_ms, ms_warm_l2=warm_ms,
                     ms_cold_l2=cold_ms)


def records_path_kernels(dev, card, plan, arrs, ctx, states, coeffs, symbols,
                         decode_in_bytes):
    """K4, K5 and K6 at the 12 MP shapes, each fed by the real stage before
    it and held against its plain version; then the whole records write
    stage against K2's stream."""
    tcfg = pipeline.build_plan(plan.stream, tuning=TILES).signature.scans[0].cfg
    lanes, G, super_d = tcfg.lanes, tcfg.super_g, tcfg.super_d
    entries = []

    # K4, compared gated (gated_records)
    (rec, m), timing = measure(
        dev, card, "K4 decode_write_emit",
        lambda: H.decode_write_emit(tcfg, arrs, ctx, *states),
        lambda: H.decode_write_emit_plain(tcfg, arrs, ctx, *states),
        k4_error)
    records = int(m.sum())
    log(f"K4 emitted {records} records ({symbols} symbols counted from the "
        f"stream), at most {int(m.max())} in a lane, buffer {tuple(rec.shape)} "
        f"= {nbytes(rec) / 1e6:.1f} MB left unfilled past each lane's count")
    b_ms, b_by = bound(decode_in_bytes + 2 * 4 * lanes + 4 * records
                       + nbytes(m), records * K4_OPS_PER_SYMBOL)
    entries.append(dict(
        name="decode_write_emit", route="cuda",
        source="jpeggpu_tpu_torch/kernels/csrc/emit_pass.cu",
        replaces="jpeggpu_tpu/ops/huffman_pallas.py:374", bound_ms=b_ms,
        bound_by=b_by, records=records, **timing))

    # K5, from the preparation of K4's records
    pos0 = arrs.seg_of_subseq * tcfg.positions_per_seg + states[3]
    prep_ms, prep = host_ms(lambda: W.supertile_records(
        rec, m, pos0 >> 6, pos0, tcfg.total_positions, G, tcfg.super_w,
        tcfg.tuning.s_trim, tcfg.group_du, super_d), dev)
    val_rows, pk_rows, mmax_st, base, q, leftover, n_groups, win = prep
    n_st = val_rows.shape[0]
    log(f"records path geometry: super_g {G}, super_d {super_d}, group_du "
        f"{tcfg.group_du}, super_w {tcfg.super_w} (used {win}), s_trim "
        f"{tcfg.tuning.s_trim}, {n_st} supertiles, {n_groups} groups, "
        f"{int(leftover.sum())} leftover lane(s); preparation "
        f"{prep_ms:.3f} ms on the host clock  [{card}]")
    stiles, timing = measure(
        dev, card, "K5 supertiles_from_records",
        lambda: W.supertiles_from_records(val_rows, pk_rows, mmax_st, G,
                                          super_d),
        lambda: W.supertiles_from_records_plain(val_rows, pk_rows, mmax_st,
                                                G, super_d),
        max_abs_err)
    placed = int((pk_rows >= 0).sum())
    read_cols = int(mmax_st.sum()) * G
    b_ms, b_by = bound(2 * 2 * read_cols + nbytes(mmax_st) + 64 * 4
                       + nbytes(stiles),
                       placed * K5_OPS_PER_RECORD
                       + stiles.numel() * K5_OPS_PER_CELL)
    entries.append(dict(
        name="supertiles_from_records", route="cuda",
        source="jpeggpu_tpu_torch/kernels/csrc/supertiles.cu",
        replaces="jpeggpu_tpu/ops/write_pallas.py:345", bound_ms=b_ms,
        bound_by=b_by, records=placed, **timing))

    # K6, from K5's supertiles
    (rows, dcd), timing = measure(
        dev, card, "K6 expand_supertiles",
        lambda: W.expand_supertiles(stiles, base, q, n_groups, win,
                                    tcfg.group_du),
        lambda: W.expand_supertiles_plain(stiles, base, q, n_groups, win,
                                          tcfg.group_du),
        lambda got, ref: max(max_abs_err(got[0], ref[0]),
                             max_abs_err(got[1], ref[1])))
    b_ms, b_by = bound(nbytes(stiles, base, q, rows, dcd),
                       rows.numel() * K6_OPS_PER_CELL)
    entries.append(dict(
        name="expand_supertiles", route="cuda",
        source="jpeggpu_tpu_torch/kernels/csrc/expand_supertiles.cu",
        replaces="jpeggpu_tpu/ops/write_pallas.py:466", bound_ms=b_ms,
        bound_by=b_by, **timing))
    for e in entries:
        log(f"  {e['name']}: bound {e['bound_ms']:.4f} ms by {e['bound_by']}")

    # the whole records write stage against the direct write
    tiles_ms, (tcoeffs, tdc) = host_ms(lambda: W.decode_write_tiles(
        tcfg, arrs, ctx, *states, return_dc=True), dev)
    fused_ms, _ = host_ms(lambda: H.decode_write(tcfg, arrs, ctx, *states),
                          dev)
    total_du = tcfg.total_positions // 64
    err = max(max_abs_err(tcoeffs, coeffs),
              max_abs_err(tdc[:total_du], coeffs[::64].contiguous()))
    log(f"records write stage (K4 + preparation + K5 + K6 + leftover, "
        f"{W.scatter_leftover.lanes} leftover lane(s)): max_abs_err {err} "
        f"against K2's stream and its DC column, {tiles_ms:.3f} ms on the "
        f"host clock against {fused_ms:.3f} ms for decode_write  [{card}]")
    if err:
        raise AssertionError("the records write stage differs from K2")
    # the leftover scatter at this size: a trim below the lanes' counts
    trim_cfg = pipeline.build_plan(plan.stream, tuning=T.Tuning(
        write_mode="tiles", tile_mode="super",
        s_trim=128)).signature.scans[0].cfg
    trim_ms, (tcoeffs, tdc) = host_ms(lambda: W.decode_write_tiles(
        trim_cfg, arrs, ctx, *states, return_dc=True), dev)
    err = max(max_abs_err(tcoeffs, coeffs),
              max_abs_err(tdc[:total_du], coeffs[::64].contiguous()))
    log(f"records write stage with s_trim=128: {W.scatter_leftover.lanes} "
        f"leftover lane(s) of {lanes}, max_abs_err {err} against K2's "
        f"stream, {trim_ms:.3f} ms on the host clock  [{card}]")
    if err or not W.scatter_leftover.lanes:
        raise AssertionError("the leftover scatter differs from K2, or "
                             "took no lane")
    return entries


WRAPPERS = (H.subseq_pass, H.decode_write, I.idct_stream_to_planes,
            H.decode_write_emit, W.supertiles_from_records,
            W.expand_supertiles, W.tiles_from_records, W.expand_tiles,
            I.dequant_idct_planes, H.subseq_pass_at)
# the records path's wrappers -> their kernels' names in a profile
RECORDS_KERNEL_SYMBOLS = {
    "decode_write_emit": "::emit_pass_kernel",
    "supertiles_from_records": "::supertiles_kernel",
    "expand_supertiles": "::expand_supertiles_kernel",
    "tiles_from_records": "::tiles_kernel",
    "expand_tiles": "::expand_tiles_kernel",
}
SUPER_KERNELS = ("supertiles_from_records", "expand_supertiles")
LANE_KERNELS = ("tiles_from_records", "expand_tiles")
SHARDED_KERNELS = ("dequant_idct_planes",)
# K1's gathered mode: the compacted sync tiers, only under a plan whose
# tuning names them (phase_sync_tiers)
TIER_KERNELS = ("subseq_pass_at",)


def counted(fn):
    """Run `fn` with every wrapper's launch count set to 0 just before and
    read just after; returns (result, counts by wrapper, the components K3's
    launches covered, by slot)."""
    for w in WRAPPERS:
        w.launches = 0
    I.idct_stream_to_planes.images = 0
    I.idct_stream_to_planes.launches_by_slot.clear()
    out = fn()
    return (out, {w.__name__: w.launches for w in WRAPPERS},
            dict(I.idct_stream_to_planes.launches_by_slot))


def k3_once(launches, by_slot, n_comps: int) -> bool:
    """K3 launched once (the scan's one launch) and covered each of the
    image's `n_comps` components once."""
    return (launches["idct_stream_to_planes"] == 1 and len(by_slot) == n_comps
            and all(v == 1 for v in by_slot.values()))


def end_to_end(dev, data, card, label, one_shot, mp):
    """ms and MP/s of `one_shot()` (host staging included, median of 5) and
    of a Decoder's decode from staged inputs with the planes left on the
    device (median of 9). The Decoder plans under the process default
    tuning."""
    full = []
    for _ in range(5):
        t0 = time.perf_counter()
        one_shot()
        full.append((time.perf_counter() - t0) * 1e3)
    with T.Decoder(device=dev) as d:
        d.parse_header(data)
        log(f"{label}: get_buffer_size {d.get_buffer_size() / 1e6:.1f} MB")
        d.transfer()
        sync(dev)

        def run():
            d.decode(device=True)
            sync(dev)

        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        run()
        log(f"{label}: peak device memory of a decode "
            f"{(torch.cuda.max_memory_allocated(dev) - held) / 1e6:.1f} MB "
            f"above the staged inputs' {held / 1e6:.1f} MB")
        staged = []
        for _ in range(9):
            t0 = time.perf_counter()
            run()
            staged.append((time.perf_counter() - t0) * 1e3)
    e2e, dev_only = statistics.median(full), statistics.median(staged)
    log(f"{label}: end to end with host staging (parse, destuff, copy in, "
        f"decode, copy out): {e2e:.2f} ms = {mp / e2e * 1e3:.0f} MP/s  "
        f"[{card}]")
    log(f"{label}: end to end without host staging (staged inputs, planes "
        f"left on the device): {dev_only:.2f} ms = "
        f"{mp / dev_only * 1e3:.0f} MP/s  [{card}]")
    return dev_only


def phase_main_path(dev: torch.device, data: bytes, card: str):
    """The main path with the launch counts read around it, its output
    against the plain path, and the end-to-end times."""
    planes, launches, by_slot = counted(lambda: T.decode(data, device=dev))
    plan = pipeline.build_plan(T.parse(data))
    sp, = plan.signature.scans
    arrs = pipeline.stage_inputs(pipeline.build_inputs(data, plan), plan,
                                 dev)["scans"][0]
    _, rounds, _ = counted(lambda: H.sync_states(
        sp.cfg, arrs, H.make_ctx(sp.cfg, arrs)))
    rounds = rounds["subseq_pass"]
    log(f"main path launches: {launches}, components K3 covered by first "
        f"slot: {by_slot}; sync_states alone on the same "
        f"image: {rounds} rounds (the blind one included), one K1 launch "
        f"each")
    n_comps = len(T.parse(data).components)
    records_kernels = ("decode_write_emit",) + SUPER_KERNELS
    if not (launches["subseq_pass"] == rounds >= 2
            and launches["decode_write"] == 1
            and k3_once(launches, by_slot, n_comps)
            and not any(launches[k] for k in records_kernels + LANE_KERNELS
                        + SHARDED_KERNELS + TIER_KERNELS)):
        raise AssertionError(f"the default path must launch K1 once per "
                             f"sync round, K2 once and K3 once for all "
                             f"components, and no other kernel: {launches} "
                             f"{by_slot}")

    t0 = time.perf_counter()
    plain = T.decode(data, device="cpu")
    log(f"plain path (CPU tensors) decoded in {time.perf_counter() - t0:.1f} s")
    check_equal_numpy("12 MP decode vs plain path", planes, plain)
    stream = T.parse(data)
    for pl, comp in zip(planes, stream.components):
        if pl.shape != (comp.size_y, comp.size_x) or pl.dtype != np.uint8:
            raise AssertionError("plane of unexpected shape or type")
    log("12 MP decode on the device == plain path, planes "
        + ", ".join(str(pl.shape) for pl in planes))

    mp = stream.size_x * stream.size_y / 1e6
    dev_only = end_to_end(dev, data, card, "default path",
                          lambda: T.decode(data, device=dev), mp)

    # the records write path, through the same entry points
    tplanes, tlaunches, tby_slot = counted(lambda: decode_tiles(data, dev))
    log(f"records path launches: {tlaunches}, components K3 covered by "
        f"first slot: {tby_slot}; {W.scatter_leftover.lanes} leftover "
        f"lane(s)")
    if not (tlaunches["subseq_pass"] >= 2 and tlaunches["decode_write"] == 0
            and all(tlaunches[k] == 1 for k in records_kernels)
            and not any(tlaunches[k] for k in LANE_KERNELS + SHARDED_KERNELS
                        + TIER_KERNELS)
            and k3_once(tlaunches, tby_slot, n_comps)):
        raise AssertionError(f"the records path must launch K1, K4, K5, K6 "
                             f"and K3 once, and not K2, K7 or K8: {tlaunches} "
                             f"{tby_slot}")
    check_equal_numpy("12 MP records path vs default path", tplanes, planes)
    log("12 MP decode through the records write path == default path == "
        "plain path")
    base_tuning = T.default_tuning()
    T.set_default_tuning(TILES)
    try:
        dplanes, dlaunches, _ = counted(lambda: T.decode(data, device=dev))
        if dlaunches != tlaunches:
            raise AssertionError(f"a Decoder under set_default_tuning took "
                                 f"another path: {dlaunches}")
        check_equal_numpy("12 MP Decoder under the default tuning", dplanes,
                          planes)
        log("Decoder under set_default_tuning(write_mode='tiles'): the same "
            "launches and planes")
        tiles_dev_only = end_to_end(dev, data, card, "records path",
                                    lambda: T.decode(data, device=dev), mp)
    finally:
        T.set_default_tuning(base_tuning)
    return launches, by_slot, tlaunches, tby_slot, dev_only, tiles_dev_only


def profile_decode(dev, card, label, run, decode_ms, own) -> None:
    """The device's busy and idle share of one decode (`run`), from the
    profiler's kernel times against `decode_ms`, the time of a decode from
    staged inputs without the profiler; and the time of each launch of the
    kernels named in `own`, which it returns by name."""
    events = profiled(dev, run)
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.self_device_time_total / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    log(f"{label}: device busy {busy_ms:.3f} ms (kernel times from the "
        f"profiler) of a {decode_ms:.2f} ms decode from staged inputs: idle "
        f"share {1 - busy_ms / decode_ms:.2f}  [{card}]")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms:.4f} ms x{n}  {name[:70]}")
    times = {}
    for name in own:
        each = [e.self_device_time_total / 1e3 for e in events
                if name in e.name]
        log(f"  inside the decode, {name.lstrip(':')} per launch, ms: "
            + " ".join(f"{t:.4f}" for t in each) + f"  [{card}]")
        times[name] = each
    return times


def phase_where_time_goes(dev: torch.device, data: bytes, card: str,
                          decode_ms: float, tiles_decode_ms: float):
    """Each path's device busy and idle share, the sync loop's device
    work, and K1's and K2's cycles per symbol of the longest lane, after
    one parse whose every scan must take the native segment walk. Returns
    {kernel: (ms in the decode, cycles per symbol)} for K1 and K2, K3's
    per-launch times inside the default path's decode, and the records
    path's per-launch times of its kernels inside the decode by kernel
    symbol."""
    walks, parses = dict(reader.walks), dict(reader.parses)
    stream = T.parse(data)
    took = {k: reader.walks[k] - walks[k] for k in walks}
    if took != {"native": len(stream.scans), "numpy": 0}:
        raise AssertionError(f"the 12 MP parse took the walks {took}, not "
                             "the native one on every scan")
    took = {k: reader.parses[k] - parses[k] for k in parses}
    if took != {"native": 1, "python": 0}:
        raise AssertionError(f"the 12 MP parse took the parsers {took}, not "
                             "the native header pass")
    plan = pipeline.build_plan(stream)
    staged = pipeline.stage_inputs(pipeline.build_inputs(data, plan), plan,
                                   dev)
    sp, = plan.signature.scans
    cfg, arrs, qtables = sp.cfg, staged["scans"][0], staged["qtables"]
    ctx = H.make_ctx(cfg, arrs)
    p, c, z, n = H.sync_states(cfg, arrs, ctx)
    n_off = H.symbol_offsets(cfg, arrs, n)
    # the records path's plan; its K4 records give the longest lane
    tplan = pipeline.build_plan(stream, tuning=TILES)
    tcfg = tplan.signature.scans[0].cfg
    _, m = H.decode_write_emit(tcfg, arrs, ctx, p, c, z, n_off)

    times = profile_decode(
        dev, card, "default path",
        lambda: pipeline.decode_pipeline(plan.signature, staged["scans"],
                                         qtables),
        decode_ms, ("::subseq_pass_kernel", "::decode_write_kernel",
                    "::idct_stream_to_planes_kernel"))
    sm_mhz = busy_sm_clock(dev, lambda: pipeline.decode_pipeline(
        plan.signature, staged["scans"], qtables))
    clocks = f"{sm_mhz:.0f} MHz sampled during decodes, {smi('clocks.max.sm')} max"
    longest = int(m.max())  # symbols of the longest lane (K4's records)
    per_symbol = {}
    for name in ("::subseq_pass_kernel", "::decode_write_kernel"):
        ms = statistics.median(times.get(name) or [float("nan")])
        per_symbol[name] = (ms, ms * 1e-3 * sm_mhz * 1e6 / longest)
        log(f"{name.lstrip(':')} in the decode: {ms:.4f} ms (median of "
            f"{len(times.get(name, []))}) x {sm_mhz:.0f} MHz (clocks.sm: "
            f"{clocks}) / {longest} symbols of the longest lane = "
            f"{per_symbol[name][1]:.0f} cycles per symbol  [{card}]")
    sync_window(dev, card, cfg, arrs, ctx)
    total, *longer, seeks = symbol_escapes(cfg, arrs, ctx, (p, c, z, n_off))
    log(f"symbols: {total}; codes longer than 8 / 9 / 10 / 11 bits: "
        + " / ".join(f"{k} ({k / total:.2%})" for k in longer)
        + f"; symbols of 32 bits or more: {seeks}. A warp meets an escape of "
        f"the {H.SYMTAB_BITS}-bit table in about "
        f"{1 - (1 - longer[2] / total) ** 32:.0%} of its iterations")
    records_times = profile_decode(
        dev, card, "records path",
        lambda: pipeline.decode_pipeline(tplan.signature, staged["scans"],
                                         qtables),
        tiles_decode_ms, ("::subseq_pass_kernel", "::emit_pass_kernel",
                          "::supertiles_kernel", "::expand_supertiles_kernel",
                          "::idct_stream_to_planes_kernel"))
    return (per_symbol, times.get("::idct_stream_to_planes_kernel", []),
            records_times)


def symbol_escapes(cfg, arrs, ctx, states):
    """The scan's symbols and, of them, those whose code is longer than 8,
    9, 10 (the symbol table's width, SYMTAB_BITS) and 11 bits, and those of
    32 bits or more: the writing decode's walk (`decode_write_plain`'s, from
    the synced states (p, c, z, n_off), to each segment's position bound)
    without its stores, on whatever device holds the tensors."""
    sp, sc, sz, pos0, _, active, _, bound = H._write_inputs(cfg, arrs, ctx,
                                                            *states)
    t = H._plain_operands(arrs, ctx)
    p, c, z = (x.to(torch.int64) for x in (sp, sc, sz))
    pos, bound = pos0.to(torch.int64), bound.to(torch.int64)
    counts = torch.zeros(6, dtype=torch.int64, device=p.device)
    while True:
        alive = active & (pos < bound)
        if not bool(alive.any()):
            break
        pair = t.slots.index_select(0, c)
        tbl = torch.where(z == 0, pair[:, 0], pair[:, 1])
        code_len, _ = H._code(cfg.fast_tables, t, H._load32(t, p), tbl)
        p2, c, z, _, run, commit = H._symbol_step(cfg, t, p, c, z, alive,
                                                  need_value=False)
        counts += torch.stack(
            [commit.sum()] + [(commit & (code_len > b)).sum()
                              for b in (8, 9, 10, 11)]
            + [(commit & (p2 - p >= 32)).sum()])
        pos = torch.where(commit, pos + run + 1, pos)
        p, active = p2, commit
    return counts.tolist()


def busy_sm_clock(dev: torch.device, work) -> float:
    """The SM clock in MHz, `clocks.sm` of nvidia-smi read while the card
    runs `work` again and again (an idle card reads its idle clock)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while proc.poll() is None and time.monotonic() < deadline:
            work()
            sync(dev)
        out, _ = proc.communicate(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        raise RuntimeError(f"nvidia-smi failed: {proc.returncode}")
    return float(out.strip().splitlines()[0])


def sync_window(dev, card, cfg, arrs, ctx) -> None:
    """The profiler's device work inside one sync_states: one K1 launch per
    round and, besides, only a set-up that does not grow with the rounds
    (the flags' zero fill) and the one read per round."""
    _, counts, _ = counted(lambda: H.sync_states(cfg, arrs, ctx))
    rounds = counts["subseq_pass"]
    names = {}
    for e in profiled(dev, lambda: H.sync_states(cfg, arrs, ctx)):
        names[e.name] = names.get(e.name, 0) + 1
    k1 = sum(v for k, v in names.items() if "subseq_pass_kernel" in k)
    copies = sum(v for k, v in names.items() if "Memcpy" in k)
    other = {k[:60]: v for k, v in names.items()
             if "subseq_pass_kernel" not in k and "Memcpy" not in k}
    log(f"sync_states window on the device: {rounds} rounds, {k1} K1 "
        f"launches, {copies} copies to the host, other device work {other}  "
        f"[{card}]")
    if k1 != rounds or sum(other.values()) > 2:
        raise AssertionError("sync_states must launch K1 once per round and "
                             "nothing else between rounds")


def lane_path_kernels(dev: torch.device, data: bytes, card: str):
    """K7 and K8 at the shapes of the sparse 12 MP image, each fed by the
    real stage before it and held against its plain version; then the
    whole per-lane write stage against K2's stream. Returns the two kernel
    entries (without launch counts)."""
    plan = pipeline.build_plan(T.parse(data), tuning=AUTO)
    sp, = plan.signature.scans
    cfg = sp.cfg
    scan, = plan.stream.scans
    avg_du = scan.total_data_units / scan.num_subsequences
    log(f"sparse 12 MP shapes: {len(data)} bytes, {scan.num_subsequences} "
        f"subsequences in lanes {cfg.lanes}, {avg_du:.1f} data units per "
        f"subsequence, tile_auto {cfg.tile_auto}, tile_d {cfg.tile_d}")
    if W.resolve_tile_mode(cfg.tuning.tile_mode, cfg.tile_auto) != "lane":
        raise AssertionError("tile_mode='auto' did not resolve to the "
                             "per-lane shape on the sparse image")
    staged = pipeline.stage_inputs(pipeline.build_inputs(data, plan), plan,
                                   dev)
    arrs = staged["scans"][0]
    ctx = H.make_ctx(cfg, arrs)
    p, c, z, n = H.sync_states(cfg, arrs, ctx)
    states = (p, c, z, H.symbol_offsets(cfg, arrs, n))
    coeffs = H.decode_write(cfg, arrs, ctx, *states)
    rec, m = H.decode_write_emit(cfg, arrs, ctx, *states)
    pos0 = arrs.seg_of_subseq * cfg.positions_per_seg + states[3]
    total, tile_d, lanes = cfg.total_positions, cfg.tile_d, cfg.lanes
    prep_ms, prep = host_ms(lambda: W.lane_records(
        rec, m, pos0 >> 6, pos0, total, tile_d), dev)
    val, wpos, du0, q, leftover, n_groups, max_du = prep
    include = ~leftover
    reach = torch.where(leftover, -1, max_du)  # as assemble_tiles makes it
    log(f"per-lane shape: {int(m.sum())} records of {count_symbols(coeffs)} "
        f"symbols, at most {int(m.max())} in a lane, emission buffer "
        f"{tuple(rec.shape)}, {n_groups} groups, {int(leftover.sum())} "
        f"leftover lane(s); preparation {prep_ms:.3f} ms on the host clock  "
        f"[{card}]")
    entries = []

    # K7, from the preparation of K4's records
    tiles, timing = measure(
        dev, card, "K7 tiles_from_records",
        lambda: W.tiles_from_records(val, wpos, m, du0, include, tile_d),
        lambda: W.tiles_from_records_plain(val, wpos, m, du0, include,
                                           tile_d),
        max_abs_err)
    slot = torch.arange(rec.shape[0], dtype=torch.int32, device=dev)[:, None]
    d_rel = (wpos >> 6) - du0[None, :]
    placed = int((include[None, :] & (slot < m[None, :]) & (wpos >= 0)
                  & (d_rel >= 0) & (d_rel < tile_d)).sum())
    b_ms, b_by = bound((2 + 4) * placed + nbytes(m, du0, include) + 64 * 4
                       + nbytes(tiles),
                       placed * K7_OPS_PER_RECORD
                       + tiles.numel() * K7_OPS_PER_CELL)
    log(f"  {placed} live records, {nbytes(tiles) / 1e6:.1f} MB of tiles")
    entries.append(dict(
        name="tiles_from_records", route="cuda",
        source="jpeggpu_tpu_torch/kernels/csrc/tiles.cu",
        replaces="jpeggpu_tpu/ops/write_pallas.py:210", bound_ms=b_ms,
        bound_by=b_by, records=placed, **timing))

    # K8, from K7's tiles: with reach, as assemble_tiles calls it, then at
    # the full tile depth (the reference's function); the same rows
    rows, timing = measure(
        dev, card, "K8 expand_tiles with reach",
        lambda: W.expand_tiles(tiles, du0, q, n_groups, reach),
        lambda: W.expand_tiles_plain(tiles, du0, q, n_groups, reach),
        max_abs_err)
    full_rows, full = measure(
        dev, card, "K8 expand_tiles at the full tile depth",
        lambda: W.expand_tiles(tiles, du0, q, n_groups),
        lambda: W.expand_tiles_plain(tiles, du0, q, n_groups), max_abs_err)
    same = max_abs_err(rows, full_rows)
    if same:
        raise AssertionError("K8's rows differ with and without reach")
    # tile rows that match an output row: row d of lane l names data unit
    # du0[l] + d, and is read iff l lies in the window of that unit's group
    # (and, with reach, du0[l] + d <= reach[l])
    j = du0[:, None].to(torch.int64) + torch.arange(tile_d, device=dev)
    first = q.to(torch.int64)[(j // 128).clamp(0, n_groups - 1)] * 32
    lane = torch.arange(lanes, device=dev)[:, None]
    hit = (j < rows.shape[0]) & (lane >= first) & (lane < first + 64)
    matched = int(hit.sum())
    within = int((hit & (j <= reach[:, None])).sum())

    def k8_bound(read: int, *inputs):
        return bound(128 * read + nbytes(du0, q, rows, *inputs),
                     rows.shape[0] * 64 * K8_OPS_PER_CANDIDATE
                     + read * 64 * K8_OPS_PER_HIT_CELL
                     + rows.numel() * K8_OPS_PER_CELL)

    b_ms, b_by = k8_bound(within, reach)
    full_b_ms, _ = k8_bound(matched)
    log(f"  K8 reads {within} tile rows ({128 * within / 1e6:.1f} MB) with "
        f"reach, {matched} of {lanes * tile_d} ({128 * matched / 1e6:.1f} MB) "
        f"at the full depth, and writes {nbytes(rows) / 1e6:.1f} MB: bound "
        f"{b_ms:.4f} ms with reach, {full_b_ms:.4f} ms without; the rows "
        f"are the same  [{card}]")
    entries.append(dict(
        name="expand_tiles", route="cuda",
        source="jpeggpu_tpu_torch/kernels/csrc/expand_tiles.cu",
        replaces="jpeggpu_tpu/ops/write_pallas.py:685", bound_ms=b_ms,
        bound_by=b_by, tile_rows_read=within, mb_read=128 * within / 1e6,
        **dict(timing, max_abs_err=max(timing["max_abs_err"],
                                       full["max_abs_err"])),
        full_depth=dict(bound_ms=full_b_ms, tile_rows_read=matched,
                        mb_read=128 * matched / 1e6, **full)))
    for e in entries:
        log(f"  {e['name']}: bound {e['bound_ms']:.4f} ms by {e['bound_by']}")

    # the stage per step, then whole, against the direct write
    stages = {}
    stages["decode_write_emit"], _ = host_ms(
        lambda: H.decode_write_emit(cfg, arrs, ctx, *states), dev)
    stages["lane_records (preparation)"] = prep_ms
    stages["tiles_from_records"], _ = host_ms(
        lambda: W.tiles_from_records(val, wpos, m, du0, include, tile_d), dev)
    stages["expand_tiles"], _ = host_ms(
        lambda: W.expand_tiles(tiles, du0, q, n_groups, reach), dev)
    stages["scatter_leftover"], _ = host_ms(lambda: W.scatter_leftover(
        rows.view(-1), rec, m, pos0, leftover, total), dev)
    stages["decode_write_tiles (all of the above)"], (tcoeffs, none) = host_ms(
        lambda: W.decode_write_tiles(cfg, arrs, ctx, *states, return_dc=True),
        dev)
    stages["decode_write (K2), for comparison"], _ = host_ms(
        lambda: H.decode_write(cfg, arrs, ctx, *states), dev)
    for name, ms in stages.items():
        log(f"per-lane stage {name}: {ms:.3f} ms  [{card}]")
    err = max_abs_err(tcoeffs, coeffs)
    log(f"per-lane write stage (K4 + preparation + K7 + K8 + leftover, "
        f"{W.scatter_leftover.lanes} leftover lane(s)): max_abs_err {err} "
        f"against K2's stream, no DC side vector: {none is None}")
    if err or none is not None:
        raise AssertionError("the per-lane write stage differs from K2")
    return entries


def phase_lane_path(dev: torch.device, data: bytes, card: str):
    """This slice's main path on the sparse 12 MP image, with the launch
    counts read around it, against the default path and the plain path;
    then the default path, the forced supertile shape and `auto` on the
    same image side by side. Returns the launch counts and the per-launch
    times of the per-lane shape's kernels inside its decode."""
    n_comps = len(T.parse(data).components)
    planes, launches, by_slot = counted(lambda: decode_tiles(data, dev, AUTO))
    log(f"per-lane path launches: {launches}, components K3 covered by "
        f"first slot: {by_slot}; {W.scatter_leftover.lanes} leftover "
        f"lane(s)")
    if not (launches["subseq_pass"] >= 2
            and all(launches[k] == 1
                    for k in ("decode_write_emit",) + LANE_KERNELS)
            and not any(launches[k] for k in ("decode_write",) + SUPER_KERNELS
                        + SHARDED_KERNELS + TIER_KERNELS)
            and k3_once(launches, by_slot, n_comps)):
        raise AssertionError(f"the per-lane path must launch K1, K4, K7, K8 "
                             f"and K3 once, and not K2, K5 or K6: {launches} "
                             f"{by_slot}")
    check_equal_numpy("sparse 12 MP per-lane path vs default path", planes,
                      T.decode(data, device=dev))
    t0 = time.perf_counter()
    plain = decode_tiles(data, torch.device("cpu"), AUTO)
    log(f"plain path (the same plan on CPU tensors) decoded in "
        f"{time.perf_counter() - t0:.1f} s")
    check_equal_numpy("sparse 12 MP per-lane path vs plain path", planes,
                      plain)
    log("sparse 12 MP decode through tile_mode='auto' (per-lane) == default "
        "path == plain path, planes "
        + ", ".join(str(pl.shape) for pl in planes))

    stream = T.parse(data)
    mp = stream.size_x * stream.size_y / 1e6
    base_tuning = T.default_tuning()
    W.scatter_leftover.lanes = 0
    decoders, times = {}, {}
    for label, tuning, own in (
            ("sparse image, default path", base_tuning,
             ("::decode_write_kernel",)),
            ("sparse image, supertile shape", TILES,
             ("::emit_pass_kernel", "::supertiles_kernel",
              "::expand_supertiles_kernel")),
            ("sparse image, auto = per-lane shape", AUTO,
             ("::emit_pass_kernel", "::tiles_kernel",
              "::expand_tiles_kernel", "::idct_stream_to_planes_kernel"))):
        T.set_default_tuning(tuning)
        try:
            got = T.decode(data, device=dev)
            check_equal_numpy(label, got, planes)
            decode_ms = end_to_end(dev, data, card, label,
                                   lambda: T.decode(data, device=dev), mp)
            plan = pipeline.build_plan(stream)
            decoders[label] = T.Decoder(device=dev)
            decoders[label].parse_header(data)
            decoders[label].transfer()
        finally:
            T.set_default_tuning(base_tuning)
        log(f"{label}: {W.scatter_leftover.lanes} leftover lane(s)")
        staged = pipeline.stage_inputs(pipeline.build_inputs(data, plan),
                                       plan, dev)
        times = profile_decode(
            dev, card, label,
            lambda: pipeline.decode_pipeline(plan.signature, staged["scans"],
                                             staged["qtables"]),
            decode_ms, ("::subseq_pass_kernel",) + own)

    # the host clock drifts over a run: the three again, taking turns
    turns = {label: [] for label in decoders}
    for _ in range(15):
        for label, d in decoders.items():
            sync(dev)
            t0 = time.perf_counter()
            d.decode(device=True)
            sync(dev)
            turns[label].append((time.perf_counter() - t0) * 1e3)
    for label, d in decoders.items():
        ms = sorted(turns[label])
        log(f"{label}: decode from staged inputs, 15 turns with the other "
            f"two: median {ms[7]:.2f} ms, quartiles {ms[3]:.2f} - "
            f"{ms[11]:.2f} ms  [{card}]")
        d.cleanup()
    # the last profile is the per-lane shape's: its kernels inside the decode
    return launches, by_slot, times


# --- the device destuff and the rest of the Decoder API ---------------------

def device_destuff_words(data: bytes, dev: torch.device):
    """Per scan of `data`: (the device destuff's words on `dev`, the host
    destuffer's words, the scan's raw bytes and segment offsets on `dev`,
    lanes), from one plan with `host_destuff=False`."""
    plan = pipeline.build_plan(T.parse(data), host_destuff=False)
    inputs = pipeline.build_inputs(data, plan)
    buf = np.frombuffer(data, np.uint8)
    out = []
    for scan, sp, inp in zip(plan.stream.scans, plan.signature.scans,
                             inputs["scans"]):
        raw = torch.from_numpy(inp["raw"]).to(dev)
        sso = torch.from_numpy(inp["seg_sub_offset"]).to(dev)
        words = DS.destuff_scan(raw, sso, sp.cfg.lanes)
        if words.device != raw.device:
            raise AssertionError("the device destuff left its device")
        out.append((words, pipeline._destuff_host(buf, scan, sp.cfg.lanes),
                    raw, sso, sp.cfg.lanes))
    return out


def device_destuff_decode(data: bytes, dev: torch.device, **keywords):
    """`Decoder(host_destuff=False).decode(**keywords)` of `data`."""
    with T.Decoder(device=dev, host_destuff=False) as d:
        d.parse_header(data)
        return d.decode(**keywords)


def phase_device_destuff_small_streams(dev: torch.device, seed: int) -> None:
    """On the card, `ops.destuff.destuff_scan` == the host destuffer's words
    on every scan of every small stream, and `Decoder(host_destuff=False)`
    decodes each == golden, on the default path and under a plan built with
    `Tuning(write_mode="tiles")`."""
    for name, data in small_streams(seed):
        for si, (words, host, *_) in enumerate(device_destuff_words(data,
                                                                    dev)):
            got = words.cpu().numpy().view(np.uint32)
            if not np.array_equal(got, host):
                bad = int(np.flatnonzero(got != host)[0])
                raise AssertionError(f"{name} scan {si}: the device destuff "
                                     f"differs from the host's at word {bad}")
        expect = golden.decode(data)
        check_equal_numpy(name, device_destuff_decode(data, dev), expect)
        plan = pipeline.build_plan(T.parse(data), tuning=AUTO,
                                   host_destuff=False)
        check_equal_numpy(name, pipeline.decode_jpeg_device(
            data, device=dev, plan=plan), expect)
        log(f"small stream {name}: device destuff == host destuffer on every "
            f"scan; Decoder(host_destuff=False) on {dev.type} == golden on "
            f"the default path and the records write path")


def peak_of(dev, host_destuff: bool, data: bytes, donate: bool = False):
    """One decode from bytes in a new Decoder: its get_buffer_size, the
    bytes of its staged inputs, and the peak of device memory above what
    was allocated before it (staged inputs, destuff, decode; planes left on
    the device), in bytes."""
    sync(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with T.Decoder(device=dev, host_destuff=host_destuff) as d:
        d.parse_header(data)
        size = d.get_buffer_size()
        d.transfer()
        staged = torch.cuda.memory_allocated(dev) - before
        planes = d.decode(device=True, donate=donate)
        sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) - before
        del planes
    return size, staged, peak


def phase_device_destuff_path(dev: torch.device, card: str, data: bytes,
                              label: str):
    """The 12 MP image `data` through `Decoder(host_destuff=False)`: its
    launches counted (K1 once per sync round as on the default path, K2
    once, K3 once per scan, nothing else), its planes == the default
    path's; then, in turns within this call, the decode from bytes and from
    staged inputs with the host destuff and with the device destuff, the
    host stage the device destuff replaces beside the device destuff's own
    time, launches and bound, the bytes copied in, and peak device memory
    beside `get_buffer_size()` for both. Returns the counted launches."""
    expect, base, base_slot = counted(lambda: T.decode(data, device=dev))
    planes, launches, by_slot = counted(lambda: device_destuff_decode(data,
                                                                      dev))
    log(f"{label}, device destuff path launches: {launches}, components K3 "
        f"covered by first slot: {by_slot}; the default path's: {base}")
    n_comps = len(T.parse(data).components)
    if not (launches == base and by_slot == base_slot
            and launches["subseq_pass"] >= 2
            and launches["decode_write"] == 1
            and k3_once(launches, by_slot, n_comps)):
        raise AssertionError(f"the device destuff path must launch what the "
                             f"default path does (K1 once per round, K2 "
                             f"once, K3 once): {launches} {by_slot} against "
                             f"{base} {base_slot}")
    check_equal_numpy(f"{label}, device destuff vs default path", planes,
                      expect)
    (words, host, raw, sso, lanes), = device_destuff_words(data, dev)
    if not np.array_equal(words.cpu().numpy().view(np.uint32), host):
        raise AssertionError(f"{label}: the device destuff differs from the "
                             f"host destuffer")
    log(f"{label}: Decoder(host_destuff=False) == default path; device "
        f"destuff == host destuffer ({host.size} words)")

    # the host stages each mode pays, and the device destuff alone
    plans = {h: pipeline.build_plan(T.parse(data), host_destuff=h)
             for h in (True, False)}
    stage, inputs, staged, copied = {}, {}, {}, {}
    for h, name in ((True, "host destuff + tables"),
                    (False, "raw staging + tables (device destuff)")):
        stage[h], inputs[h] = host_ms(
            lambda: pipeline.build_inputs(data, plans[h]), dev)
        copy_ms, staged[h] = host_ms(
            lambda: pipeline.stage_inputs(inputs[h], plans[h], dev), dev)
        s = staged[h]["scans"][0]
        copied[h] = nbytes(*(t for t in vars(s).values()
                             if isinstance(t, torch.Tensor)))
        log(f"{label}, stage {name}: {stage[h]:.3f} ms; copy in "
            f"{copy_ms:.3f} ms for {copied[h] / 1e6:.3f} MB of scan inputs "
            f"({'words' if h else 'raw bytes + segment offsets'}, segment "
            f"tables, Huffman and symbol tables)  [{card}]")
    run = lambda: DS.destuff_scan(raw, sso, lanes)  # noqa: E731
    warm_ms, call_ms = time_ms(run, dev)
    cold_ms = time_cold_ms(run, dev)
    on_device = device_work(dev, run)
    prof_ms = sum(ms for _, ms in on_device)
    destuff_host_ms, _ = host_ms(run, dev)
    b_ms, b_by = bound(raw.numel() + nbytes(words), 0)
    log(f"{label}, device destuff (destuff_scan, {raw.numel()} raw bytes -> "
        f"{nbytes(words)} bytes of words): {len(on_device)} launches, "
        f"{prof_ms:.4f} ms of device time in the profiler; CUDA events "
        f"{warm_ms:.4f} ms with L2 warm, {cold_ms:.4f} ms cold; "
        f"{destuff_host_ms:.3f} ms on the host clock; bound {b_ms:.4f} ms "
        f"({b_by}), {b_ms / cold_ms:.1%} of it cold  [{card}]")
    for name, ms in sorted(on_device, key=lambda e: -e[1])[:6]:
        log(f"  {ms:.4f} ms  {name[:70]}")

    # decode from bytes and from staged inputs, both modes in turns
    decoders = {}
    for h in (True, False):
        decoders[h] = T.Decoder(device=dev, host_destuff=h)
        decoders[h].parse_header(data)
        decoders[h].transfer()
    one_shot = {True: lambda: T.decode(data, device=dev),
                False: lambda: device_destuff_decode(data, dev)}
    full = {True: [], False: []}
    from_staged = {True: [], False: []}
    for _ in range(4):
        for h in (True, False, False, True):
            sync(dev)
            t0 = time.perf_counter()
            one_shot[h]()
            full[h].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            decoders[h].decode(device=True)
            sync(dev)
            from_staged[h].append((time.perf_counter() - t0) * 1e3)
    stream = T.parse(data)
    mp = stream.size_x * stream.size_y / 1e6
    for h in (True, False):
        name = "host destuff" if h else "device destuff"
        for what, ms in (("from bytes (copy out included)", full[h]),
                         ("from staged inputs", from_staged[h])):
            ms = sorted(ms)
            log(f"{label}, {name}: decode {what}, 8 turns with the other "
                f"mode: median {statistics.median(ms):.2f} ms "
                f"({mp / statistics.median(ms) * 1e3:.0f} MP/s), range "
                f"{ms[0]:.2f} - {ms[-1]:.2f} ms  [{card}]")
        decoders[h].cleanup()
    for h in (True, False):
        size, staged_b, peak = peak_of(dev, h, data)
        log(f"{label}, {'host' if h else 'device'} destuff: get_buffer_size "
            f"{size / 1e6:.1f} MB; measured peak of a decode from bytes "
            f"{peak / 1e6:.1f} MB (staged inputs {staged_b / 1e6:.1f} MB "
            f"included): get_buffer_size "
            f"{'bounds' if size >= peak else 'does NOT bound'} it  [{card}]")
    return launches, by_slot


def pageable_inputs(inputs, plan, dev):
    """The staged device inputs as one pageable copy per array: what the
    staging region's views must equal (dtype, shape, contiguity, values)."""
    def one(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a).to(dev)

    scans = []
    for s, sp in zip(inputs["scans"], plan.signature.scans):
        t = {name: one(a) for name, a in s.items()}
        t["symtab"] = torch.tensor(convert.symbol_table(
            s["maxcode"], s["vsm"], s["huffval"], sp.cfg.fast_tables),
            device=dev)
        scans.append(t)
    return scans, one(inputs["qtables"])


def same_tensor(name, got, want) -> None:
    if (got.dtype != want.dtype or got.shape != want.shape
            or not got.is_contiguous() or not torch.equal(got, want)):
        raise AssertionError(f"staged {name}: {got.dtype} {tuple(got.shape)}"
                             f" != {want.dtype} {tuple(want.shape)}, or "
                             f"values differ")


def staged_equal(label, staged, inputs, plan, dev) -> None:
    """Each tensor of ``staged`` (``pipeline.stage_inputs``) torch.equal to
    the pageable copy of the same host array."""
    scans, qtables = pageable_inputs(inputs, plan, dev)
    for si, (arrs, want) in enumerate(zip(staged["scans"], scans)):
        for name, w in want.items():
            same_tensor(f"{label} scan {si} {name}", getattr(arrs, name), w)
    same_tensor(f"{label} qtables", staged["qtables"], qtables)


def phase_staging(dev: torch.device, card: str, seed: int) -> None:
    """The host staging (``jpeggpu_tpu_torch/staging.py``) on the card. At
    12 MP: the pinned staging region's device views torch.equal to one
    pageable copy per array, in two copies (one scan, the tables); a
    transfer whose copy is held in the stream behind 50 ms of device work
    and then a transfer of another image by the same decoder: the first
    image's staged inputs still equal its own (the decoder waited for the
    copy before writing over its buffer). Then two Decoders alternate over
    50 images of three sizes (12 MP, 4032x1512, 4032x378, two contents),
    each transfer issued before the other decoder's decode: every plane ==
    golden, two copies an image, no staging buffer allocated after each
    decoder's first image."""
    from jpeggpu_tpu_torch import staging as ST

    strips = [make_image(seed + k, QUALITY, width=FULL_W, height=FULL_H)[0]
              for k in (0, 1)]
    heights = (FULL_H, FULL_H // 2, FULL_H // 8)
    images = [(repeat_strip(st, h), tiled_golden(st, h))
              for h in heights for st in strips]
    data = images[0][0]
    plan = pipeline.build_plan(T.parse(data))
    stg = ST.HostStaging(dev)
    stg.begin()
    inputs = pipeline.build_inputs(data, plan, stg)
    if not inputs["regions"][0].host.is_pinned():
        raise AssertionError("the decoder's staging buffer is not pinned")
    copies = ST.h2d_copies
    staged = pipeline.stage_inputs(inputs, plan, dev)
    n = ST.h2d_copies - copies
    sync(dev)
    staged_equal("12 MP", staged, inputs, plan, dev)
    if n != 2:
        raise AssertionError(f"12 MP staged in {n} copies, not 2")
    log(f"12 MP: the pinned staging's views == one pageable copy per array "
        f"(dtype, shape, contiguity, values); {n} copies to the card")

    # a copy held behind device work, then the buffer written over
    other, other_planes = images[1]
    with T.Decoder(device=dev) as d:
        d.parse_header(data)
        torch.cuda._sleep(100_000_000)  # ~50 ms, queued before the copy
        t0 = time.perf_counter()
        d.transfer()
        first = d._device_inputs
        d.parse_header(other)
        d.transfer()
        waited = (time.perf_counter() - t0) * 1e3
        check_equal_numpy("the second image after a held copy", d.decode(),
                          other_planes)
        staged_equal("the first image after its buffer was rewritten",
                     first, pipeline.build_inputs(data, plan), plan, dev)
    log(f"a transfer queued behind ~50 ms of device work, then the next "
        f"image's transfer by the same decoder: {waited:.1f} ms for both "
        f"(the wait included); the first image's staged inputs unchanged, "
        f"the second == golden")

    rng = np.random.default_rng(seed)
    # each decoder's first image is the largest: its buffer fits the rest
    order = [0, 1] + [int(k) for k in rng.integers(0, len(images), 48)]
    decs = [T.Decoder(device=dev), T.Decoder(device=dev)]
    allocs0, copies0 = ST.host_allocs, ST.h2d_copies
    pending = []
    for n, k in enumerate(order):
        d = decs[n % 2]
        d.parse_header(images[k][0])
        d.transfer()
        if n == 1:
            allocs0 = ST.host_allocs
        pending.append((d, k))
        if len(pending) == 2:
            d0, k0 = pending.pop(0)
            check_equal_numpy(f"alternating decode {n - 1}", d0.decode(),
                              images[k0][1])
    d0, k0 = pending.pop(0)
    check_equal_numpy("alternating decode 49", d0.decode(), images[k0][1])
    copies = ST.h2d_copies - copies0
    allocs = ST.host_allocs - allocs0
    for d in decs:
        d.cleanup()
    if copies != 2 * len(order) or allocs:
        raise AssertionError(f"{len(order)} images: {copies} copies, "
                             f"{allocs} staging buffers allocated after the "
                             f"first image of each decoder")
    log(f"two Decoders alternating over {len(order)} images of "
        f"{len(heights)} sizes, each transfer before the other's decode: "
        f"all == golden; staging.h2d_copies {copies} "
        f"({copies / len(order):.0f} an image), staging.host_allocs "
        f"{allocs} after each decoder's first image  [{card}]")


def phase_api(dev: torch.device, card: str, data: bytes, other: bytes,
              expect, seed: int) -> None:
    """The rest of the Decoder API on the card: `decode_into` into pitched
    CUDA tensors (uint8 and int16; the corner == golden or the coefficient
    planes, the pitch untouched, the same memory across two images, no
    launch beyond the default path's, InvalidArgument for a CPU tensor and
    a pitch below the width); `decode(donate=True)` (== golden, the staged
    words freed, peak memory beside a decode without it, the next decode
    right); debug mode on the small streams with the device destuff, and a
    corrupted device destuff caught; `profile_trace`; the decode tool."""
    info = T.parse(data)
    sizes = [(c.size_y, c.size_x) for c in info.components]
    if [(c.size_y, c.size_x) for c in T.parse(other).components] != sizes:
        raise AssertionError("the two images differ in geometry")
    def default_launches(img, with_idct):
        with T.Decoder(device=dev) as d:
            d.parse_header(img)
            return counted(lambda: d.decode(with_idct=with_idct))[1:]

    # the default path's launches on each image, pixels and coefficients
    base = {(img, w): default_launches(img, w)
            for img in (data, other) for w in (True, False)}
    for with_idct, dtype, sentinel in ((True, torch.uint8, 77),
                                       (False, torch.int16, -1234)):
        outs = [torch.full((h + 5, w + 64), sentinel, dtype=dtype,
                           device=dev) for h, w in sizes]
        ptrs = [o.data_ptr() for o in outs]
        with T.Decoder(device=dev) as d:
            for img, ref in ((data, expect), (other, None)):
                d.parse_header(img)
                if ref is None or not with_idct:
                    ref = d.decode(with_idct=with_idct)
                got, *launches = counted(
                    lambda: d.decode_into(outs, with_idct=with_idct))
                if tuple(launches) != base[img, with_idct]:
                    raise AssertionError(
                        f"decode_into launched {launches}, the default path "
                        f"{base[img, with_idct]}")
                if [g.data_ptr() for g in got] != ptrs:
                    raise AssertionError("decode_into moved the planes")
                for g, (h, w) in zip(got, sizes):
                    if not (bool((g[:h, w:] == sentinel).all())
                            and bool((g[h:] == sentinel).all())):
                        raise AssertionError("decode_into wrote past the "
                                             "plane")
                check_equal_numpy(f"decode_into {dtype}", [
                    g[:h, :w].cpu().numpy() for g, (h, w) in zip(got, sizes)],
                    ref)
            # a tensor on another device: the host's (meta where the
            # decoder itself runs on the host, as in a rehearsal)
            other_dev = "cpu" if dev.type == "cuda" else "meta"
            for bad in ([o.to(other_dev) for o in outs],
                        [o[:, :w - 1] for o, (h, w) in zip(outs, sizes)]):
                try:
                    d.decode_into(bad, with_idct=with_idct)
                except T.InvalidArgument:
                    continue
                raise AssertionError("decode_into took a CPU tensor or a "
                                     "pitch below the width")
    log(f"decode_into, uint8 and int16, two 12 MP images into the same "
        f"pitched CUDA tensors: corner == golden / coefficient planes, pitch "
        f"untouched, same data_ptr, the default path's launches "
        f"{base[data, True][0]}; "
        f"InvalidArgument for a CPU tensor and for a pitch below the width")

    sync(dev)
    for donate in (False, True, False, True):
        size, staged_b, peak = peak_of(dev, True, data, donate=donate)
        log(f"decode with donate={donate}: peak device memory of a decode "
            f"from bytes {peak / 1e6:.1f} MB (staged inputs "
            f"{staged_b / 1e6:.1f} MB included)  [{card}]")
    with T.Decoder(device=dev) as d:
        d.parse_header(data)
        d.transfer()
        held = weakref.ref(d._device_inputs["scans"][0].words)
        check_equal_numpy("decode(donate=True)", d.decode(donate=True),
                          expect)
        gc.collect()
        if held() is not None or d._device_inputs is not None:
            raise AssertionError("decode(donate=True) kept the staged words")
        check_equal_numpy("the decode after a donating one", d.decode(),
                          expect)
    log("decode(donate=True) == golden; the staged words were freed; the "
        "next decode restaged and == golden")

    streams = small_streams(seed)
    T.debug.set_debug(True)
    try:
        for name, data_s in streams:
            with T.Decoder(device=dev, host_destuff=False) as d:
                d.parse_header(data_s)
                d.decode()
        log(f"debug mode on the {len(streams)} small streams "
            f"with the device destuff: segment tables, device destuff == "
            f"host, golden and sync-state invariants all hold")
        good = DS.destuff_scan

        def corrupted(raw, sso, lanes):
            words = good(raw, sso, lanes).clone()
            words[3] ^= 0xDEAD
            return words

        DS.destuff_scan = corrupted
        try:
            with T.Decoder(device=dev, host_destuff=False) as d:
                d.parse_header(streams[0][1])
                d.decode()
        except T.InternalError as err:
            if "destuff" not in str(err):
                raise
            log(f"debug mode caught a corrupted device destuff: {err}")
        else:
            raise AssertionError("debug mode missed a corrupted destuff")
        finally:
            DS.destuff_scan = good
    finally:
        T.debug.set_debug(False)

    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        src = pathlib.Path(tmp) / "in.jpg"
        src.write_bytes(streams[0][1])
        out = subprocess.run(
            [sys.executable, "-m", "jpeggpu_tpu_torch.decode_tool", str(src),
             str(pathlib.Path(tmp) / "out.png"), "--device", dev.type],
            cwd=root, capture_output=True, text=True, timeout=300)
        if out.returncode or not (pathlib.Path(tmp) / "out.png").exists():
            raise AssertionError(f"decode_tool failed: {out.stderr}")
        for line in out.stdout.splitlines():
            log(f"  decode_tool: {line}")
        with T.debug.profile_trace(tmp):
            check_equal_numpy("decode inside profile_trace",
                              device_destuff_decode(data, dev), expect)
        trace, = pathlib.Path(tmp).glob("*.json")
        text = trace.read_text()
        names = ("jpeggpu.destuff", "jpeggpu.sync", "jpeggpu.write.fused",
                 "jpeggpu.dc", "jpeggpu.idct_fused", "subseq_pass_kernel",
                 "decode_write_kernel", "idct_stream_to_planes_kernel")
        missing = [n for n in names if n not in text]
        if missing:
            raise AssertionError(f"the trace lacks {missing}")
        log(f"profile_trace: a {len(text) / 1e6:.1f} MB Chrome trace of a "
            f"12 MP decode holding {', '.join(names)}")


# --- the sharded decode (parallel/segments.py) and its kernel K9 ------------

def phase_k9_any_input(dev: torch.device, seed: int) -> None:
    """K9 against its plain version on made-up planes: coefficients at
    +-32767 and -32768 beside random ones, qtable bytes at and above 128
    (read as signed int8), block counts that are not multiples of 512; one
    plane per launch, then planes of mixed shapes and tables in one
    launch."""
    rng = np.random.default_rng(seed)
    extremes = np.array([-32768, -32767, -1, 0, 1, 2, 32767], np.int16)
    made_up = []
    for h, w in ((8 * 37, 8 * 23), (8, 40), (768, 4032), (384, 2016)):
        plane = rng.choice(extremes, (h, w))
        plane[:h // 2] = rng.integers(-32768, 32768, (h // 2, w))
        q = rng.integers(128, 256, 64).astype(np.int32)
        q[::3] = rng.integers(0, 128, len(q[::3]))
        pt, qt = (torch.from_numpy(a).to(dev) for a in (plane, q))
        made_up.append((pt, qt))
        err = max_abs_err(I.dequant_idct_plane(pt, qt),
                          I.dequant_idct_plane_plain(pt, qt))
        sync(dev)
        log(f"K9 on a made-up {h}x{w} plane ({h * w // 64} blocks): "
            f"max_abs_err {err} against the plain version")
        if err:
            raise AssertionError("K9 differs from its plain version on "
                                 "made-up inputs")
    for group in (made_up, made_up[2:] + made_up[:1]):
        outs = I.dequant_idct_planes([p for p, _ in group],
                                     [q for _, q in group])
        err = max(max_abs_err(o, I.dequant_idct_plane_plain(p, q))
                  for o, (p, q) in zip(outs, group))
        sync(dev)
        log(f"K9 on {len(group)} made-up planes of mixed shapes in one "
            f"launch ({', '.join(str(tuple(p.shape)) for p, _ in group)}): "
            f"max_abs_err {err} against the plain version")
        if err:
            raise AssertionError("K9 differs from its plain version on "
                                 "made-up planes in one launch")


# made-up geometries of K3: data units per MCU, and per component (off,
# ssx, ssy, table index)
STREAM_LAYOUTS = {
    "4:2:0": (6, ((0, 2, 2, 0), (4, 1, 1, 1), (5, 1, 1, 1))),
    "4:2:2": (4, ((0, 2, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1))),
    "4:4:0": (4, ((0, 1, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1))),
    "4:1:1": (6, ((0, 4, 1, 0), (4, 1, 1, 1), (5, 1, 1, 1))),
    "4:4:4": (3, ((0, 1, 1, 0), (1, 1, 1, 1), (2, 1, 1, 2))),
    "gray": (1, ((0, 1, 1, 0),)),
    "non-interleaved": (1, ((0, 1, 1, 1),)),
}


def phase_k3_any_input(dev: torch.device, seed: int) -> None:
    """K3 against its plain version on made-up streams: every geometry of
    STREAM_LAYOUTS, MCU rows of 1, R-1, R and R+1 MCUs (R: the run length
    for that many data units per MCU, so that rows end ragged, exactly or
    one past a run), 3 MCU rows; coefficients and DC at +-32767 and -32768
    beside random ones, table bytes at and above 128 (read as signed int8);
    all components in one launch, and each alone, for one image and for a
    batch of three, each image with its own tables."""
    rng = np.random.default_rng(seed)
    extremes = np.array([-32768, -32767, -1, 0, 1, 2, 32767], np.int16)
    batch = 3
    for name, (dpm, comps) in STREAM_LAYOUTS.items():
        run_mcus = I.stream_runs(1, 1, dpm)[0]
        for mcus_x in (1, run_mcus - 1, run_mcus, run_mcus + 1):
            mcus_y = 3
            units = batch * mcus_x * mcus_y * dpm
            coeffs = rng.choice(extremes, units * 64)
            coeffs[::2] = rng.integers(-32768, 32768, units * 32)
            dcv = rng.choice(extremes, units)
            dcv[::3] = rng.integers(-32768, 32768, len(dcv[::3]))
            q = rng.integers(128, 256, (batch, 3, 64)).astype(np.int32)
            q[:, :, ::3] = rng.integers(0, 128, q[:, :, ::3].shape)
            ct, dt, qt = (torch.from_numpy(a).to(dev)
                          for a in (coeffs, dcv, q))
            one = units // batch
            err = 0
            for sel in (comps,) + tuple((c,) for c in comps):
                for args in ((ct[:one * 64], qt[0], (mcus_x, mcus_y, sel),
                              dpm, dt[:one]),
                             (ct, qt, (mcus_x, mcus_y, sel), dpm, dt)):
                    err = max([err] + [max_abs_err(a, b) for a, b in zip(
                        I.idct_stream_to_planes(*args),
                        I.idct_stream_to_planes_plain(*args))])
            sync(dev)
            log(f"K3 on a made-up {name} stream, {mcus_x}x{mcus_y} MCUs "
                f"(runs of {run_mcus}): max_abs_err {err} against the plain "
                f"version, all components in one launch and each alone, "
                f"one image and {batch} in one launch")
            if err:
                raise AssertionError(f"K3 differs from its plain version on "
                                     f"a made-up {name} stream")


# the batch of K3's batched launch and the shape of `imagenet_loader.b32`'s
# largest group: 500x375 at 4:2:0 is 32x24 MCUs
K3_BATCH, K3_BATCH_MCUS = 16, (32, 24)


def phase_k3_batch(dev: torch.device, card: str, seed: int) -> dict:
    """K3 at B=16 on the b32 shape, one launch for the sixteen images
    (made-up streams, DC and tables, each image its own), against its
    plain version on the card and against sixteen one-image launches;
    warm and cold beside its byte bound, and its B=1 launch on image 0 of
    the same streams. Returns the K3 entry's keys for the batch."""
    B = K3_BATCH
    mcus_x, mcus_y = K3_BATCH_MCUS
    dpm, comps = STREAM_LAYOUTS["4:2:0"]
    rng = np.random.default_rng(seed)
    units = mcus_x * mcus_y * dpm
    ct = torch.from_numpy(rng.integers(-1024, 1024, B * units * 64)
                          .astype(np.int16)).to(dev)
    dt = torch.from_numpy(rng.integers(-2048, 2048, B * units)
                          .astype(np.int16)).to(dev)
    qt = torch.from_numpy(rng.integers(1, 256, (B, 2, 64))
                          .astype(np.int32)).to(dev)
    geometry = (mcus_x, mcus_y, comps)
    args = (ct, qt, geometry, dpm, dt)
    one = (ct[:units * 64], qt[0], geometry, dpm, dt[:units])
    planes, launches, _ = counted(lambda: I.idct_stream_to_planes(*args))
    images = I.idct_stream_to_planes.images
    singles = [I.idct_stream_to_planes(
        ct[b * units * 64:(b + 1) * units * 64], qt[b], geometry, dpm,
        dt[b * units:(b + 1) * units]) for b in range(B)]
    err_single = max(max_abs_err(p[b], s[k]) for b, s in enumerate(singles)
                     for k, p in enumerate(planes))
    log(f"K3 at B={B}: {launches['idct_stream_to_planes']} launch(es) for "
        f"{images} images; max_abs_err {err_single} against {B} one-image "
        f"launches")
    if launches["idct_stream_to_planes"] != 1 or err_single:
        raise AssertionError("K3's batched launch must be one launch equal "
                             "to the one-image launches")
    _, timing = measure(
        dev, card, f"K3 idct_stream_to_planes at B={B}, {mcus_x}x{mcus_y} "
        f"MCUs 4:2:0 per image",
        lambda: I.idct_stream_to_planes(*args),
        lambda: I.idct_stream_to_planes_plain(*args),
        lambda got, ref: max(max_abs_err(a, b) for a, b in zip(got, ref)))
    _, timing1 = measure(
        dev, card, f"K3 idct_stream_to_planes at B=1 on image 0 of the same "
        f"streams", lambda: I.idct_stream_to_planes(*one),
        lambda: I.idct_stream_to_planes_plain(*one),
        lambda got, ref: max(max_abs_err(a, b) for a, b in zip(got, ref)))
    pixels = sum(p.numel() for p in planes)
    b_ms, b_by = bound(pixels * 2 + pixels // 64 * 2
                       + B * 64 * 4 * len(comps) + pixels,
                       pixels * K3_OPS_PER_PIXEL)
    per_image = {k: timing[k] / B for k in ("ms_warm_l2", "ms_cold_l2")}
    log(f"  K3 at B={B}: {pixels * 2 / 1e6:.2f} MB in, {pixels / 1e6:.2f} MB "
        f"out, bound {b_ms:.4f} ms by {b_by} ({b_ms / B:.5f} per image); "
        f"per image warm {per_image['ms_warm_l2']:.5f} ms, cold "
        f"{per_image['ms_cold_l2']:.5f} ms; B=1 warm "
        f"{timing1['ms_warm_l2']:.5f} ms, cold {timing1['ms_cold_l2']:.5f} "
        f"ms  [{card}]")
    return dict(batch16_ms_warm_l2=timing["ms_warm_l2"],
                batch16_ms_cold_l2=timing["ms_cold_l2"],
                batch16_call_ms=timing["call_ms"],
                batch16_plain_ms=timing["plain_ms"],
                batch16_bound_ms=b_ms, batch16_bound_by=b_by,
                batch16_one_image_ms_warm_l2=timing1["ms_warm_l2"],
                batch16_one_image_ms_cold_l2=timing1["ms_cold_l2"])


def phase_sharded_small_streams(dev: torch.device, seed: int) -> None:
    """The small streams through `decode_sharded` on meshes of 2 and 4
    shards on the card, where every scan has that many subsequences: ==
    golden."""
    for name, data in small_streams(seed):
        expect = golden.decode(data)
        scans = T.parse(data).scans
        for D in (2, 4):
            if min(sc.num_subsequences for sc in scans) < D:
                log(f"small stream {name}: a scan has fewer than {D} "
                    f"subsequences, not sharded {D} ways")
                continue
            check_equal_numpy(f"{name} sharded {D} ways",
                              SEG.decode_sharded(data, make_mesh([dev] * D)),
                              expect)
            kinds = ["segments" if sc.num_segments >= D else "subsequences"
                     for sc in scans]
            log(f"small stream {name}: decode_sharded over {D} shards on "
                f"{dev.type} ({', '.join(kinds)}) == golden")


def sharded_kernels(dev: torch.device, data: bytes, card: str, mesh):
    """K9 at the 12 MP chunk shapes: the sharded path's de-interleaved
    coefficient chunks (its decode with `with_idct=False`, planes left on
    the device), held against its plain version; returns K9's entry without
    launch counts."""
    plan = pipeline.build_plan(T.parse(data))
    st, = SEG.stage_sharded(data, mesh, plan)
    frame_mb = (st.padded_total + st.shp.shard_positions) * 2e-6
    log(f"sharded 12 MP: {st.granularity} granularity, {mesh.size} shards "
        f"on {dev}, segment bounds {st.shp.bounds}, lanes {st.shp.cfg.lanes} "
        f"per shard ({[sh['n_subseq'] for sh in st.shards]} subsequences), "
        f"{st.rows} MCU rows per chunk, frames of {frame_mb:.1f} MB")
    blocks = SEG.decode_staged([st], with_idct=False)
    qtables = st.shards[0]["qtables"]
    tables = [qtables[comp[6]] for comp in st.sp.comps]
    # one shard's chunk: all its planes in one launch, as the path runs it
    by_shard = [[blocks[comp[0]][d] for comp in st.sp.comps]
                for d in range(mesh.size)]
    err = max(max_abs_err(a, b) for chunk in by_shard[1:] for a, b in zip(
        I.dequant_idct_planes(chunk, tables),
        I.dequant_idct_planes_plain(chunk, tables)))
    planes = by_shard[0]
    _, timing = measure(
        dev, card, f"K9 dequant_idct_planes, one shard's {len(planes)} "
        f"planes in one launch "
        f"({', '.join(str(tuple(p.shape)) for p in planes)}, "
        f"{sum(p.numel() for p in planes) // 64} blocks)",
        lambda: I.dequant_idct_planes(planes, tables),
        lambda: I.dequant_idct_planes_plain(planes, tables),
        lambda got, ref: max(max_abs_err(a, b) for a, b in zip(got, ref)))
    if err:
        raise AssertionError("K9 differs from its plain version on a later "
                             "shard's chunk")
    pixels = sum(p.numel() for p in planes)
    b_ms, b_by = bound(2 * pixels + 64 * 4 * len(planes) + pixels,
                       pixels * K9_OPS_PER_PIXEL)
    log(f"  K9 one launch: {2 * pixels / 1e6:.2f} MB in, {pixels / 1e6:.2f} "
        f"MB out, bound {b_ms:.4f} ms by {b_by}, "
        f"{pixels * K9_OPS_PER_PIXEL / INT_OPS_PER_S * 1e3:.4f} ms by "
        f"operations; the other shards' chunks == plain too  [{card}]")
    entry = dict(
        name="dequant_idct_planes", route="cuda",
        source="jpeggpu_tpu_torch/kernels/csrc/idct_blocks.cu",
        replaces="jpeggpu_tpu/ops/idct_pallas.py:231", bound_ms=b_ms,
        bound_by=b_by, shapes=[list(p.shape) for p in planes], **timing)
    # each plane alone, one launch each (as the path launched it before)
    for comp, plane, q in zip(st.sp.comps, planes, tables):
        _, timing = measure(
            dev, card, f"K9 dequant_idct_plane (one plane alone) component "
            f"{comp[0]} {tuple(plane.shape)} ({plane.numel() // 64} blocks)",
            lambda: I.dequant_idct_plane(plane, q),
            lambda: I.dequant_idct_plane_plain(plane, q), max_abs_err)
        b1, _ = bound(3 * plane.numel() + 64 * 4,
                      plane.numel() * K9_OPS_PER_PIXEL)
        entry[f"component{comp[0]}_alone"] = dict(
            shape=list(plane.shape), bound_ms=b1, **timing)
    return entry


def phase_sharded_path(dev: torch.device, data: bytes, card: str, mesh,
                       expect):
    """`decode_sharded` at 12 MP over the mesh (segment granularity: the
    scan has 189 restart segments), counted; then the subsequence
    granularity on the same image, whose seams fall inside segments."""
    planes, launches, by_slot = counted(
        lambda: SEG.decode_sharded(data, mesh))
    log(f"sharded path launches ({mesh.size} shards): {launches} (K1 = the "
        f"shards' sync rounds, summed), components K3 covered by slot "
        f"{by_slot}")
    if not (launches["dequant_idct_planes"] == mesh.size
            and launches["decode_write"] == mesh.size
            and launches["subseq_pass"] >= 2 * mesh.size
            and launches["idct_stream_to_planes"] == 0
            and not any(launches[k] for k in ("decode_write_emit",)
                        + SUPER_KERNELS + LANE_KERNELS + TIER_KERNELS)):
        raise AssertionError(f"the sharded path must launch K1, K2 once per "
                             f"shard and K9 once per shard, "
                             f"and no other kernel: {launches}")
    check_equal_numpy("12 MP decode_sharded vs golden", planes, expect)
    log(f"12 MP decode_sharded over {mesh.size} shards on the card == golden "
        f"== default path")

    plan = pipeline.build_plan(T.parse(data))
    st = SEG._stage(data, plan, 0, mesh, "subsequences")
    blocks, slaunches, _ = counted(lambda: SEG.decode_scan_staged(st))
    got = SEG.assemble(plan, {c[0]: b for c, b in zip(st.sp.comps, blocks)})
    log(f"subsequence granularity at 12 MP: subsequence bounds "
        f"{st.shp.bounds}, lanes {st.shp.cfg.lanes} per shard, "
        f"{st.outer_rounds} outer round(s), launches {slaunches}")
    if slaunches["dequant_idct_planes"] != mesh.size:
        raise AssertionError("the subsequence granularity must launch K9 "
                             "once per shard")
    check_equal_numpy("12 MP subsequence granularity vs golden", got, expect)
    log("12 MP subsequence-granular sharded decode == golden")
    return launches, by_slot


def phase_sharded_times(dev: torch.device, data: bytes, card: str, mesh):
    """The sharded and the unsharded decode of the same image, 15 turns
    taken in rotation, from staged inputs (planes left on the device) and
    with host staging; the sharded decode's peak device memory and its
    device busy share. Returns K9's per-launch times inside the decode."""
    stream = T.parse(data)
    mp = stream.size_x * stream.size_y / 1e6
    plan = pipeline.build_plan(stream)
    staged = SEG.stage_sharded(data, mesh, plan)
    dec = T.Decoder(device=dev)
    dec.parse_header(data)
    dec.transfer()
    runs = {
        "sharded, from staged inputs": lambda: SEG.decode_staged(staged),
        "unsharded, from staged inputs":
            lambda: dec.decode(device=True),
        "sharded, with host staging": lambda: SEG.decode_sharded(data, mesh),
        "unsharded, with host staging": lambda: T.decode(data, device=dev),
    }
    for fn in runs.values():
        fn()
    sync(dev)
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    runs["sharded, from staged inputs"]()
    sync(dev)
    log(f"sharded decode: peak device memory "
        f"{(torch.cuda.max_memory_allocated(dev) - held) / 1e6:.1f} MB above "
        f"the staged inputs (both paths') of {held / 1e6:.1f} MB")
    turns = {label: [] for label in runs}
    for _ in range(15):
        for label, fn in runs.items():
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            turns[label].append((time.perf_counter() - t0) * 1e3)
    med = {}
    for label, ms in turns.items():
        ms = sorted(ms)
        med[label] = ms[7]
        log(f"{label}: 15 turns with the other three: median {ms[7]:.2f} ms "
            f"= {mp / ms[7] * 1e3:.0f} MP/s, quartiles {ms[3]:.2f} - "
            f"{ms[11]:.2f} ms  [{card}]")
    times = profile_decode(
        dev, card, "sharded path", lambda: SEG.decode_staged(staged),
        med["sharded, from staged inputs"],
        ("::subseq_pass_kernel", "::decode_write_kernel",
         "::dequant_idct_planes_kernel"))
    dec.cleanup()
    return times.get("::dequant_idct_planes_kernel", [])


# --- the batched decode (parallel/batch.py) ---------------------------------

def phase_batch_small_streams(dev: torch.device, seed: int) -> None:
    """The whole matrix of small streams as one `decode_batch` on the card,
    grouped as the batch groups them: == golden, pixels and (with
    `with_idct=False`) coefficient planes."""
    streams = small_streams(seed)
    datas = [d for _, d in streams]
    dec = BatchDecoder(device=dev)
    for with_idct in (True, False):
        dec.with_idct = with_idct
        out = dec.decode(datas)
        for (name, data), planes in zip(streams, out):
            comps = T.parse(data).components
            # golden's coefficient planes are padded to whole MCUs
            expect = [g[:c.size_y, :c.size_x] for g, c in zip(
                golden.decode(data, with_idct=with_idct), comps)]
            check_equal_numpy(f"{name} in the batch (with_idct={with_idct})",
                              planes, expect)
        merged = [[streams[i][0] for i in images]
                  for route, images in dec.routes if route == "merged"]
        log(f"small streams: {len(streams)} in one decode_batch on "
            f"{dev.type} (with_idct={with_idct}) == golden; "
            f"{len(dec.routes)} decodes, merged groups {merged}, the others "
            f"one by one")


def batch_images(seed: int, quality: int, n: int, first=None):
    """`n` distinct 12 MP images at `quality`, seeds seed .. seed+n-1
    (`first`, if given, is the image of `seed`)."""
    return [first if i == 0 and first is not None
            else make_image(seed + i, quality)[1] for i in range(n)]


def batch_group(datas, dev):
    """The one group of a batch of images of one geometry: its padded
    plan's signature and its images' host inputs, as `BatchDecoder` makes
    them (under the process default tuning)."""
    groups = BatchDecoder(device=dev)._groups(datas)
    if len(groups) != 1:
        raise AssertionError(f"the batch formed {len(groups)} groups")
    return groups[0].plan.signature, groups[0].inputs


def merged_entropy_held(dev, label: str, sp, ms, B: int):
    """K1's shifted round and K2 at the width of a merged decode of `B`
    images (`ms`, staged by `stage_merged`), each against its plain version
    on the same CUDA tensors. Returns (cfg, arrs, ctx, the K2 stream, the
    errors by wrapper)."""
    cfg = dataclasses.replace(sp.cfg, lanes=B * sp.cfg.lanes)
    arrs = ms.arrs
    ctx = H.make_ctx(cfg, arrs)
    valid = ctx.lane_valid
    blind = H.subseq_pass(cfg, arrs, ctx, None, None, None, valid)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    got = H.subseq_pass(cfg, arrs, ctx, *blind[:3], valid, flag=flag)
    ref_flag = torch.zeros_like(flag)
    ref = H.subseq_pass_plain(cfg, arrs, ctx, *blind[:3], valid,
                              flag=ref_flag)
    errs = {"subseq_pass": max(max(max_abs_err(a, b) for a, b in zip(
        got, ref)), max_abs_err(flag, ref_flag))}
    p, c, z, n = H.sync_states(cfg, arrs, ctx)
    n_off = H.symbol_offsets(cfg, arrs, n)
    keywords = dict(pos_base=ms.pos_base, bound=ms.pos_bound,
                    total_out=B * sp.cfg.total_positions)
    coeffs = H.decode_write(cfg, arrs, ctx, p, c, z, n_off, **keywords)
    errs["decode_write"] = max_abs_err(coeffs, H.decode_write_plain(
        cfg, arrs, ctx, p, c, z, n_off, **keywords))
    log(f"{label}: K1 shifted round at {cfg.lanes} lanes ({int(valid.sum())} "
        f"valid), max_abs_err {errs['subseq_pass']} (states and flag); K2 on "
        f"the merged stream ({B} x {sp.cfg.total_positions} positions, "
        f"{nbytes(coeffs) / 1e6:.1f} MB), max_abs_err {errs['decode_write']}; "
        f"against their plain versions")
    if any(errs.values()):
        raise AssertionError(f"{label}: K1 or K2 differs from its plain "
                             f"version at merged width: {errs}")
    return cfg, arrs, ctx, coeffs, errs


def merged_records_held(dev, label: str, datas):
    """K4 and the records path's tile kernels (K5 and K6 in the supertile
    shape, K7 and K8 in the per-lane shape, as the process default tuning
    resolves the group's plan) at the merged width of `datas`, each fed by
    the real stage before it and held against its plain version on the
    same CUDA tensors. Returns the errors by wrapper."""
    B = len(datas)
    sig, inputs = batch_group(datas, dev)
    sp, = sig.scans
    (ms,), _ = BT.stage_merged(sig, inputs, dev)
    cfg = dataclasses.replace(sp.cfg, lanes=B * sp.cfg.lanes)
    arrs = ms.arrs
    ctx = H.make_ctx(cfg, arrs)
    p, c, z, n = H.sync_states(cfg, arrs, ctx)
    states = (p, c, z, H.symbol_offsets(cfg, arrs, n))
    total = B * sp.cfg.total_positions
    keywords = dict(pos_base=ms.pos_base, bound=ms.pos_bound,
                    total_out=total)
    rec, m = H.decode_write_emit(cfg, arrs, ctx, *states, **keywords)
    errs = {"decode_write_emit": k4_error((rec, m), H.decode_write_emit_plain(
        cfg, arrs, ctx, *states, **keywords))}
    pos0 = (ms.pos_base + states[3]).to(torch.int32)
    shape = W.resolve_tile_mode(cfg.tuning.tile_mode, cfg.tile_auto)
    if shape == "super":
        (val_rows, pk_rows, mmax_st, base, q, leftover, n_groups,
         win) = W.supertile_records(rec, m, pos0 >> 6, pos0, total,
                                    cfg.super_g, cfg.super_w,
                                    cfg.tuning.s_trim, cfg.group_du,
                                    cfg.super_d)
        k5 = (val_rows, pk_rows, mmax_st, cfg.super_g, cfg.super_d)
        stiles = W.supertiles_from_records(*k5)
        errs["supertiles_from_records"] = max_abs_err(
            stiles, W.supertiles_from_records_plain(*k5))
        k6 = (stiles, base, q, n_groups, win, cfg.group_du)
        got, ref = W.expand_supertiles(*k6), W.expand_supertiles_plain(*k6)
        errs["expand_supertiles"] = max(max_abs_err(got[0], ref[0]),
                                        max_abs_err(got[1], ref[1]))
        what = (f"{tuple(stiles.shape)} supertiles = "
                f"{nbytes(stiles) / 1e6:.1f} MB")
    else:
        val, wpos, du0, q, leftover, n_groups, max_du = W.lane_records(
            rec, m, pos0 >> 6, pos0, total, cfg.tile_d)
        reach = torch.where(leftover, -1, max_du)
        k7 = (val, wpos, m, du0, ~leftover, cfg.tile_d)
        tiles = W.tiles_from_records(*k7)
        errs["tiles_from_records"] = max_abs_err(
            tiles, W.tiles_from_records_plain(*k7))
        errs["expand_tiles"] = max(
            max_abs_err(W.expand_tiles(tiles, du0, q, n_groups, reach),
                        W.expand_tiles_plain(tiles, du0, q, n_groups, reach)),
            max_abs_err(W.expand_tiles(tiles, du0, q, n_groups),
                        W.expand_tiles_plain(tiles, du0, q, n_groups)))
        what = (f"{tuple(tiles.shape)} tiles = {nbytes(tiles) / 1e6:.1f} MB, "
                f"K8 with and without reach")
    log(f"{label}: {shape} shape at {cfg.lanes} lanes, K4 buffer "
        f"{tuple(rec.shape)} = {nbytes(rec) / 1e6:.1f} MB, {int(m.sum())} "
        f"records, {int(leftover.sum())} leftover lane(s), {what}: "
        f"max_abs_err {errs} against the plain versions")
    if any(errs.values()):
        raise AssertionError(f"{label}: a records kernel differs from its "
                             f"plain version at merged width: {errs}")
    return errs


def worst(*errs_by_wrapper):
    """The largest error of each wrapper over several holdings."""
    out = {}
    for errs in errs_by_wrapper:
        for name, err in errs.items():
            out[name] = max(out.get(name, 0), err)
    return out


def phase_batch_kernels(dev: torch.device, card: str, datas):
    """K1, K2 and K3 at the batch path's shapes: K1's shifted round at the
    merged width, K2 on the whole merged stream and K3 on the last image's
    slice of it (a view at its offset), each against its plain version on
    the same CUDA tensors; the int32 reckoning at this width; the merged
    sync's rounds against each image's own. Returns the staged merged
    inputs, the merged stream, its symbol count, the merged rounds and the
    errors by wrapper."""
    B = len(datas)
    sig, inputs = batch_group(datas, dev)
    sp, = sig.scans
    L, Tpos = sp.cfg.lanes, sp.cfg.total_positions
    scans, qtables = BT.stage_merged(sig, inputs, dev)
    ms, = scans
    own = [pipeline.build_plan(T.parse(d)).signature.scans[0].cfg.lanes
           for d in datas]
    log(f"batch of {B}: lanes per image {own}, padded to {L} each, merged "
        f"width {B * L} lanes")
    cfg, arrs, ctx, coeffs, errs = merged_entropy_held(
        dev, f"batch of {B}", sp, ms, B)

    _, rounds, _ = counted(lambda: H.sync_states(cfg, arrs, ctx))
    rounds = rounds["subseq_pass"]
    singles = []
    for d in datas:
        plan = pipeline.build_plan(T.parse(d))
        a = pipeline.stage_inputs(pipeline.build_inputs(d, plan), plan,
                                  dev)["scans"][0]
        c1 = plan.signature.scans[0].cfg
        _, r, _ = counted(lambda: H.sync_states(c1, a, H.make_ctx(c1, a)))
        singles.append(r["subseq_pass"])
    log(f"sync rounds (K1 launches, the blind one included): merged "
        f"{rounds}; each image alone {singles}, max {max(singles)}, sum "
        f"{sum(singles)}")
    if rounds != max(singles):
        raise AssertionError("the merged sync must take as many rounds as "
                             "its slowest image")

    symbols = count_symbols(coeffs)
    log(f"the merged stream holds {symbols} symbols")

    b = B - 1
    cb = coeffs[b * Tpos:(b + 1) * Tpos]
    comp_slots = tuple((k[1], k[2] * k[3]) for k in sp.comps)
    dcv = DC.undelta_dc_values(sp.cfg, comp_slots, cb)
    k3_args = (cb, qtables[b], sp.idct_geometry, sp.cfg.du_per_mcu, dcv)
    err = max(max_abs_err(x, y) for x, y in zip(
        I.idct_stream_to_planes(*k3_args),
        I.idct_stream_to_planes_plain(*k3_args)))
    offset = cb.data_ptr() - coeffs.data_ptr()
    log(f"K3 on image {b}'s slice of the merged stream (a view {offset} "
        f"bytes in, address % 16 = {cb.data_ptr() % 16}): max_abs_err {err} "
        f"against its plain version")
    if err or offset != 2 * b * Tpos:
        raise AssertionError("K3 on a slice differs from its plain version, "
                             "or the slice is not a view at its offset")
    # the group's tail: one DC un-delta and one K3 launch over the whole
    # merged stream, each image with its own tables
    group_dcv = DC.undelta_dc_values(sp.cfg, comp_slots, coeffs, batch=B)
    own_dcv = torch.cat([DC.undelta_dc_values(
        sp.cfg, comp_slots, coeffs[k * Tpos:(k + 1) * Tpos])
        for k in range(B)])
    group_args = (coeffs, qtables, sp.idct_geometry, sp.cfg.du_per_mcu,
                  group_dcv)
    group_err = max([max_abs_err(group_dcv, own_dcv)] + [
        max_abs_err(x, y) for x, y in zip(
            I.idct_stream_to_planes(*group_args),
            I.idct_stream_to_planes_plain(*group_args))])
    log(f"the group's tail on the merged stream ({B} images): the DC "
        f"un-delta against each image's own, K3 in one launch against its "
        f"plain version: max_abs_err {group_err}")
    if group_err:
        raise AssertionError("the group's tail differs from the images' own "
                             "or from K3's plain version")
    errs["idct_stream_to_planes"] = max(err, group_err)

    s_cap = H._emit_cap(sp.cfg.tuning.write_chunk)
    for what, value in (
            ("bit offsets (lanes x 1024)", B * L * C.SUBSEQ_SIZE_BITS),
            ("output positions (B x T)", B * Tpos),
            ("K4's record slots (s_cap x lanes)", s_cap * B * L),
            ("K7's tile cells at tile_d 128 (128 x 64 x lanes)",
             128 * 64 * B * L)):
        log(f"int32 at merged width: {what} {value} = "
            f"{value / C.I32_MAX:.3f} of 2^31-1"
            + ("" if value <= C.I32_MAX else " (indexed with 64-bit offsets "
               "in the kernel)"))
    return sig, scans, qtables, coeffs, symbols, rounds, errs


def batch_bounds(B, cfg, symbols, words_bytes):
    """K1's bound per round and K2's bound at the merged width, counted as
    `phase_kernels` counts them for one image: K1 reads the words, the
    named slots of the symbol table and 29 bytes per lane (context, start
    states, valid, rel) and writes 16 (four states), 33 operations per
    symbol; K2 reads the words, the table and 33 bytes per lane (context,
    start states, valid, first position, bound) and writes the merged
    stream (B x T int16), 55 operations per symbol."""
    lanes, Tpos = B * cfg.lanes, cfg.total_positions
    named = {s for g in cfg.comp_groups for s in g[1:]}
    table = 2 * len(named) << H.SYMTAB_BITS
    k1 = bound(words_bytes + table + 45 * lanes, symbols * K1_OPS_PER_SYMBOL)
    k2 = bound(words_bytes + table + 33 * lanes + 2 * B * Tpos,
               symbols * K2_OPS_PER_SYMBOL)
    return k1, k2


def kernel_ms(dev, fn, symbol: str):
    """Device times of the launches of the kernel named `symbol` in three
    calls of `fn`, from the profiler (a read back to the host closes the
    window, as in a decode)."""
    def run():
        for _ in range(3):
            fn()
        torch.ones(1, device=dev).sum().item()

    return [e.self_device_time_total / 1e3 for e in profiled(dev, run)
            if symbol in e.name]


def phase_batch_widths(dev: torch.device, card: str, datas) -> None:
    """K1 (a shifted round) and K2 at merged widths of 1, 2, 4 and 8
    images: how each scales with the width, and whether K2 slows down once
    the merged stream outgrows the card's 50 MB L2 (one image's stream is
    36.6 MB). Each wrapper with L2 warm (`time_ms`; K2's includes its zero
    fill of the stream), and each kernel alone in the profiler."""
    for k in (1, 2, 4, len(datas)):
        sig, inputs = batch_group(datas[:k], dev)
        sp, = sig.scans
        scans, _ = BT.stage_merged(sig, inputs, dev)
        ms, = scans
        cfg = dataclasses.replace(sp.cfg, lanes=k * sp.cfg.lanes)
        ctx = H.make_ctx(cfg, ms.arrs)
        p, c, z, n = H.sync_states(cfg, ms.arrs, ctx)
        n_off = H.symbol_offsets(cfg, ms.arrs, n)

        def k1():
            return H.subseq_pass(cfg, ms.arrs, ctx, p, c, z, ctx.lane_valid)

        def k2():
            return H.decode_write(
                cfg, ms.arrs, ctx, p, c, z, n_off, pos_base=ms.pos_base,
                bound=ms.pos_bound, total_out=k * sp.cfg.total_positions)

        k1_warm, _ = time_ms(k1, dev, launches=5, reps=3)
        k2_warm, _ = time_ms(k2, dev, launches=3, reps=3)
        alone = [statistics.median(t) if t else float("nan") for t in (
            kernel_ms(dev, k1, "subseq_pass_kernel"),
            kernel_ms(dev, k2, "decode_write_kernel"))]
        log(f"merged width {k} image(s), {cfg.lanes} lanes, stream "
            f"{2 * k * sp.cfg.total_positions / 1e6:.1f} MB: K1 round warm "
            f"{k1_warm:.4f} ms ({k1_warm / k:.4f} per image), alone "
            f"{alone[0]:.4f}; K2 with its fill warm {k2_warm:.4f} ms "
            f"({k2_warm / k:.4f} per image), alone {alone[1]:.4f} "
            f"({alone[1] / k:.4f} per image)  [{card}]")


def phase_batch_path(dev: torch.device, card: str, datas, merged_state):
    """The batch path: `BatchDecoder(device=dev).decode` of the full-width
    batch, counted, == each image's own decode; then its times against
    single decodes of the same images in turns, its device busy share, its
    kernels inside the decode, its peak memory and its host stages."""
    B = len(datas)
    sig, scans, qtables, coeffs, symbols, rounds, _ = merged_state
    sp, = sig.scans
    L, Tpos = sp.cfg.lanes, sp.cfg.total_positions
    singles = [T.decode(d, device=dev) for d in datas]
    dec = BatchDecoder(device=dev)
    out, launches, by_slot = counted(lambda: dec.decode(datas))
    log(f"batch path launches: {launches}, components K3 covered by first "
        f"slot: {by_slot}; routes {dec.routes}")
    if not (dec.routes == [("merged", tuple(range(B)))]
            and launches["subseq_pass"] == rounds
            and launches["decode_write"] == 1
            and launches["idct_stream_to_planes"] == 1
            and I.idct_stream_to_planes.images == B
            and len(by_slot) == len(sp.comps)
            and all(v == 1 for v in by_slot.values())
            and not any(launches[k] for k in ("decode_write_emit",)
                        + SUPER_KERNELS + LANE_KERNELS + SHARDED_KERNELS
                        + TIER_KERNELS)):
        raise AssertionError(f"the batch must be one merged group launching "
                             f"K1 once per merged round ({rounds}), K2 once "
                             f"and K3 once for its {B} images, and no other "
                             f"kernel: {dec.routes} {launches} {by_slot}")
    stream = T.parse(datas[0])
    mp = stream.size_x * stream.size_y / 1e6
    for i, (got, expect) in enumerate(zip(out, singles)):
        check_equal_numpy(f"batch image {i} vs its own decode", got, expect)
    log(f"batch of {B} x {mp:.1f} MP on the merged route == each image's own "
        f"decode (held against golden and the plain path above)")

    def med(fn, reps=5):
        return host_ms(fn, dev, reps)

    stages = {}
    stages["parse + plans"], prelim = med(
        lambda: [pipeline.build_plan(T.parse(d)) for d in datas])
    stages["re-plan with pad_scans"], plans = med(
        lambda: [pipeline.build_plan(p.stream, pad_scans=pipeline.group_pad(
            prelim)) for p in prelim])
    stages["build_inputs"], inputs = med(
        lambda: [pipeline.build_inputs(d, p) for d, p in zip(datas, plans)])
    stages["merge_region"], merged = med(
        lambda: BT.merge_region(sp, [i["scans"][0] for i in inputs]))
    stages["copy in"], _ = med(lambda: (
        convert.device_arrays(merged.arrays(), dev, sp.cfg.fast_tables,
                              merged),
        torch.from_numpy(np.stack([i["qtables"] for i in inputs])).to(dev)))
    for name, ms in stages.items():
        log(f"batch stage {name}: {ms:.3f} ms for {B} images  [{card}]")

    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    BT.decode_merged(sig, scans, qtables)
    sync(dev)
    log(f"batch path: peak device memory of a decode of {B} from staged "
        f"inputs {(torch.cuda.max_memory_allocated(dev) - held) / 1e6:.1f} "
        f"MB above the {held / 1e6:.1f} MB held (the staged merged inputs "
        f"and this script's tensors)")

    decoders = []
    for d in datas:
        one = T.Decoder(device=dev)
        one.parse_header(d)
        one.transfer()
        decoders.append(one)
    runs = {
        "batch, from staged merged inputs":
            lambda: BT.decode_merged(sig, scans, qtables),
        "single decodes, from staged inputs":
            lambda: [one.decode(device=True) for one in decoders],
        "batch, with host staging": lambda: BatchDecoder(
            device=dev).decode(datas),
        "single decodes, with host staging":
            lambda: [T.decode(d, device=dev) for d in datas],
    }
    for fn in runs.values():
        fn()
    turns = {label: [] for label in runs}
    for _ in range(9):
        for label, fn in runs.items():
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            turns[label].append((time.perf_counter() - t0) * 1e3)
    med_ms = {}
    for label, ms in turns.items():
        ms = sorted(ms)
        med_ms[label] = ms[4]
        log(f"{label} of {B} x {mp:.1f} MP: 9 turns with the other three: "
            f"median {ms[4]:.2f} ms = {ms[4] / B:.3f} ms per image = "
            f"{B * mp / ms[4] * 1e3:.0f} MP/s, quartiles {ms[2]:.2f} - "
            f"{ms[6]:.2f} ms  [{card}]")
    for one in decoders:
        one.cleanup()

    times = profile_decode(
        dev, card, f"batch path ({B} images)",
        lambda: BT.decode_merged(sig, scans, qtables),
        med_ms["batch, from staged merged inputs"],
        ("::subseq_pass_kernel", "::decode_write_kernel",
         "::idct_stream_to_planes_kernel"))
    (k1_b, k1_by), (k2_b, k2_by) = batch_bounds(
        B, sp.cfg, symbols, nbytes(scans[0].arrs.words))
    k1_ms = times.get("::subseq_pass_kernel", [])
    k2_ms = times.get("::decode_write_kernel", [])
    if k1_ms:
        log(f"K1 in the batch decode: {len(k1_ms)} rounds, median "
            f"{statistics.median(k1_ms):.4f} ms per round at {B * L} lanes, "
            f"bound {k1_b:.4f} ms by {k1_by} ({symbols} symbols x "
            f"{K1_OPS_PER_SYMBOL})  [{card}]")
    if k2_ms:
        log(f"K2 in the batch decode: {k2_ms[0]:.4f} ms, bound {k2_b:.4f} ms "
            f"by {k2_by} ({2 * B * Tpos / 1e6:.1f} MB written)  [{card}]")
    return (launches, by_slot, times, dict(bound_ms_batch=k1_b,
                                           bound_by_batch=k1_by),
            dict(bound_ms_batch=k2_b, bound_by_batch=k2_by))


def phase_batch_routes(dev: torch.device, card: str, datas, sparse,
                       fused_coeffs):
    """The batch under `set_default_tuning(Tuning(write_mode="tiles"))`:
    the full-width batch with the supertile shape (its merged records
    stream and DC vector held against the merged K2 stream) and the sparse
    batch with the per-lane shape, counted; the mesh route on two entries
    of the one card; `with_idct=False`. Returns the launch counts of
    the two records batches and the errors of each kernel held against its
    plain version at these routes' shapes (K4-K6 on the dense batch, K4,
    K7 and K8 on the sparse one, K1 and K2 at each mesh entry's width)."""
    B = len(datas)
    singles = [T.decode(d, device=dev) for d in datas]
    sparse_singles = [T.decode(d, device=dev) for d in sparse]
    base_tuning = T.default_tuning()
    T.set_default_tuning(AUTO)
    try:
        dec = BatchDecoder(device=dev)
        out, tl, tby = counted(lambda: dec.decode(datas))
        log(f"batch records path (supertile shape) launches: {tl}, routes "
            f"{dec.routes}; {W.scatter_leftover.lanes} leftover lane(s)")
        if not (dec.routes == [("merged", tuple(range(B)))]
                and tl["subseq_pass"] >= 2 and tl["decode_write"] == 0
                and all(tl[k] == 1 for k in ("decode_write_emit",)
                        + SUPER_KERNELS)
                and tl["idct_stream_to_planes"] == 1
                and not any(tl[k] for k in LANE_KERNELS + SHARDED_KERNELS
                        + TIER_KERNELS)):
            raise AssertionError(f"the dense batch's records path must "
                                 f"launch K4, K5, K6 and K3 once: {tl}")
        for i, (got, expect) in enumerate(zip(out, singles)):
            check_equal_numpy(f"records batch image {i}", got, expect)
        sig, inputs = batch_group(datas, dev)
        sp, = sig.scans
        scans, _ = BT.stage_merged(sig, inputs, dev)
        tcoeffs, tdc = BT._merged_scan_coeffs(sp, scans[0], B)
        err = max(max_abs_err(tcoeffs, fused_coeffs),
                  max_abs_err(tdc[:B * sp.cfg.total_positions // 64],
                              fused_coeffs[::64].contiguous()))
        log(f"merged records stream and DC vector ({B * sp.cfg.lanes} "
            f"lanes): max_abs_err {err} against the merged K2 stream")
        if err:
            raise AssertionError("the merged records stream differs from "
                                 "K2's")
        dense_errs = merged_records_held(dev, f"records batch of {B}", datas)

        dec = BatchDecoder(device=dev)
        out, ll, lby = counted(lambda: dec.decode(sparse))
        sig, _ = batch_group(sparse, dev)
        cfg = sig.scans[0].cfg
        log(f"sparse batch of {len(sparse)} (quality {QUALITY_SPARSE}, "
            f"tile_auto {cfg.tile_auto}, tile_d {cfg.tile_d}, "
            f"{len(sparse) * cfg.lanes} lanes: tiles "
            f"{128 * cfg.tile_d * len(sparse) * cfg.lanes / 1e6:.0f} MB) "
            f"launches: {ll}, routes {dec.routes}; "
            f"{W.scatter_leftover.lanes} leftover lane(s)")
        if not (dec.routes == [("merged", tuple(range(len(sparse))))]
                and all(ll[k] == 1 for k in ("decode_write_emit",)
                        + LANE_KERNELS)
                and ll["idct_stream_to_planes"] == 1
                and not any(ll[k] for k in ("decode_write",) + SUPER_KERNELS
                            + SHARDED_KERNELS + TIER_KERNELS)):
            raise AssertionError(f"the sparse batch must launch K4, K7, K8 "
                                 f"and K3 once: {ll}")
        for i, (got, expect) in enumerate(zip(out, sparse_singles)):
            check_equal_numpy(f"sparse batch image {i}", got, expect)
        sparse_errs = merged_records_held(
            dev, f"sparse batch of {len(sparse)}", sparse)
    finally:
        T.set_default_tuning(base_tuning)
    log(f"records path batches (supertile shape on {B} images, per-lane "
        f"shape on {len(sparse)}) == each image's own decode")

    dec = BatchDecoder(mesh=make_mesh([dev] * 2))
    out, ml, _ = counted(lambda: dec.decode(datas[:3]))
    log(f"mesh of 2 entries of the card, 3 images: routes {dec.routes}, "
        f"launches {ml}")
    if not (dec.routes == [("mesh_merged", (0, 1)), ("mesh_merged", (2, 2))]
            and ml["decode_write"] == 2
            and ml["idct_stream_to_planes"] == 2):
        raise AssertionError(f"the mesh route must pad 3 images to 4 and "
                             f"decode 2 per entry: {dec.routes} {ml}")
    for i, (got, expect) in enumerate(zip(out, singles)):
        check_equal_numpy(f"mesh batch image {i}", got, expect)
    sig, inputs = batch_group(datas[:3], dev)
    sp, = sig.scans
    mesh_errs = []
    for entry in ((0, 1), (2, 2)):
        (ms,), _ = BT.stage_merged(sig, [inputs[i] for i in entry], dev)
        mesh_errs.append(merged_entropy_held(
            dev, f"mesh entry of images {entry}", sp, ms, len(entry))[4])

    coeff_planes = decode_batch(datas[:2], with_idct=False, device=dev)
    for i, (got, d) in enumerate(zip(coeff_planes, datas)):
        with T.Decoder(device=dev) as one:
            one.parse_header(d)
            check_equal_numpy(f"with_idct=False batch image {i}", got,
                              one.decode(with_idct=False))
    log("mesh route == each image's own decode; decode_batch(with_idct="
        "False) == Decoder.decode(with_idct=False), int16 planes "
        + ", ".join(str(p.shape) for p in coeff_planes[0]))
    return tl, tby, ll, lby, worst(dense_errs, sparse_errs, *mesh_errs)


# --- the compacted sync tiers and the multi-process batch --------------------

CLASSIC_T = T.Tuning(sync_tiers="classic")
LADDER_T = T.Tuning(sync_tiers="ladder")
# widths small enough that the small streams' few lanes reach compacted
# rounds
TINY_TIERS = {"classic": T.Tuning(sync_tiers="classic", frontier_width=4,
                                  head_width=2, tail_width=1),
              "ladder": T.Tuning(sync_tiers="ladder", frontier_width=32)}


def phase_sync_tiers_small_streams(dev: torch.device, seed: int) -> None:
    """Every small stream decoded on the card under both tier shapes at
    tiny widths (`TINY_TIERS`) == golden; K1's gathered mode must run."""
    streams = small_streams(seed)
    expect = [golden.decode(d) for _, d in streams]
    for shape, tun in TINY_TIERS.items():
        gathered = 0
        for (name, data), want in zip(streams, expect):
            plan = pipeline.build_plan(T.parse(data), tuning=tun)
            planes, counts, _ = counted(lambda: pipeline.decode_jpeg_device(
                data, device=dev, plan=plan))
            check_equal_numpy(f"{name} under the {shape} tiers", planes, want)
            gathered += counts["subseq_pass_at"]
        log(f"small streams: all {len(streams)} under the {shape} tiers "
            f"(frontier_width {tun.frontier_width}) on {dev.type} == golden; "
            f"{gathered} launches of K1's gathered mode")
        if not gathered:
            raise AssertionError(f"the {shape} tiers never compacted a round "
                                 f"on the small streams")


def pass_symbols(cfg, arrs, ctx, idx, sp, sc, sz, active) -> int:
    """Symbols that K1's gathered mode decodes on these inputs (its plain
    version's loop, counting commits): the work its bound counts."""
    i = idx.to(torch.int64)
    t = H._plain_operands(arrs, dataclasses.replace(
        ctx, word_end=ctx.word_end[i], seg_base_bits=ctx.seg_base_bits[i],
        end_subseq=ctx.end_subseq[i]))
    p, c, z = (x.to(torch.int64) for x in (sp, sc, sz))
    live = active & (p < t.end_subseq)
    count = torch.zeros((), dtype=torch.int64, device=idx.device)
    # a step with no live column changes nothing: read `live` back once
    # every 32 steps
    while bool(live.any()):
        for _ in range(32):
            p, c, z, _, _, live = H._symbol_step(cfg, t, p, c, z, live,
                                                 need_value=False)
            count += live.sum()
    return int(count)


def gathered_held(dev, card, label, cfg, arrs, ctx, calls):
    """K1's gathered mode on the inputs of the first launch of the widest
    tier that a tier sync ran: against its plain version, its warm time,
    and its bound (33 operations per symbol of the active columns; bytes:
    the columns' starts, lanes and outputs, each active column's 128-byte
    subsequence and context, the symbol table's named slots). Every
    gathered launch of the sync is timed by `tier_device_ms`."""
    named = {s for g in cfg.comp_groups for s in g[1:]}
    fixed = (2 * len(named) << H.SYMTAB_BITS) + nbytes(
        arrs.maxcode, arrs.vsm, ctx.limits, arrs.huffval)
    width = max(a[0].numel() for a in calls)
    args = next(a for a in calls if a[0].numel() == width)

    def launch():
        return H.subseq_pass_at(cfg, arrs, ctx, *args)

    got = launch()
    t0 = time.perf_counter()
    ref = H.subseq_pass_at_plain(cfg, arrs, ctx, *args)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_abs_err(a, b) for a, b in zip(got, ref))
    ms, call_ms = time_ms(launch, dev)
    active = int(args[4].sum())
    symbols = pass_symbols(cfg, arrs, ctx, *args)
    b_ms, b_by = bound(width * (4 * 4 + 1 + 4 * 4) + active * (128 + 12)
                       + fixed, symbols * K1_OPS_PER_SYMBOL)
    log(f"{label}: K1 gathered mode at width {width} ({active} active, "
        f"{symbols} symbols): max_abs_err {err}, {ms:.4f} ms on the "
        f"device with L2 warm ({call_ms:.4f} ms a single call), plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.5f} ms by {b_by}  [{card}]")
    if err:
        raise AssertionError(f"{label}: K1's gathered mode differs from "
                             f"its plain version at width {width}")
    return dict(width=width, active=active, symbols=symbols,
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def tier_device_ms(dev, fn):
    """Device time of K1's whole rounds, of its gathered launches and of
    all other device work in one run of `fn` (the profiler's): (full-round
    ms, launches, gathered ms, launches, other ms, launches)."""
    events = profiled(dev, fn)
    full = [e.self_device_time_total / 1e3 for e in events
            if "subseq_pass_kernel" in e.name]
    at = [e.self_device_time_total / 1e3 for e in events
          if "subseq_pass_at_kernel" in e.name]
    other = [e.self_device_time_total / 1e3 for e in events
             if "subseq_pass" not in e.name]
    return sum(full), len(full), sum(at), len(at), sum(other), len(other)


def phase_sync_tiers(dev: torch.device, card: str, images):
    """The compacted tiers on the 12 MP images (`images`: (label, data,
    golden planes)), under `Tuning(sync_tiers="classic")` and
    `Tuning(sync_tiers="ladder")` against the default Jacobi: states ==
    the Jacobi's, round counts, K1 launches by mode, host reads, the
    gathered launches held and timed, the device time of both modes; the
    decode under each tier plan counted (K1 whole rounds and gathered,
    K2, K3, nothing else) and == golden; then `sync_states`' host time of
    the three in turns. Returns, by image label, what the `kernels` line
    keeps."""
    report = {}
    for label, data, expect in images:
        plan = pipeline.build_plan(T.parse(data))
        arrs = pipeline.stage_inputs(pipeline.build_inputs(data, plan), plan,
                                     dev)["scans"][0]
        cfg = plan.signature.scans[0].cfg
        ctx = H.make_ctx(cfg, arrs)
        n_comps = len(plan.signature.scans[0].comps)
        jac, jl, _ = counted(lambda: H.sync_states(cfg, arrs, ctx, diag=True))
        log(f"{label}: Jacobi (default tuning): (it0, it) {jac[4:]}, K1 "
            f"launches {jl['subseq_pass']} whole rounds, "
            f"{jl['subseq_pass_at']} gathered, host reads {jac[4] + 1}; "
            f"lanes {cfg.lanes}")
        cfgs = {"jacobi": cfg}
        report[label] = {}
        for shape, tun in (("classic", CLASSIC_T), ("ladder", LADDER_T)):
            tcfg = cfgs[shape] = dataclasses.replace(cfg, tuning=tun)
            record = {"gathered": []}
            out, sl, _ = counted(lambda: H.sync_states(
                tcfg, arrs, ctx, diag=True, record=record))
            calls, rounds = record["gathered"], record["rounds"]
            err = max(max_abs_err(a, b) for a, b in zip(out[:4], jac[:4]))
            reads = sum(v + 1 for v in rounds.values())
            widths = sorted({a[0].numel() for a in calls}, reverse=True)
            log(f"{label}, {shape} tiers: states max_abs_err {err} against "
                f"the Jacobi; (it0, it) {out[4:]}, rounds by tier {rounds}; "
                f"K1 launches {sl['subseq_pass']} whole rounds, "
                f"{sl['subseq_pass_at']} gathered (widths {widths}); host "
                f"reads {reads} (the Jacobi's {jac[4] + 1})")
            if err or not sl["subseq_pass_at"]:
                raise AssertionError(f"{label}, {shape} tiers: states differ "
                                     f"from the Jacobi's, or no compacted "
                                     f"round ran")
            held = gathered_held(dev, card, f"{label}, {shape}", tcfg, arrs,
                                 ctx, calls)
            full_ms, nfull, at_ms, nat, other_ms, nother = tier_device_ms(
                dev, lambda: H.sync_states(tcfg, arrs, ctx))
            log(f"{label}, {shape} tiers: device time in one sync_states: "
                f"{full_ms:.4f} ms in {nfull} whole rounds, {at_ms:.4f} ms in "
                f"{nat} gathered launches, {other_ms:.4f} ms in {nother} "
                f"other launches and copies (the rounds' bookkeeping, and "
                f"the window's one-element warm-up)  [{card}]")
            tplan = pipeline.build_plan(T.parse(data), tuning=tun)
            planes, dl, dby = counted(lambda: pipeline.decode_jpeg_device(
                data, device=dev, plan=tplan))
            check_equal_numpy(f"{label} decode under the {shape} tiers",
                              planes, expect)
            if not (dl["subseq_pass_at"] == sl["subseq_pass_at"]
                    and dl["subseq_pass"] == sl["subseq_pass"]
                    and dl["decode_write"] == 1
                    and k3_once(dl, dby, n_comps)
                    and not any(dl[k] for k in ("decode_write_emit",)
                                + SUPER_KERNELS + LANE_KERNELS
                                + SHARDED_KERNELS)):
                raise AssertionError(f"{label}: the decode under the {shape} "
                                     f"tiers must launch K1 as its "
                                     f"sync_states does, K2 and K3 once, and "
                                     f"nothing else: {dl}")
            log(f"{label}: decode under the {shape} tiers == golden; "
                f"launches {dl}")
            report[label][shape] = dict(
                launches={k: v for k, v in dl.items() if v},
                rounds=list(out[4:]), tier_rounds=rounds, host_reads=reads,
                device_ms_whole_rounds=full_ms, device_ms_gathered=at_ms,
                device_ms_other=other_ms, device_launches_other=nother,
                gathered=[held])
        times = {k: [] for k in cfgs}
        order = list(cfgs)
        for turn in range(6):
            for k in (order if turn % 2 == 0 else order[::-1]):
                times[k].append(host_ms(
                    lambda: H.sync_states(cfgs[k], arrs, ctx), dev, reps=1)[0])
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"{label}: sync_states host ms, 6 turns each, median: "
            + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
            + f"  [{card}]")
        for shape in ("classic", "ladder"):
            report[label][shape]["sync_ms"] = med[shape]
            report[label][shape]["sync_ms_jacobi"] = med["jacobi"]
    return report


def phase_sync_tiers_paths(dev: torch.device, data: bytes, expect, mesh):
    """The tiers on the other paths of the quality-90 image: a
    subsequence-granular `decode_sharded` under the ladder (K1's gathered
    mode in every shard's sync, K9 once per shard) and the records write
    path under the ladder, both == golden."""
    plan = pipeline.build_plan(T.parse(data), tuning=LADDER_T)
    st = SEG._stage(data, plan, 0, mesh, "subsequences")
    blocks, launches, _ = counted(lambda: SEG.decode_scan_staged(st))
    got = SEG.assemble(plan, {c[0]: b for c, b in zip(st.sp.comps, blocks)})
    check_equal_numpy("12 MP subsequence shards under the ladder", got,
                      expect)
    if not (launches["subseq_pass_at"] > 0
            and launches["dequant_idct_planes"] == mesh.size):
        raise AssertionError(f"the sharded decode under the ladder must run "
                             f"compacted rounds and K9 once per shard: "
                             f"{launches}")
    log(f"12 MP decode_sharded over {mesh.size} subsequence shards under the "
        f"ladder == golden; launches {launches}, {st.outer_rounds} outer "
        f"round(s)")
    rplan = pipeline.build_plan(T.parse(data), tuning=dataclasses.replace(
        LADDER_T, write_mode="tiles"))
    planes, rl, _ = counted(lambda: pipeline.decode_jpeg_device(
        data, device=dev, plan=rplan))
    check_equal_numpy("12 MP records path under the ladder", planes, expect)
    if not (rl["subseq_pass_at"] > 0 and rl["decode_write_emit"] == 1
            and rl["decode_write"] == 0):
        raise AssertionError(f"the records path under the ladder: {rl}")
    log(f"12 MP records write path under the ladder == golden; launches {rl}")


def phase_multihost(dev: torch.device, card: str, images) -> None:
    """`parallel.weakscale` on the card: 1, then 2 processes (gloo, one
    CUDA context each on the one card), each decoding 2 of the batch's
    12 MP images through `MultiHostBatchDecoder`; every worker holds its
    planes against the SHA-256 of golden's, which this process writes
    beside the JPEGs. Any worker's failure or timeout fails the run."""
    from jpeggpu_tpu_torch.parallel import weakscale

    with tempfile.TemporaryDirectory(prefix="jpeggpu_mh_") as tmp:
        for k, (data, planes) in enumerate(images):
            pathlib.Path(tmp, f"{k}.jpg").write_bytes(data)
            pathlib.Path(tmp, f"{k}.sha256").write_text(
                weakscale.planes_sha256(planes))
        for n in (1, 2):
            r = weakscale.launch(n, "2", device="cuda", data_dir=tmp,
                                 timeout=300)
            lc = r["launches"]
            log(f"multi-process decode, {n} process(es) x 2 images on "
                f"{dev.type}: planes == golden in every process; process "
                f"0's launches {lc}  [{card}]")
            if not (lc["subseq_pass"] >= 2 and lc["decode_write"] == 1
                    and lc["idct_stream_to_planes"] == 1
                    and not lc["subseq_pass_at"]):
                raise AssertionError(f"a process of the multi-process batch "
                                     f"must decode its 2 images as one merged "
                                     f"decode: {lc}")


def phase_frame(dev: torch.device) -> None:
    """The first frame of the `photo12mp.rst` cell (`benchmark.inputs`'
    generator under the cell's parameters: 4032x3024, 4:2:0, quality 90,
    RST every MCU row, noise stepping over bands of rows, PIL's libjpeg;
    no two restart segments alike) on the paths that the cell bypasses,
    each == golden of the whole frame: the default path, under
    `Tuning(write_mode="auto")` (K2 launched, not K4), through the records
    path (`tile_mode="auto"`) and with the device destuff."""
    from benchmark.inputs import make_pool
    from benchmark.run import load_cell

    _, params = load_cell("photo12mp.rst")
    # the configuration fixes the frames' content (`content_seed`): the
    # run's seed, here 0, only orders them
    frame, = make_pool(dict(params, pool=1), 0, dev)
    data = frame.data
    expect = golden.decode(data)
    check_equal_numpy("frame, default path", T.decode(data, device=dev),
                      expect)
    auto = pipeline.build_plan(T.parse(data),
                               tuning=T.Tuning(write_mode="auto"))
    planes, la, _ = counted(lambda: pipeline.decode_jpeg_device(
        data, device=dev, plan=auto))
    check_equal_numpy("frame, write_mode='auto'", planes, expect)
    if not (la["decode_write"] == 1 and la["decode_write_emit"] == 0):
        raise AssertionError(f"write_mode='auto' must run K2 and not K4: "
                             f"{la}")
    check_equal_numpy("frame, records path",
                      decode_tiles(data, dev, AUTO), expect)
    with T.Decoder(device=dev, host_destuff=False) as d:
        d.parse_header(data)
        check_equal_numpy("frame, device destuff", d.decode(), expect)
    parses = dict(reader.parses)
    parse_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        reader.parse(data)
        parse_ms.append((time.perf_counter() - t0) * 1e3)
    took = {k: reader.parses[k] - parses[k] for k in parses}
    if took != {"native": 20, "python": 0}:
        raise AssertionError(f"the frame's parses took the parsers {took}, "
                             "not the native header pass")
    log(f"photo12mp.rst's frame ({frame.width}x{frame.height}, {len(data)} "
        f"bytes): decode == golden on the default path, under "
        f"Tuning(write_mode='auto') (launches {la}), through the records "
        f"path (tile_mode='auto') and with the device destuff; its "
        f"reader.parse (native header pass) {statistics.median(parse_ms):.3f} "
        f"ms median of 20 on the card's host")


def timed(fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, its wall time logged after it."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = timed(phase_environment, dev)
    timed(phase_build, dev)
    timed(phase_small_streams, dev, args.seed)
    timed(phase_lane_kernels_any_input, dev, args.seed)
    timed(phase_entropy_kernels_any_input, dev, args.seed)
    timed(phase_k3_any_input, dev, args.seed)
    k3_batch = timed(phase_k3_batch, dev, card, args.seed)
    timed(phase_k9_any_input, dev, args.seed)
    timed(phase_sharded_small_streams, dev, args.seed)
    timed(phase_batch_small_streams, dev, args.seed)
    timed(phase_device_destuff_small_streams, dev, args.seed)
    timed(phase_sync_tiers_small_streams, dev, args.seed)

    strip, data = make_image(args.seed, QUALITY)
    strip90 = strip
    golden_strip = repeat_strip(strip, 48)
    strip_planes = golden.decode(golden_strip)
    check_equal_numpy("strip vs golden", T.decode(golden_strip, device=dev),
                      strip_planes)
    check_equal_numpy("strip vs golden, records path",
                      decode_tiles(golden_strip, dev), strip_planes)
    log(f"{FULL_W}x48 strip at full row width: decode on {dev.type} == golden "
        f"on the default path and through the records write path")

    entries = timed(phase_kernels, dev, data, card)
    (launches, by_slot, tlaunches, tby_slot, decode_ms,
     tiles_decode_ms) = timed(phase_main_path, dev, data, card)
    per_symbol, k3_times, records_times = timed(
        phase_where_time_goes, dev, data, card, decode_ms, tiles_decode_ms)
    k3, = (e for e in entries if e["name"] == "idct_stream_to_planes")
    k3["ms_in_decode"] = k3_times
    k3.update(k3_batch)
    k3["ms_in_decode_records_path"] = records_times.get(
        "::idct_stream_to_planes_kernel", [])
    for e in entries:
        key = f"::{e['name']}_kernel"
        if key in per_symbol:
            e["ms_in_decode"], e["cycles_per_symbol"] = per_symbol[key]

    strip, sparse = make_image(args.seed, QUALITY_SPARSE)
    golden_strip = repeat_strip(strip, 48)
    check_equal_numpy("sparse strip vs golden, per-lane shape",
                      decode_tiles(golden_strip, dev, AUTO),
                      golden.decode(golden_strip))
    log(f"{FULL_W}x48 sparse strip: decode on {dev.type} through "
        f"tile_mode='auto' == golden")
    entries += timed(lane_path_kernels, dev, sparse, card)
    llaunches, lby_slot, lane_times = timed(phase_lane_path, dev, sparse,
                                            card)
    k3["ms_in_decode_lane_path"] = lane_times.get(
        "::idct_stream_to_planes_kernel", [])
    for e in entries:
        # the records path's kernels inside a real decode (the profiler's,
        # per launch): K4-K6 on the quality-90 image's supertile shape, K4,
        # K7 and K8 on the sparse image's per-lane shape
        sym = RECORDS_KERNEL_SYMBOLS.get(e["name"])
        if sym in records_times:
            e["ms_in_decode"] = records_times[sym]
        if sym in lane_times:
            e["ms_in_decode_sparse" if "ms_in_decode" in e
              else "ms_in_decode"] = lane_times[sym]

    t0 = time.perf_counter()
    expect = golden.decode(data)
    log(f"golden decode of the 12 MP image on the host: "
        f"{time.perf_counter() - t0:.1f} s")
    check_equal_numpy("12 MP default path vs golden",
                      T.decode(data, device=dev), expect)
    check_equal_numpy("golden of the strip, repeated, vs golden",
                      tiled_golden(strip90, FULL_H), expect)
    sparse_expect = tiled_golden(strip, FULL_H)
    log("golden of the 12 MP images from their strips: the strip's planes "
        "repeated == golden of the whole image (quality 90)")
    tiers = timed(phase_sync_tiers, dev, card, [
        (f"quality {QUALITY}", data, expect),
        (f"quality {QUALITY_SPARSE}", sparse, sparse_expect)])
    dlaunches, dby_slot = timed(phase_device_destuff_path, dev, card, data,
                                f"quality {QUALITY}")
    timed(phase_device_destuff_path, dev, card, sparse,
          f"quality {QUALITY_SPARSE}")
    timed(phase_api, dev, card, data, sparse, expect, args.seed)
    timed(phase_staging, dev, card, args.seed)
    mesh = make_mesh([dev] * SHARDS)
    k9 = timed(sharded_kernels, dev, data, card, mesh)
    slaunches, sby_slot = timed(phase_sharded_path, dev, data, card, mesh,
                                expect)
    k9["ms_in_decode"] = timed(phase_sharded_times, dev, data, card, mesh)
    entries.append(k9)
    timed(phase_sync_tiers_paths, dev, data, expect, mesh)

    datas = batch_images(args.seed, QUALITY, BATCH, first=data)
    merged_state = timed(phase_batch_kernels, dev, card, datas)
    timed(phase_batch_widths, dev, card, datas)
    blaunches, bby_slot, btimes, k1_batch, k2_batch = timed(
        phase_batch_path, dev, card, datas, merged_state)
    sparse_datas = batch_images(args.seed, QUALITY_SPARSE, BATCH_SPARSE,
                                first=sparse)
    (tblaunches, tbby_slot, lblaunches, lbby_slot,
     route_errs) = timed(phase_batch_routes, dev, card, datas, sparse_datas,
                         merged_state[3])
    batch_errs = worst(merged_state[6], route_errs)
    timed(phase_multihost, dev, card, [(data, expect)] + [
        (datas[k], tiled_golden(make_image(args.seed + k, QUALITY)[0], FULL_H))
        for k in range(1, 4)])
    timed(phase_frame, dev)
    for e in entries:
        key = f"::{e['name']}_kernel"
        if key in btimes:
            e["ms_in_batch_decode"] = btimes[key]
        # held against its plain version at the batch routes' shapes (None:
        # K9, not on the batch path)
        e["max_abs_err_batch"] = batch_errs.get(e["name"])
        e.update({"subseq_pass": k1_batch,
                  "decode_write": k2_batch}.get(e["name"], {}))
    for e in entries:
        # counted by the wrappers during each main path's run (K3's
        # one-component entries: the components its launches covered);
        # `launches` is the count on the path that is the
        # kernel's own (K1-K3 the default path, K4-K6 the records path on
        # the quality-90 image, K7-K8 the per-lane path on the sparse one,
        # K9 the sharded path on the quality-90 image)
        slot = e.pop("slot", None)
        on_default = launches[e["name"]] if slot is None else by_slot[slot]
        on_records = tlaunches[e["name"]] if slot is None else tby_slot[slot]
        on_lane = llaunches[e["name"]] if slot is None else lby_slot[slot]
        on_sharded = (slaunches[e["name"]] if slot is None
                      else sby_slot.get(slot, 0))
        e["launches"] = on_default or on_records or on_lane or on_sharded
        e["launches_default_path"] = on_default
        e["launches_records_path"] = on_records
        e["launches_lane_path"] = on_lane
        e["launches_sharded_path"] = on_sharded
        # Decoder(host_destuff=False) on the quality-90 image
        e["launches_device_destuff_path"] = (
            dlaunches[e["name"]] if slot is None else dby_slot.get(slot, 0))
        # the batch path: the merged default batch for K1-K3, the merged
        # records batches for K4-K8 (supertiles on the dense batch, tiles
        # on the sparse one); K9 is not on it
        on_batch = [counts[e["name"]] if slot is None else by.get(slot, 0)
                    for counts, by in ((blaunches, bby_slot),
                                       (tblaunches, tbby_slot),
                                       (lblaunches, lbby_slot))]
        e["launches_batch_path"] = next((v for v in on_batch if v), 0)
    k1, = (e for e in entries if e["name"] == "subseq_pass")
    held = [dict(g, image=label, shape=shape)
            for label, shapes in tiers.items()
            for shape, r in shapes.items() for g in r["gathered"]]
    # the quality-90 image's widest launch of the ladder (the card's auto
    # shape)
    widest = next(g for g in held if g["shape"] == "ladder")
    k1.update(
        # K1's gathered mode (jpeggpu_subseq_pass_at in the same source):
        # the compacted tiers' launches on both 12 MP images, per shape
        launches_sync_tiers_path={
            f"{label}, {shape}": r["launches"]
            for label, shapes in tiers.items()
            for shape, r in shapes.items()},
        max_abs_err_gathered=max(g["max_abs_err"] for g in held),
        ms_gathered=widest["ms"], plain_ms_gathered=widest["plain_ms"],
        bound_ms_gathered=widest["bound_ms"],
        bound_by_gathered=widest["bound_by"],
        width_gathered=widest["width"], gathered_held=held,
        sync_tiers={label: {shape: {k: v for k, v in r.items()
                                    if k != "gathered"}
                            for shape, r in shapes.items()}
                    for label, shapes in tiers.items()})

    log(f"profiler windows taken again for lost device events: "
        f"{windows_lost}; most opening markers lost in a window that "
        f"counted: {markers_lost_max}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    log(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
