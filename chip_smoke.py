#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Drives `jpeggpu_tpu_torch` end to end and fails (non-zero exit, no result
line) on the first phase that fails; nothing is caught and carried past:

1. environment: torch / CUDA versions, the card's name and power limit;
2. builds the three CUDA kernels from `jpeggpu_tpu_torch/kernels/csrc` and
   the native host destuffer (the run fails where that one is missing, so
   that every host time below is the native destuffer's);
3. small streams made with the port's encoder from a numpy seed (4:2:0 with
   restarts, 4:4:4, gray, non-interleaved, a saturated Huffman table):
   decode on the card == the port's numpy golden decoder, exactly;
4. a 4032x3024 (12 MP) interleaved 4:2:0 JPEG, restart interval 252,
   quality 90, made from a seed: a strip of MCU rows is encoded with the
   numpy encoder and its restart segments are repeated to 189 rows. At
   these shapes each kernel's wrapper is held against its plain PyTorch
   version on the same CUDA tensors (all exact, max_abs_err must be 0): K1
   on the blind and on the shifted sync round, K2 on the whole coefficient
   stream, K3 on all three components. The strip itself is checked against
   the golden decoder, and `jpeggpu_tpu_torch.decode` of the 12 MP image
   against the plain path (the same pipeline on CPU tensors);
5. the main path, `jpeggpu_tpu_torch.decode(data)`, with every launch count
   set to 0 just before and read just after: each kernel must have been
   launched;
6. times, each beside its bound. Every kernel is timed twice with the
   host's enqueue cost off the clock (launches queued behind a spinning
   kernel): with L2 warm (CUDA events around 20 identical launches, median
   of 5 such runs) and with L2 cold (128 MB written between launches, each
   launch between its own pair of events, median of 20). `ms` in the
   `kernels` line is the cold time for K2 and K3, whose inputs in a decode
   were last touched tens of MB earlier, and the warm time for K1, whose
   rounds follow each other over the same 2.6 MB of words; both times are
   in the line. The kernels' times inside a real decode (the profiler's)
   are printed beside them. Then end-to-end ms and MP/s with and without
   host staging;
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
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import constants as C
from jpeggpu_tpu_torch import golden, kernels, native, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.ops import dc as DC
from jpeggpu_tpu_torch.ops import huffman as H
from jpeggpu_tpu_torch.ops import idct as I

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
# dependent integer operations per decoded symbol, counted from
# kernels/csrc/huffman_common.cuh: peek 1, table pick 3, limit search 8,
# code/index 4, huffval 2, run/category 8, length and crossing test 3,
# state update 8, buffer shift and refill 8; the write adds EXTEND 10 and
# the store address 5
K1_OPS_PER_SYMBOL = 45
K2_OPS_PER_SYMBOL = 60
# per pixel, from kernels/csrc/idct_stream.cu: two 8-point passes of 62
# operations per 8 values, dequantise and wrap 3, level shift, clamp and
# pack 6
K3_OPS_PER_PIXEL = 25

S420 = [(2, 2), (1, 1), (1, 1)]
FULL_W, FULL_H, QUALITY = 4032, 3024, 90  # restart interval: one MCU row


def log(msg: str) -> None:
    print(msg, flush=True)


# --- images -----------------------------------------------------------------

def synthetic_image(h: int, w: int, seed: int, sigma: float = 4.2) -> np.ndarray:
    """Photo-like RGB test image: a smooth random field (bilinear
    interpolation of a coarse grid) plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3)).astype(np.float32)
    ys = np.arange(h, dtype=np.float32) / 32.0
    xs = np.arange(w, dtype=np.float32) / 32.0
    y0, x0 = ys.astype(np.int64), xs.astype(np.int64)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
    bot = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
    img = top * (1 - fy) + bot * fy + rng.normal(0, sigma, top.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def repeat_strip(strip: bytes, height: int) -> bytes:
    """A JPEG of `height` lines from a strip JPEG whose restart interval is
    one MCU row: the strip's restart segments (independent by construction)
    are repeated in turn, RSTn renumbered mod 8, the SOF height patched."""
    stream = T.parse(strip)
    scan, = stream.scans
    assert stream.restart_interval == scan.num_mcus_x
    rows = height // (8 * stream.ss_max_y)
    assert rows * 8 * stream.ss_max_y == height
    head = bytearray(strip[:scan.begin])
    pos = 2
    while head[pos + 1] != C.MARKER_SOF0:
        pos += 2 + int.from_bytes(head[pos + 2:pos + 4], "big")
    head[pos + 5:pos + 7] = height.to_bytes(2, "big")
    body = strip[scan.begin:scan.end]
    segs = [body[a:b] for a, b in scan.seg_raw]
    out = bytearray(head)
    for r in range(rows):
        if r:
            out += bytes([0xFF, C.MARKER_RST0 + ((r - 1) & 7)])
        out += segs[r % len(segs)]
    out += bytes([0xFF, C.MARKER_EOI])
    return bytes(out)


def small_streams(seed: int):
    rng = np.random.default_rng(seed)
    img = synthetic_image(45, 67, seed, sigma=6.0)
    counts1 = np.zeros(16, np.uint8)
    counts1[0] = 2  # two 1-bit codes: the code space saturates at length 1
    saturated = {(0, 0): (counts1, np.array([0, 1], np.uint8)),
                 (1, 0): (counts1, np.array([0x00, 0x11], np.uint8))}
    noise = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
    return [
        ("420_rst2", encode(img, EncodeSpec(sampling=S420, restart_interval=2))),
        ("444", encode(img, EncodeSpec(sampling=[(1, 1)] * 3))),
        ("gray_rst3", encode(img[..., 0], EncodeSpec(restart_interval=3))),
        ("non_interleaved", encode(img, EncodeSpec(sampling=S420,
                                                   interleaved=False))),
        ("saturated_table", encode(np.full((24, 32), 127, np.uint8), EncodeSpec(
            huff_overrides=saturated, quality=50))),
        ("noise_q98", encode(noise, EncodeSpec(quality=98))),
    ]


# --- helpers ----------------------------------------------------------------

def sync(dev: torch.device) -> None:
    torch.cuda.synchronize(dev)


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    log(smi)
    return smi.splitlines()[0]


def phase_build(dev: torch.device) -> None:
    for fn in ("jpeggpu_subseq_pass", "jpeggpu_decode_write",
               "jpeggpu_idct_stream_to_plane"):
        kernels.get(fn)
    for entry in kernels.build_log:
        for line in entry.splitlines():
            if line.startswith("---") or "registers" in line or "error" in line:
                log(f"  {line.strip()}")
    log(f"set-up: built 3 kernels with nvcc in {kernels.build_seconds:.1f} s")
    if native.get_lib() is None:
        raise AssertionError("the native host destuffer did not build: no "
                             "C++ compiler on this machine")
    log("host destuffer: native C++ (jpeggpu_tpu_torch/native/destuff.cpp)")


def phase_small_streams(dev: torch.device, seed: int) -> None:
    for name, data in small_streams(seed):
        check_equal_numpy(name, T.decode(data, device=dev), golden.decode(data))
        log(f"small stream {name}: decode on {dev.type} == golden")


def phase_kernels(dev: torch.device, data: bytes, card: str):
    """Each kernel against its plain version at the main path's shapes;
    returns the kernel entries (without launch counts)."""
    plan = pipeline.build_plan(T.parse(data))
    staged = pipeline.stage_inputs(pipeline.build_inputs(data, plan), dev)
    sp, = plan.signature.scans
    cfg, arrs, qtables = sp.cfg, staged["scans"][0], staged["qtables"]
    ctx = H.make_ctx(cfg, arrs)
    lanes = cfg.lanes
    scan, = plan.stream.scans
    buf = np.frombuffer(data, np.uint8)
    if native.destuff_words(buf[scan.begin:scan.end], scan.segments[:, 0],
                            scan.num_subsequences, lanes, scan.seg_raw) is None:
        raise AssertionError("the native destuffer refused the 12 MP stream")
    log(f"event pair around nothing, as the cold timing brackets a launch: "
        f"{time_cold_ms(lambda: None, dev):.4f} ms")
    log(f"12 MP shapes: lanes {lanes} ({int(ctx.lane_valid.sum())} valid), "
        f"{cfg.num_segments} segments, {cfg.total_mcus * cfg.du_per_mcu} data "
        f"units, {cfg.total_positions * 2 / 1e6:.1f} MB of coefficients")
    entries = []
    tables = (arrs.maxcode, arrs.vsm, ctx.limits, arrs.huffval, ctx.slots)

    # K1, blind round then shifted round
    blind_p = ctx.rel * C.SUBSEQ_SIZE_BITS
    zeros = torch.zeros_like(blind_p)
    starts = {"blind": (blind_p, zeros, zeros)}
    p, c, z, _ = H.subseq_pass(cfg, arrs, ctx, blind_p, zeros, zeros,
                               ctx.lane_valid)
    first = ctx.first_of_seg
    starts["shifted"] = (torch.where(first, blind_p, torch.roll(p, 1)),
                         torch.where(first, zeros, torch.roll(c, 1)),
                         torch.where(first, zeros, torch.roll(z, 1)))
    k1 = {}
    for which, (p0, c0, z0) in starts.items():
        got = H.subseq_pass(cfg, arrs, ctx, p0, c0, z0, ctx.lane_valid)
        t0 = time.perf_counter()
        ref = H.subseq_pass_plain(cfg, arrs, ctx, p0, c0, z0, ctx.lane_valid)
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_abs_err(a, b) for a, b in zip(got, ref))
        def launch():
            return H.subseq_pass(cfg, arrs, ctx, p0, c0, z0, ctx.lane_valid)

        ms, call_ms = time_ms(launch, dev)
        cold_ms = time_cold_ms(launch, dev)
        k1[which] = (err, ms, plain_ms, call_ms, cold_ms)
        log(f"K1 subseq_pass {which} round: max_abs_err {err}, {ms:.4f} ms "
            f"on the device with L2 warm, {cold_ms:.4f} ms cold "
            f"({call_ms:.4f} ms a single call), plain {plain_ms:.1f} ms  "
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

    lane_in = nbytes(ctx.word_end, ctx.seg_base_bits, ctx.end_subseq,
                     blind_p, zeros, zeros, ctx.lane_valid)
    k1_bytes = nbytes(arrs.words, *tables) + lane_in + 4 * 4 * lanes
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
    k2_bytes = (nbytes(arrs.words, *tables, ctx.natural) + lane_in
                + 2 * 4 * lanes + nbytes(coeffs))
    b_ms, b_by = bound(k2_bytes, symbols * K2_OPS_PER_SYMBOL)
    entries.append(dict(
        name="decode_write", route="cuda",
        source="jpeggpu_tpu_torch/kernels/csrc/decode_write.cu",
        replaces="jpeggpu_tpu/ops/huffman_pallas.py:539", max_abs_err=k2_err,
        ms=k2_cold, plain_ms=k2_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, call_ms=k2_call, ms_warm_l2=k2_warm,
        ms_cold_l2=k2_cold, symbols=symbols))

    # K3, every component
    comp_slots = tuple((k[1], k[2] * k[3]) for k in sp.comps)
    dcv = DC.undelta_dc_values(cfg, comp_slots, coeffs)
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
        log(f"K3 idct_stream_to_plane component {comp[0]} "
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
    return entries


def phase_main_path(dev: torch.device, data: bytes, card: str):
    """The main path with the launch counts read around it, its output
    against the plain path, and the end-to-end times."""
    wrappers = (H.subseq_pass, H.decode_write, I.idct_stream_to_plane)
    for w in wrappers:
        w.launches = 0
    I.idct_stream_to_plane.launches_by_slot.clear()
    planes = T.decode(data, device=dev)
    launches = {w.__name__: w.launches for w in wrappers}
    by_slot = dict(I.idct_stream_to_plane.launches_by_slot)
    log(f"main path launches: {launches} (sync rounds = subseq_pass "
        f"launches), idct_stream_to_plane by first slot of the component: "
        f"{by_slot}")
    n_comps = len(T.parse(data).components)
    if not (launches["subseq_pass"] >= 2 and launches["decode_write"] == 1
            and launches["idct_stream_to_plane"] == n_comps
            and len(by_slot) == n_comps and all(by_slot.values())):
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches} {by_slot}")

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
    full = []
    for _ in range(5):
        t0 = time.perf_counter()
        T.decode(data, device=dev)
        full.append((time.perf_counter() - t0) * 1e3)
    with T.Decoder(device=dev) as d:
        d.parse_header(data)
        log(f"get_buffer_size: {d.get_buffer_size() / 1e6:.1f} MB")
        d.transfer()
        sync(dev)

        def run():
            d.decode(keep_on_device=True)
            sync(dev)

        run()
        staged = []
        for _ in range(9):
            t0 = time.perf_counter()
            run()
            staged.append((time.perf_counter() - t0) * 1e3)
    e2e, dev_only = statistics.median(full), statistics.median(staged)
    log(f"end to end with host staging (parse, destuff, copy in, decode, "
        f"copy out): {e2e:.2f} ms = {mp / e2e * 1e3:.0f} MP/s  [{card}]")
    log(f"end to end without host staging (staged inputs, planes left on "
        f"the device): {dev_only:.2f} ms = {mp / dev_only * 1e3:.0f} MP/s  "
        f"[{card}]")
    return launches, by_slot, dev_only


def phase_where_time_goes(dev: torch.device, data: bytes, card: str,
                          decode_ms: float) -> None:
    """Host clock per stage of one decode (each stage ends in a
    synchronise, median of 7), and the device's idle share: the profiler's
    kernel times of one decode against `decode_ms`, the time of a decode
    from staged inputs without the profiler."""
    def med(fn, reps=7):
        times = []
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            out = fn()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), out

    stages = {}
    stages["parse + plan"], plan = med(
        lambda: pipeline.build_plan(T.parse(data)))
    stages["host destuff + tables"], inputs = med(
        lambda: pipeline.build_inputs(data, plan))
    stages["copy in"], staged = med(lambda: pipeline.stage_inputs(inputs, dev))
    sp, = plan.signature.scans
    cfg, arrs, qtables = sp.cfg, staged["scans"][0], staged["qtables"]
    stages["make_ctx"], ctx = med(lambda: H.make_ctx(cfg, arrs))
    stages["sync_states"], (p, c, z, n) = med(
        lambda: H.sync_states(cfg, arrs, ctx))
    stages["symbol_offsets"], n_off = med(
        lambda: H.symbol_offsets(cfg, arrs, n))
    stages["decode_write"], coeffs = med(
        lambda: H.decode_write(cfg, arrs, ctx, p, c, z, n_off))
    comp_slots = tuple((k[1], k[2] * k[3]) for k in sp.comps)
    stages["undelta_dc_values"], dcv = med(
        lambda: DC.undelta_dc_values(cfg, comp_slots, coeffs))
    stages["idct_stream_to_plane x3"], planes = med(lambda: [
        I.idct_stream_to_plane(
            coeffs, qtables[k[6]], sp.num_mcus_x, sp.num_mcus_y,
            cfg.du_per_mcu, k[1], k[2], k[3], dcv) for k in sp.comps])
    stages["copy out"], _ = med(
        lambda: [pl.contiguous().cpu().numpy() for pl in planes])
    for name, ms in stages.items():
        log(f"stage {name}: {ms:.3f} ms  [{card}]")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipeline.decode_pipeline(plan.signature, staged["scans"], qtables)
        sync(dev)
    on_device = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    if busy_ms <= 0:
        log("device busy share of a decode: not measured (the profiler "
            "reported no device time)")
        return
    log(f"device busy {busy_ms:.3f} ms (kernel times from the profiler) of a "
        f"{decode_ms:.2f} ms decode from staged inputs: idle share "
        f"{1 - busy_ms / decode_ms:.2f}  [{card}]")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:.4f} ms x{e.count}  {e.key[:70]}")
    own = ("subseq_pass_kernel", "decode_write_kernel",
           "idct_stream_to_plane_kernel")
    for name in own:
        each = [e.self_device_time_total / 1e3 for e in prof.events()
                if e.device_type == DeviceType.CUDA and name in e.name]
        log(f"  inside the decode, {name} per launch, ms: "
            + " ".join(f"{t:.4f}" for t in each) + f"  [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    width, height, strip_rows = FULL_W, FULL_H, 9
    t_start = time.perf_counter()

    card = phase_environment(dev)
    phase_build(dev)
    phase_small_streams(dev, args.seed)

    t0 = time.perf_counter()
    strip_img = synthetic_image(16 * strip_rows, width, args.seed)
    strip = encode(strip_img, EncodeSpec(
        quality=QUALITY, sampling=S420, restart_interval=width // 16))
    data = repeat_strip(strip, height)
    log(f"{width}x{height} JPEG: {len(data)} bytes from a {strip_rows}-row "
        f"strip, made in {time.perf_counter() - t0:.1f} s")
    golden_strip = repeat_strip(strip, 48)
    check_equal_numpy("strip vs golden", T.decode(golden_strip, device=dev),
                      golden.decode(golden_strip))
    log(f"{width}x48 strip at full row width: decode on {dev.type} == golden")

    entries = phase_kernels(dev, data, card)
    launches, by_slot, decode_ms = phase_main_path(dev, data, card)
    phase_where_time_goes(dev, data, card, decode_ms)
    for e in entries:
        # counted by the wrappers during the main path's run, K3 per component
        e["launches"] = (by_slot[e.pop("slot")] if "slot" in e
                         else launches[e["name"]])

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
