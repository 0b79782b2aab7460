"""Baseline JPEG encoder (host, numpy) for test-vector generation.

The reference project leans on ImageMagick to synthesize its test matrix
(test/test.sh:31-43); we bundle an encoder instead so the test-suite can
exercise every supported axis without external tools: arbitrary sampling
factors (1-4), 1-4 components, interleaved and one-scan-per-component
streams, restart intervals, and up to 4 DC + 4 AC Huffman tables.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from . import constants as C
from .tables import (
    STD_AC_CHROMA,
    STD_AC_LUMA,
    STD_DC_CHROMA,
    STD_DC_LUMA,
    STD_QUANT_CHROMA,
    STD_QUANT_LUMA,
)


def _dct2d(block: np.ndarray) -> np.ndarray:
    """Reference float DCT-II (T.81 A.3.3) on (..., 8, 8)."""
    k = np.arange(8)
    cos = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    cu = np.where(k == 0, 1 / np.sqrt(2), 1.0)
    m = 0.5 * cu[:, None] * cos
    return np.einsum("ux,...xy,vy->...uv", m, block, m)


def scale_qtable(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg-style quality scaling, clamped to [1, 255]."""
    quality = max(1, min(100, quality))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    q = (base * scale + 50) // 100
    return np.clip(q, 1, 255).astype(np.int32)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, length: int) -> None:
        if length == 0:
            return
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing

    def pad_to_byte(self) -> None:
        if self.nbits:
            self.put(0x7F, 8 - self.nbits)  # pad with 1 bits (F.1.2.3)


def _huff_encode_table(num_codes: np.ndarray, values: np.ndarray):
    """symbol -> (code, length)."""
    enc = {}
    code = 0
    idx = 0
    for l in range(16):
        for _ in range(int(num_codes[l])):
            enc[int(values[idx])] = (code, l + 1)
            idx += 1
            code += 1
        code <<= 1
    return enc


class _NullWriter:
    """Bit sink for the statistics pass."""

    def put(self, value: int, length: int) -> None:
        pass

    def pad_to_byte(self) -> None:
        pass


class _SymbolCounter:
    """Duck-types the (code, length) encoder maps of _encode_du but only
    counts symbol frequencies — the statistics pass of optimized encoding."""

    def __init__(self, freq: np.ndarray):
        self.freq = freq

    def __getitem__(self, symbol: int) -> tuple[int, int]:
        self.freq[symbol] += 1
        return 0, 0


def optimal_huffman(freq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Frequency-optimal Huffman table per T.81 Annex K.2.

    Returns (counts[16], values) in DHT order. Follows the spec's code-size
    procedure: a reserved 257th symbol guarantees no real symbol is assigned
    the all-ones code, and code sizes deeper than 16 are folded back with
    the Figure K.3 adjustment. (The reference decodes such tables like any
    other; libjpeg's optimize_coding produces them, so real-world streams
    carry them — this generator exists to cover that in tests.)
    """
    f = np.zeros(257, np.int64)
    f[:256] = np.asarray(freq, np.int64)
    if not f.any():  # referenced but unused table: one dummy 1-bit code
        return (np.array([1] + [0] * 15, np.uint8),
                np.array([0], np.uint8))
    f[256] = 1  # reserved code point (K.2: V = 256, freq 1)
    codesize = np.zeros(257, np.int64)
    others = np.full(257, -1, np.int64)
    while True:
        nz = np.nonzero(f)[0]
        if nz.size < 2:
            break
        fv = f[nz]
        v1 = int(nz[fv == fv.min()].max())  # least freq, ties: largest value
        rest = nz[nz != v1]
        fr = f[rest]
        v2 = int(rest[fr == fr.min()].max())
        f[v1] += f[v2]
        f[v2] = 0
        codesize[v1] += 1
        while others[v1] != -1:
            v1 = int(others[v1])
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] != -1:
            v2 = int(others[v2])
            codesize[v2] += 1
    bits = np.zeros(60, np.int64)
    for s in range(257):
        if codesize[s]:
            bits[codesize[s]] += 1
    i = 59  # fold lengths > 16 back (Figure K.3)
    while i > 16:
        if bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
        else:
            i -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # drop the reserved symbol's code
    counts = bits[1:17].astype(np.uint8)
    values = np.array([s for _, s in sorted(
        (int(codesize[s]), s) for s in range(256) if codesize[s])], np.uint8)
    assert int(counts.sum()) == values.size
    return counts, values


def _magnitude(v: int) -> tuple[int, int]:
    """(category, offset-code) per T.81 F.1.2.1-F.1.2.2."""
    if v == 0:
        return 0, 0
    a = abs(v)
    cat = a.bit_length()
    code = v if v > 0 else v + (1 << cat) - 1
    return cat, code


@dataclasses.dataclass
class EncodeSpec:
    quality: int = 85
    # sampling factor per component, e.g. [(2, 2), (1, 1), (1, 1)]
    sampling: Optional[Sequence[tuple[int, int]]] = None
    restart_interval: int = 0
    interleaved: bool = True
    # per component: (dc table id, ac table id); default 0 for comp0 else 1
    table_ids: Optional[Sequence[tuple[int, int]]] = None
    # build frequency-optimal Huffman tables from the image's own symbol
    # statistics (libjpeg optimize_coding analog, T.81 Annex K.2) instead
    # of the Annex K typical tables
    optimize_huffman: bool = False
    # per component quantization table id; default 0 for comp0 else 1
    qtable_ids: Optional[Sequence[int]] = None
    # override Huffman tables: {(class, id): (counts[16], values)} — class
    # 0=DC, 1=AC; used by tests to exercise unusual (e.g. saturated) tables
    huff_overrides: Optional[dict] = None
    # emit a DHT before EVERY SOS, rebuilding each scan's tables from that
    # scan's own symbol statistics — the same table ids carry different
    # contents per scan (T.81 allows redefinition between scans; decoders
    # must snapshot tables at each SOS, cf. reference reader.cpp:434-441).
    # Meaningful for multi-scan (non-interleaved) streams; used by tests.
    dht_per_scan: bool = False


def encode(planes_or_rgb, spec: EncodeSpec = EncodeSpec()) -> bytes:
    """Encode image planes (or an RGB/grayscale array) as baseline JPEG.

    ``planes_or_rgb`` may be an (h, w) or (h, w, 3) uint8 array (converted
    to Y/YCbCr and subsampled per ``spec.sampling``), or a list of uint8
    component planes already sized ceil(size*ss/ss_max).
    """
    arr = planes_or_rgb
    if isinstance(arr, np.ndarray):
        planes, size_x, size_y, sampling = _to_planes(arr, spec)
    else:
        planes = [np.asarray(p, np.uint8) for p in arr]
        sampling = list(spec.sampling or [(1, 1)] * len(planes))
        ss_max_x = max(s[0] for s in sampling)
        ss_max_y = max(s[1] for s in sampling)
        # plane 0 must be full resolution so the frame size is unambiguous
        assert sampling[0] == (ss_max_x, ss_max_y), "plane 0 must have max ss"
        size_y, size_x = planes[0].shape

    n = len(planes)
    if n == 1:
        sampling = [(1, 1)]
    table_ids = list(spec.table_ids or [(0, 0)] + [(1, 1)] * (n - 1))
    qtable_ids = list(spec.qtable_ids or [0] + [1] * (n - 1))
    ss_max_x = max(s[0] for s in sampling)
    ss_max_y = max(s[1] for s in sampling)

    # quantization tables, natural order, indexed by id
    base_q = {0: STD_QUANT_LUMA, 1: STD_QUANT_CHROMA,
              2: STD_QUANT_LUMA, 3: STD_QUANT_CHROMA}
    used_q = sorted(set(qtable_ids))
    qtabs = {qi: scale_qtable(base_q[qi], spec.quality) for qi in used_q}

    huff_specs = {  # (class, id) -> (counts, values)
        (C.HUFF_DC, 0): STD_DC_LUMA, (C.HUFF_AC, 0): STD_AC_LUMA,
        (C.HUFF_DC, 1): STD_DC_CHROMA, (C.HUFF_AC, 1): STD_AC_CHROMA,
        (C.HUFF_DC, 2): STD_DC_LUMA, (C.HUFF_AC, 2): STD_AC_LUMA,
        (C.HUFF_DC, 3): STD_DC_CHROMA, (C.HUFF_AC, 3): STD_AC_CHROMA,
    }
    if spec.huff_overrides:
        huff_specs.update(spec.huff_overrides)
    used_huff = sorted({(C.HUFF_DC, d) for d, _ in table_ids} |
                       {(C.HUFF_AC, a) for _, a in table_ids})

    # --- quantized coefficients per component ---
    comp_blocks: List[np.ndarray] = []  # (n_du_y, n_du_x, 64) zig-zag ints
    for ci, plane in enumerate(planes):
        ssx, ssy = sampling[ci]
        cw = -(-size_x * ssx // ss_max_x)
        ch = -(-size_y * ssy // ss_max_y)
        assert plane.shape == (ch, cw), (plane.shape, (ch, cw))
        mw = 8 * ssx if spec.interleaved and n > 1 else 8
        mh = 8 * ssy if spec.interleaved and n > 1 else 8
        pw = -(-cw // mw) * mw
        ph = -(-ch // mh) * mh
        padded = np.pad(plane, ((0, ph - ch), (0, pw - cw)), mode="edge")
        blocks = padded.astype(np.float64).reshape(ph // 8, 8, pw // 8, 8)
        blocks = blocks.transpose(0, 2, 1, 3) - 128.0
        fdct = _dct2d(blocks)
        q = qtabs[qtable_ids[ci]].reshape(8, 8)
        quant = np.round(fdct / q).astype(np.int32)
        # zig-zag reorder: zz[i] = raster value at ORDER_NATURAL[i]
        zz = quant.reshape(ph // 8, pw // 8, 64)[:, :, C.ORDER_NATURAL]
        comp_blocks.append(zz)

    scan_groups = ([list(range(n))] if spec.interleaved or n == 1
                   else [[ci] for ci in range(n)])

    def scan_du_iter(comp_indices):
        """(ci, data unit, restart-before-this-mcu) in scan emission order."""
        interleaved = len(comp_indices) > 1
        if interleaved:
            mcus_x = -(-size_x // (8 * ss_max_x))
            mcus_y = -(-size_y // (8 * ss_max_y))
        else:
            c0 = comp_indices[0]
            mcus_y, mcus_x = comp_blocks[c0].shape[:2]
        mcu_count = 0
        for my in range(mcus_y):
            for mx in range(mcus_x):
                restart = bool(spec.restart_interval and mcu_count
                               and mcu_count % spec.restart_interval == 0)
                mcu_count += 1
                for ci in comp_indices:
                    ssx, ssy = sampling[ci] if interleaved else (1, 1)
                    for by in range(ssy):
                        for bx in range(ssx):
                            yield (ci,
                                   comp_blocks[ci][my * ssy + by,
                                                   mx * ssx + bx], restart)
                            restart = False

    if spec.optimize_huffman:
        # statistics pass: same walk, counting encoders, no output
        freqs = {key: np.zeros(256, np.int64) for key in used_huff}
        counters = {key: _SymbolCounter(freqs[key]) for key in used_huff}
        null_writer = _NullWriter()
        for comp_indices in scan_groups:
            pred = {ci: 0 for ci in comp_indices}
            for ci, du, restart in scan_du_iter(comp_indices):
                if restart:
                    pred = {c: 0 for c in comp_indices}
                _encode_du(null_writer, du, pred, ci,
                           counters[(C.HUFF_DC, table_ids[ci][0])],
                           counters[(C.HUFF_AC, table_ids[ci][1])])
        for key in used_huff:
            if spec.huff_overrides and key in spec.huff_overrides:
                continue  # explicit overrides win over optimization
            huff_specs[key] = optimal_huffman(freqs[key])

    encoders = {key: _huff_encode_table(*huff_specs[key]) for key in used_huff}

    # --- emit stream ---
    out = bytearray()

    def marker(m, payload=b""):
        out.extend(bytes([0xFF, m]))
        if payload or m not in (C.MARKER_SOI, C.MARKER_EOI):
            out.extend((len(payload) + 2).to_bytes(2, "big"))
            out.extend(payload)

    marker(C.MARKER_SOI)
    for qi in used_q:
        zz_q = qtabs[qi].reshape(64)[C.ORDER_NATURAL]
        marker(C.MARKER_DQT, bytes([qi]) + bytes(int(v) for v in zz_q))
    sof = bytearray([8])
    sof += size_y.to_bytes(2, "big") + size_x.to_bytes(2, "big")
    sof.append(n)
    for ci in range(n):
        sof += bytes([ci + 1, (sampling[ci][0] << 4) | sampling[ci][1],
                      qtable_ids[ci]])
    marker(C.MARKER_SOF0, bytes(sof))
    if not spec.dht_per_scan:
        for (cls, tid) in used_huff:
            counts, values = huff_specs[(cls, tid)]
            payload = (bytes([(cls << 4) | tid]) + bytes(counts)
                       + bytes(values))
            marker(C.MARKER_DHT, payload)
    if spec.restart_interval:
        marker(C.MARKER_DRI, spec.restart_interval.to_bytes(2, "big"))

    def encode_scan(comp_indices: List[int]):
        sos = bytearray([len(comp_indices)])
        for ci in comp_indices:
            sos += bytes([ci + 1, (table_ids[ci][0] << 4) | table_ids[ci][1]])
        sos += bytes([0, 63, 0])
        marker(C.MARKER_SOS, bytes(sos))

        writer = _BitWriter()
        pred = {ci: 0 for ci in comp_indices}
        rst_n = 0
        for ci, du, restart in scan_du_iter(comp_indices):
            if restart:
                writer.pad_to_byte()
                out.extend(writer.out)
                writer = _BitWriter()
                out.extend(bytes([0xFF, C.MARKER_RST0 + (rst_n & 7)]))
                rst_n += 1
                pred = {c: 0 for c in comp_indices}
            _encode_du(writer, du, pred, ci,
                       encoders[(C.HUFF_DC, table_ids[ci][0])],
                       encoders[(C.HUFF_AC, table_ids[ci][1])])
        writer.pad_to_byte()
        out.extend(writer.out)

    for comp_indices in scan_groups:
        if spec.dht_per_scan:
            # per-scan optimal tables under the SAME ids: a DHT between
            # SOSs redefines them, so a decoder that fails to snapshot
            # tables per scan decodes earlier scans with later tables
            keys = sorted(
                {(C.HUFF_DC, table_ids[ci][0]) for ci in comp_indices} |
                {(C.HUFF_AC, table_ids[ci][1]) for ci in comp_indices})
            freqs = {k: np.zeros(256, np.int64) for k in keys}
            counters = {k: _SymbolCounter(freqs[k]) for k in keys}
            null_writer = _NullWriter()
            pred = {ci: 0 for ci in comp_indices}
            for ci, du, restart in scan_du_iter(comp_indices):
                if restart:
                    pred = {c: 0 for c in comp_indices}
                _encode_du(null_writer, du, pred, ci,
                           counters[(C.HUFF_DC, table_ids[ci][0])],
                           counters[(C.HUFF_AC, table_ids[ci][1])])
            for k in keys:
                huff_specs[k] = optimal_huffman(freqs[k])
                encoders[k] = _huff_encode_table(*huff_specs[k])
                counts, values = huff_specs[k]
                marker(C.MARKER_DHT, bytes([(k[0] << 4) | k[1]])
                       + bytes(counts) + bytes(values))
        encode_scan(comp_indices)
    marker(C.MARKER_EOI)
    return bytes(out)


def _encode_du(writer, du, pred, ci, dc_enc, ac_enc):
    diff = int(du[0]) - pred[ci]
    pred[ci] = int(du[0])
    cat, code = _magnitude(diff)
    c, l = dc_enc[cat]
    writer.put(c, l)
    writer.put(code, cat)
    run = 0
    for k in range(1, 64):
        v = int(du[k])
        if v == 0:
            run += 1
            continue
        while run >= 16:
            c, l = ac_enc[0xF0]  # ZRL
            writer.put(c, l)
            run -= 16
        cat, code = _magnitude(v)
        c, l = ac_enc[(run << 4) | cat]
        writer.put(c, l)
        writer.put(code, cat)
        run = 0
    if run:
        c, l = ac_enc[0x00]  # EOB
        writer.put(c, l)


def _area_resample(p: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """Exact area-average resample of ``p`` onto a (ch, cw) grid.

    Destination cell (i, j) averages the source rectangle
    [i*h/ch, (i+1)*h/ch) x [j*w/cw, (j+1)*w/cw) — fractional bounds are
    handled exactly via a bilinearly-sampled integral image (bilinear
    interpolation of the integral of a piecewise-constant image is exact),
    so non-divisor sampling ratios like 3:2 get a true box filter.
    """
    h, w = p.shape
    if (ch, cw) == (h, w):
        return p
    integral = np.zeros((h + 1, w + 1))
    integral[1:, 1:] = p.cumsum(axis=0).cumsum(axis=1)

    def sample_rows(a, coords, n):
        idx = np.minimum(np.floor(coords).astype(np.int64), n - 1)
        frac = coords - idx
        return a[idx] * (1 - frac)[:, None] + a[idx + 1] * frac[:, None]

    ys = np.linspace(0.0, float(h), ch + 1)
    xs = np.linspace(0.0, float(w), cw + 1)
    rows = sample_rows(integral, ys, h)  # (ch+1, w+1)
    grid = sample_rows(rows.T, xs, w).T  # (ch+1, cw+1)
    sums = grid[1:, 1:] - grid[:-1, 1:] - grid[1:, :-1] + grid[:-1, :-1]
    return sums / np.outer(np.diff(ys), np.diff(xs))


def _to_planes(arr: np.ndarray, spec: EncodeSpec):
    arr = np.asarray(arr, np.uint8)
    if arr.ndim == 2:
        return [arr], arr.shape[1], arr.shape[0], [(1, 1)]
    assert arr.ndim == 3 and arr.shape[2] == 3
    h, w = arr.shape[:2]
    sampling = list(spec.sampling or [(2, 2), (1, 1), (1, 1)])
    r = arr[..., 0].astype(np.float64)
    g = arr[..., 1].astype(np.float64)
    b = arr[..., 2].astype(np.float64)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    full = [y, cb, cr]
    ss_max_x = max(s[0] for s in sampling)
    ss_max_y = max(s[1] for s in sampling)
    planes = []
    for ci, p in enumerate(full):
        ssx, ssy = sampling[ci]
        cw = -(-w * ssx // ss_max_x)
        ch = -(-h * ssy // ss_max_y)
        if ss_max_y % ssy == 0 and ss_max_x % ssx == 0:
            # integer ratio: box-filter downsample onto the (ch, cw) grid
            fy = ss_max_y // ssy
            fx = ss_max_x // ssx
            ph, pw = ch * fy, cw * fx
            pp = np.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")
            ds = pp.reshape(ch, fy, cw, fx).mean(axis=(1, 3))
        else:
            # non-divisor ratio (e.g. 3:2): fractional-area box filter
            ds = _area_resample(p, ch, cw)
        planes.append(np.clip(np.round(ds), 0, 255).astype(np.uint8))
    return planes, w, h, sampling
