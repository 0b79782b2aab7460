"""Device entropy decoder: subsequence-parallel speculative Huffman decode.

Every 1024-bit subsequence of the destuffed scan is a *lane*. The state
synchronisation of "Accelerating JPEG Decompression on GPUs"
(arXiv:2111.09219) is a whole-array Jacobi fixed-point iteration on the
per-lane decoder states:

  round 0:  E[i] = decode(i, blind_i)            (speculative, all lanes)
  round k:  E[i] = decode(i, E[i-1])             (states shifted one lane)
  stop when E stops changing (self-synchronisation makes this converge in
  a few rounds; segment starts are exact by construction).

Decode-state semantics:
  p  bit position relative to the segment (never crosses a subsequence
     boundary mid-symbol; the crossing symbol belongs to the next lane),
  n  coefficient positions (run + 1 per symbol) produced by the lane,
  c  data-unit index within the MCU, z  zig-zag index within the data unit.

Three functions here are CUDA kernels on the card: :func:`subseq_pass` (K1,
one whole sync round: start states, the pass, the freeze and the
convergence test), :func:`decode_write` (K2, the writing decode that stores
into the coefficient stream) and :func:`decode_write_emit` (K4, the writing
decode that emits packed records for the records write path of
``ops/write.py``). Each has its plain PyTorch version beside it, lock-step
over all lanes with gathers for the bit loads and table lookups; a wrapper
takes the plain version only for CPU tensors and launches its kernel for
CUDA tensors. K1, K2 and K4 resolve a symbol whose code fits in
:data:`SYMTAB_BITS` bits with one lookup in the per-scan symbol table
(:func:`build_symbol_table`); :func:`_decode_symbol_table` is a tensor
model of that decode for the tests, while the plain versions keep
:func:`_decode_symbol` as their semantics.
The word stream is carried as int32 bit patterns of the big-endian uint32
words (the kernels reinterpret them as unsigned, the plain versions widen
to int64).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from .. import kernels
from ..config import Tuning
from ..debug import scope

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Static (hashable) per-scan decode geometry."""

    lanes: int  # padded subsequence count (a shape bucket)
    num_segments: int
    du_per_mcu: int
    mcus_per_seg: int
    total_mcus: int
    # per scan component: (end_slot_exclusive, dc_table_slot, ac_table_slot);
    # table slots index the packed 8-table arrays (= id*2 + class)
    comp_groups: Tuple[Tuple[int, int, int], ...]
    # canonical-limit fast symbol decode; the host parser sets this False
    # when a table's code space saturates (tables.HuffmanTable.saturated)
    fast_tables: bool = True
    # tile depth of the records write path's per-lane shape (ops/write.py):
    # data-unit rows of one lane's tile, sized by build_plan from the
    # stream's average data units per subsequence; lanes that span more
    # drain through the leftover scatter
    tile_d: int = 96
    # supertile geometry of the records write path (ops/write.py), sized by
    # build_plan from the stream's average data units per subsequence:
    # super_g consecutive lanes share one (super_d, 64) supertile; the
    # expand stage gathers group_du data units per group from a window of
    # super_w supertiles; lanes that do not fit drain through the leftover
    # scatter
    super_g: int = 4
    super_w: int = 8
    super_d: int = 128
    group_du: int = 128
    # what tile_mode="auto" resolves to for this scan ("super" | "lane"):
    # build_plan picks "lane" for sparse scans whose smallest supertile
    # group would overflow the super_d window
    tile_auto: str = "super"
    tuning: Tuning = Tuning()

    @property
    def total_positions(self) -> int:
        return self.total_mcus * self.du_per_mcu * C.DATA_UNIT_SIZE

    @property
    def positions_per_seg(self) -> int:
        return self.mcus_per_seg * self.du_per_mcu * C.DATA_UNIT_SIZE


@dataclasses.dataclass
class ScanArrays:
    """Device inputs for one scan."""

    # int32[lanes*32] bit patterns of big-endian words; None for a scan
    # staged for the device destuff (``raw``, ``seg_sub_offset``) until
    # ``pipeline.destuffed`` fills it
    words: Optional[torch.Tensor]
    seg_of_subseq: torch.Tensor  # int32[lanes]
    seg_first_lane: torch.Tensor  # int32[lanes] first subsequence of my segment
    seg_num_subseq: torch.Tensor  # int32[lanes] subsequence count of my segment
    maxcode: torch.Tensor  # int32[8,16]
    vsm: torch.Tensor  # int32[8,16] valptr - mincode
    huffval: torch.Tensor  # int32[8*256]
    # int16[8 << SYMTAB_BITS]: the one-lookup symbol table of K1, K2 and K4
    # (build_symbol_table), built on the host when the scan is staged
    # (convert.symbol_table)
    symtab: torch.Tensor
    # words staged in front of ``words`` in its storage (0 or 1). A
    # subsequence shard (parallel/segments.py, which gives its segments a
    # negative ``seg_first_lane``) has 1: the word before the shard, since
    # lane 0 of a shard that begins mid-segment may start up to 31 bits
    # before its own words. The kernels and the plain versions both read
    # word -1 from there; with 0 no index below 0 occurs.
    lead_words: int = 0
    # a scan staged for the device destuff (``host_destuff=False``): its
    # uint8 raw body, zero padded, and int32[num_segments_padded] first
    # subsequence per segment (``ops.destuff.destuff_scan``'s inputs)
    raw: Optional[torch.Tensor] = None
    seg_sub_offset: Optional[torch.Tensor] = None


@dataclasses.dataclass
class Ctx:
    """Per-scan decode context, built once per decode by :func:`make_ctx`."""

    word_end: torch.Tensor  # int32[lanes] absolute word index of segment end
    seg_base_bits: torch.Tensor  # int32[lanes]
    end_subseq: torch.Tensor  # int32[lanes] bit bound of own subsequence
    rel: torch.Tensor  # int32[lanes] subsequence index within segment
    lane_valid: torch.Tensor  # bool[lanes]
    first_of_seg: torch.Tensor  # bool[lanes]
    # uint32 bit patterns, int32[8,16]: running max of the first
    # left-aligned 32-bit value whose code is longer than l+1 bits
    limits: torch.Tensor
    slots: torch.Tensor  # int32[du_per_mcu, 2]: (dc, ac) table per data unit
    natural: torch.Tensor  # int32[64] zig-zag index -> raster index


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap int64 values into int32 range, staying in int64."""
    return ((x + 0x80000000) & _M32) - 0x80000000


def _limits(maxcode: torch.Tensor) -> torch.Tensor:
    """limits[t, j] = first 32-bit-left-aligned value whose code is longer
    than j+1 bits, as int32 bit patterns; the running max makes empty
    lengths inherit, so that `data >= limits[j]` is exactly "code length >
    j+1". A saturated table would overflow 32 bits here and is routed to
    the maxcode path."""
    shift = 31 - torch.arange(16, device=maxcode.device, dtype=torch.int64)
    raw_lim = (((maxcode.to(torch.int64) + 1) & _M32) << shift) & _M32
    return _wrap_i32(torch.cummax(raw_lim, dim=1).values).to(torch.int32)


def make_ctx(cfg: ScanConfig, arrs: ScanArrays, num_subseq=None) -> Ctx:
    """Build the decode context on the device of ``arrs``. ``num_subseq``,
    if given, makes exactly the lanes below it valid (a shard of the
    sharded decode, where every shard owns a different number of
    subsequences)."""
    dev = arrs.words.device
    lanes = cfg.lanes
    if lanes * C.SUBSEQ_SIZE_BITS > C.I32_MAX:
        raise ValueError(f"{lanes} lanes: bit offsets overflow int32")
    limits = _limits(arrs.maxcode)

    slots = np.zeros((cfg.du_per_mcu, 2), np.int32)
    start = 0
    for end, dc_slot, ac_slot in cfg.comp_groups:
        slots[start:end] = (dc_slot, ac_slot)
        start = end

    lane = torch.arange(lanes, device=dev, dtype=torch.int32)
    rel = lane - arrs.seg_first_lane
    if num_subseq is None:
        # data-driven validity: a lane is real iff its index within its
        # segment is below the segment's subsequence count (padded lanes
        # inherit the last segment's table entries, putting rel >= count)
        lane_valid = (rel >= 0) & (rel < arrs.seg_num_subseq)
    else:
        lane_valid = lane < num_subseq
    return Ctx(
        word_end=(arrs.seg_first_lane + arrs.seg_num_subseq) * C.CHUNK_SIZE_WORDS,
        seg_base_bits=arrs.seg_first_lane * C.SUBSEQ_SIZE_BITS,
        end_subseq=(rel + 1) * C.SUBSEQ_SIZE_BITS,
        rel=rel,
        lane_valid=lane_valid,
        first_of_seg=rel == 0,
        limits=limits,
        slots=torch.from_numpy(slots).to(dev),
        natural=torch.from_numpy(np.array(C.ORDER_NATURAL, np.int32)).to(dev),
    )


# --- plain symbol decode (lock-step over lanes, int64 arithmetic) -----------

@dataclasses.dataclass
class _Plain:
    """The operands of the plain symbol step, widened to int64 once per
    pass rather than once per symbol."""

    words: torch.Tensor  # word values in [0, 2^32), the lead words first
    lead: int  # ScanArrays.lead_words
    word_end: torch.Tensor
    seg_base_bits: torch.Tensor
    end_subseq: torch.Tensor
    slots: torch.Tensor
    limits: torch.Tensor  # uint32 values
    maxcode: torch.Tensor
    vsm: torch.Tensor
    huffval: torch.Tensor


def _plain_operands(arrs: ScanArrays, ctx: Ctx) -> _Plain:
    words = arrs.words
    lead = arrs.lead_words
    if lead:
        # word -1 is the staged word before the shard (ScanArrays.lead_words)
        words = words.as_strided((words.numel() + lead,), (1,),
                                 words.storage_offset() - lead)
    i64 = torch.int64
    return _Plain(
        words=words.to(i64) & _M32, lead=lead,
        word_end=ctx.word_end.to(i64), seg_base_bits=ctx.seg_base_bits.to(i64),
        end_subseq=ctx.end_subseq.to(i64), slots=ctx.slots.to(i64),
        limits=ctx.limits.to(i64) & _M32, maxcode=arrs.maxcode.to(i64),
        vsm=arrs.vsm.to(i64), huffval=arrs.huffval.to(i64))


def _load32(t: _Plain, p: torch.Tensor) -> torch.Tensor:
    """Next 32 bits MSB-aligned at segment-relative bit ``p`` as int64 in
    [0, 2^32), zero past the segment end."""
    abs_bit = t.seg_base_bits + p
    w = abs_bit >> 5
    b = abs_bit & 31
    last = t.words.numel() - 1

    def word(i):
        v = t.words[(i + t.lead).clamp(0, last)]
        return torch.where(i < t.word_end, v, 0)

    hi = (word(w) << b) & _M32
    return hi | (word(w + 1) >> (32 - b))


def _category_fast(t: _Plain, data, tbl):
    """Canonical-limit category decode (exact for unsaturated tables):
    ``data >= limits[j]`` is precisely "code longer than j+1 bits", so the
    length is a count of limit comparisons. Returns the 0-based length."""
    lim = t.limits.index_select(0, tbl)
    return (data[:, None] >= lim[:, :15]).sum(dim=1)


def _category_slow(t: _Plain, data, tbl):
    """maxcode-comparison category decode (handles saturated tables): the
    first length l whose l-bit prefix is <= maxcode[l]; 16 always ends."""
    iota16 = torch.arange(16, device=data.device, dtype=torch.int64)
    codes = data[:, None] >> (31 - iota16)[None, :]
    maxcode = t.maxcode.index_select(0, tbl)
    le = (codes <= maxcode) | (iota16 == 15)[None, :]
    return le.to(torch.int8).argmax(dim=1)


def _code(fast_tables: bool, t: _Plain, data, tbl):
    """Code length and symbol value (``huffval`` entry) of the code at the
    top of ``data`` in table ``tbl``, int64: the canonical-limit search
    where ``fast_tables``, else the maxcode walk."""
    if fast_tables:
        l_idx = _category_fast(t, data, tbl)
    else:
        l_idx = _category_slow(t, data, tbl)
    cat_len = l_idx + 1
    code = data >> (32 - cat_len)
    vsm = t.vsm[tbl, l_idx]
    idx = (vsm + code) & 0xFF
    return cat_len, t.huffval[tbl * 256 + idx]


def _extend(data, cat_len, cat):
    """The value bits after a code of ``cat_len`` bits, EXTENDed (T.81
    F.12); shift amounts guarded for a garbage category, int32 wraparound
    written out, 0 where ``cat`` is 0."""
    off = ((data << (cat_len & 31)) & _M32) >> ((32 - cat) & 31)
    off = _wrap_i32(off)
    one = _wrap_i32(torch.ones_like(cat) << cat.clamp(max=31))
    half = one >> 1
    value = torch.where(off < half, _wrap_i32(off - one + 1), off)
    return torch.where(cat > 0, value, 0)


def _decode_symbol(cfg: ScanConfig, t: _Plain, data, c, z,
                   need_value: bool = True):
    """One symbol on all lanes. Returns (length, sym, run), int64.

    With ``need_value=False`` (sync passes, which only track states) the
    EXTEND value is not computed and sym is 0.
    """
    is_dc = z == 0
    pair = t.slots.index_select(0, c)  # (lanes, 2)
    tbl = torch.where(is_dc, pair[:, 0], pair[:, 1])
    cat_len, sym_cat = _code(cfg.fast_tables, t, data, tbl)

    run_ac = sym_cat >> 4
    cat_ac = sym_cat & 0xF
    cat = torch.where(is_dc, sym_cat, cat_ac)
    # EOB fills the data unit, ZRL skips 16
    eob_or_zrl = torch.where(run_ac == 15, 15, 63 - z)
    run = torch.where(is_dc, 0, torch.where(cat_ac == 0, eob_or_zrl, run_ac))
    length = cat_len + cat
    if not need_value:
        return length, torch.zeros_like(cat), run
    return length, _extend(data, cat_len, cat), run


# --- the one-lookup symbol table of K1, K2 and K4 ---------------------------
#
# Entry [slot << SYMTAB_BITS | prefix] (int16) holds what a code whose first
# SYMTAB_BITS bits are `prefix` decodes to in table `slot`, as a symbol of
# the slot's class: DC for an even slot, AC for an odd one (slot = table id
# * 2 + class, so a scan names even slots for DC only and odd ones for AC).
# An entry packs the symbol's total length (code plus value bits, 5 bits),
# its category (the value bits, 5), its AC run (4; 15 for ZRL), an EOB flag
# (the EOB run 63 - z depends on z, so the kernel computes it) and an
# escape flag: a code longer than SYMTAB_BITS bits, or a symbol of 32 bits
# or more (only a garbage DC category is that long, and it takes the
# reader's `seek`). An escaped symbol goes through _decode_symbol's search
# unchanged.

SYMTAB_BITS = 10
SYMTAB_RUN_SHIFT = 10
SYMTAB_EOB = 1 << 14
SYMTAB_ESC = 1 << 15


def check_slot_classes(cfg: ScanConfig, where: str) -> None:
    """The symbol table reads a slot in its own class: refuse a scan
    geometry that names an odd slot for DC or an even one for AC (a parsed
    stream never does)."""
    for _, dc, ac in cfg.comp_groups:
        if dc % 2 != C.HUFF_DC or ac % 2 != C.HUFF_AC:
            raise ValueError(
                f"{where}: the symbol table needs DC tables in even slots and "
                f"AC tables in odd ones, got (dc {dc}, ac {ac})")


def build_symbol_table(maxcode, vsm, huffval, fast_tables: bool) -> np.ndarray:
    """The per-scan symbol table of K1, K2 and K4 from the packed Huffman
    tables (numpy int32 ``[8, 16]``, ``[8, 16]``, ``[8 * 256]``), as numpy
    int16[8 << SYMTAB_BITS], built on the host under the scan's
    ``fast_tables``.

    Exact by construction: the code length and symbol come from
    :func:`_code`, the function :func:`_decode_symbol` calls, applied to
    each prefix followed by zeros. Both searches decide a length of at
    most SYMTAB_BITS from the prefix alone (``limits[j]`` carries only its
    top j+1 bits, and the maxcode walk compares j+1-bit prefixes), so the
    tail does not matter wherever the entry does not escape."""
    nb = SYMTAB_BITS
    i64 = torch.int64
    mc = torch.from_numpy(np.asarray(maxcode, np.int32).reshape(8, 16))
    t = _Plain(words=None, lead=0, word_end=None, seg_base_bits=None,
               end_subseq=None, slots=None,
               limits=_limits(mc).to(i64) & _M32, maxcode=mc.to(i64),
               vsm=torch.from_numpy(
                   np.asarray(vsm, np.int32).reshape(8, 16)).to(i64),
               huffval=torch.from_numpy(
                   np.asarray(huffval, np.int32).reshape(-1)).to(i64))
    tbl = torch.arange(8, dtype=i64).repeat_interleave(1 << nb)
    data = torch.arange(1 << nb, dtype=i64).repeat(8) << (32 - nb)
    cat_len, sym_cat = _code(fast_tables, t, data, tbl)
    is_dc = tbl % 2 == C.HUFF_DC
    run_ac, cat_ac = sym_cat >> 4, sym_cat & 0xF
    cat = torch.where(is_dc, sym_cat, cat_ac)
    eob = ~is_dc & (cat_ac == 0) & (run_ac != 15)
    run = torch.where(is_dc | eob, 0, run_ac)
    length = cat_len + cat
    entry = torch.where(
        (cat_len > nb) | (length >= 32), SYMTAB_ESC,
        length | (cat << 5) | (run << SYMTAB_RUN_SHIFT)
        | torch.where(eob, SYMTAB_EOB, 0))
    return (((entry + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16).numpy()


# Huffman tables no encoder writes, for the checks of the symbol table's
# escapes (the tests and chip_smoke.py): per slot 0-3, the code counts by
# length in bits and the symbol values. "saturated": full code spaces, so
# that a plan takes the maxcode walk. "garbage": slot 0 holds DC
# categories above 15 (symbols of 32 bits and more, the reader's seek),
# slots 1 and 2 codes of up to 16 bits (escapes of the table), slot 3 AC
# categories above 10.
MADE_UP_TABLES = {
    "saturated": (({1: 1, 2: 1, 3: 2}, [0, 3, 20, 200]),
                  ({2: 2, 4: 5, 9: 40}, list(range(1, 48))),
                  ({1: 2}, [0, 5]),
                  ({1: 2}, [0x00, 0x11])),
    "garbage": (({2: 2, 3: 2, 4: 2, 5: 2, 6: 3},
                 [0, 16, 17, 20, 25, 27, 28, 29, 30, 31, 255]),
                ({2: 1, 9: 120, 12: 40, 14: 50, 16: 45}, "random"),
                ({1: 1, 10: 100, 11: 100, 16: 50},
                 [v % 12 for v in range(251)]),
                ({2: 2, 3: 2, 6: 9},
                 [0x00, 0xF0, 0x01, 0x11, 0x0F, 0xFF, 0x3A, 0x15, 0x2E,
                  0xA1, 0x08, 0xE9, 0x71])),
}


def made_up_tables(kind: str):
    """The packed tables of ``MADE_UP_TABLES[kind]`` (slot 1's "random"
    values are 256 bytes from numpy seed 9) and the ``fast_tables`` a plan
    would take for them: (maxcode, vsm, huffval, fast_tables)."""
    from ..tables import build_huffman_table, pack_huffman_tables

    tables = []
    for by_length, values in MADE_UP_TABLES[kind]:
        counts = np.zeros(16, np.int64)
        for length, n in by_length.items():
            counts[length - 1] = n
        if values == "random":
            values = np.random.default_rng(9).integers(0, 256, 256)
        tables.append(build_huffman_table(counts, np.asarray(values, np.uint8)))
    return (*pack_huffman_tables(tables),
            not any(t.saturated for t in tables))


def _decode_symbol_table(cfg: ScanConfig, t: _Plain, symtab, data, c, z):
    """Tensor model of the kernels' table decode (``next_symbol`` in
    ``kernels/csrc/huffman_common.cuh``), statement by statement, for the
    tests: the data unit's table slot for z, one lookup keyed by the next
    SYMTAB_BITS bits, and for an escaped symbol :func:`_decode_symbol`.
    ``symtab`` is int64. Returns (length, category, run, value), int64;
    the category of an escaped symbol is that of :func:`_decode_symbol`,
    recovered from its length."""
    nb = SYMTAB_BITS
    pair = t.slots.index_select(0, c)
    tbl = torch.where(z == 0, pair[:, 0], pair[:, 1])
    f = symtab[(tbl << nb) + (data >> (32 - nb))] & 0xFFFF
    length = f & 31
    cat = (f >> 5) & 31
    run = torch.where((f & SYMTAB_EOB) != 0, 63 - z,
                      (f >> SYMTAB_RUN_SHIFT) & 15)
    value = _extend(data, length - cat, cat)
    esc = (f & SYMTAB_ESC) != 0
    e_len, e_val, e_run = _decode_symbol(cfg, t, data, c, z)
    e_cat = e_len - _code(cfg.fast_tables, t, data, tbl)[0]
    return (torch.where(esc, e_len, length), torch.where(esc, e_cat, cat),
            torch.where(esc, e_run, run), torch.where(esc, e_val, value))


def _symbol_step(cfg: ScanConfig, t: _Plain, p, c, z, active,
                 need_value: bool = True):
    """One masked symbol step; returns (p, c, z, sym, run, commit)."""
    data = _load32(t, p)
    length, sym, run = _decode_symbol(cfg, t, data, c, z, need_value)
    commit = active & (p + length <= t.end_subseq)
    p = torch.where(commit, p + length, p)
    z_new = z + run + 1
    wrap = z_new >= 64
    c_new = torch.where(wrap, c + 1, c)
    c_new = torch.where(c_new >= cfg.du_per_mcu, 0, c_new)
    z = torch.where(commit, torch.where(wrap, 0, z_new), z)
    c = torch.where(commit, c_new, c)
    return p, c, z, sym, run, commit


# --- K1: one sync round over every lane's own subsequence -------------------

def _check_lane_tensors(where: str, dev: torch.device, lanes: int, **tensors):
    for name, (t, dtype) in tensors.items():
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or t.numel() != lanes):
            raise ValueError(
                f"{where}: {name} must be a contiguous {dtype} tensor of "
                f"{lanes} elements on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _symtab_ptrs(where: str, cfg: ScanConfig, arrs: ScanArrays, ctx: Ctx,
                 dev: torch.device):
    """The symbol table and the packed tables of the escape path, as K1,
    K2 and K4 take them."""
    check_slot_classes(cfg, where)
    _check_lane_tensors(where, dev, 8 << SYMTAB_BITS,
                        symtab=(arrs.symtab, torch.int16))
    tabs = (arrs.maxcode, arrs.vsm, ctx.limits, arrs.huffval)
    for t in tabs:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("Huffman tables must be contiguous int32 "
                             f"tensors on {dev}")
    return [arrs.symtab.data_ptr()] + [t.data_ptr() for t in tabs]


def slot_pairs(cfg: ScanConfig) -> int:
    """The (DC, AC) table slots of the MCU's data units packed for K1, K2
    and K4, 6 bits a data unit (DC in the low 3), from the static geometry: a
    kernel argument, so that no block waits on a load before it copies its
    tables."""
    pairs, start = 0, 0
    for end, dc, ac in cfg.comp_groups:
        for i in range(start, end):
            pairs |= (dc | ac << 3) << (6 * i)
        start = end
    return pairs


def decode_pass_plain(cfg, arrs, ctx, p0, c0, z0, active0):
    """One decode pass, all lanes in lock step, one symbol per iteration:
    each active lane decodes its own subsequence from (p0, c0, z0) until
    its next symbol would cross its subsequence end. Returns int32 (p, c,
    z, n); n counts coefficient positions (run + 1 per symbol)."""
    t = _plain_operands(arrs, ctx)
    p, c, z = p0.to(torch.int64), c0.to(torch.int64), z0.to(torch.int64)
    n = torch.zeros_like(p)
    active = active0 & (p < t.end_subseq)
    while bool(active.any()):
        p, c, z, _, run, commit = _symbol_step(
            cfg, t, p, c, z, active, need_value=False)
        n = torch.where(commit, n + run + 1, n)
        active = commit
    return tuple(x.to(torch.int32) for x in (p, c, z, n))


def subseq_pass_plain(cfg, arrs, ctx, p, c, z, valid, *, entry=None,
                      flag=None):
    """Plain version of :func:`subseq_pass`, the whole round: the start
    states (segment firsts blind, lane 0 from ``entry``, every other lane
    from its predecessor's state by ``torch.roll``), :func:`decode_pass_plain`,
    the freeze of the lanes that are not ``valid`` and the convergence
    test, on whatever device holds the tensors."""
    blind_p = ctx.rel * C.SUBSEQ_SIZE_BITS
    zeros = torch.zeros_like(blind_p)
    first = ctx.first_of_seg
    if p is None:
        starts = (blind_p, zeros, zeros)
    else:
        # start of lane i = end state of lane i-1; segment firsts are exact
        starts = _enter(ctx, (torch.where(first, blind_p, torch.roll(p, 1)),
                              torch.where(first, zeros, torch.roll(c, 1)),
                              torch.where(first, zeros, torch.roll(z, 1))),
                        entry)
    p2, c2, z2, n2 = decode_pass_plain(cfg, arrs, ctx, *starts, valid)
    # padded lanes stay frozen so they never delay convergence
    p2 = torch.where(valid, p2, blind_p)
    c2 = torch.where(valid, c2, zeros)
    z2 = torch.where(valid, z2, zeros)
    n2 = torch.where(valid, n2, zeros)
    if flag is not None:
        # lanes whose start state comes from a predecessor (torch.roll
        # wraps the last lane into lane 0, which is a segment first or
        # takes the fixed `entry`: it never re-enters)
        frontier_ok = ~first & valid
        if entry is not None:
            frontier_ok = frontier_ok & (
                torch.arange(cfg.lanes, device=valid.device) > 0)
        delta = (p2 != p) | (c2 != c) | (z2 != z)
        flag |= (torch.roll(delta, 1) & frontier_ok).any().to(flag.dtype)
    return p2, c2, z2, n2


def subseq_pass(cfg: ScanConfig, arrs: ScanArrays, ctx: Ctx, p, c, z, valid,
                *, entry=None, flag=None):
    """One round of :func:`sync_states`. Lane i starts blind at
    ``(rel * 1024, 0, 0)`` where ``p`` is None (the blind round) or it is
    the first of its segment; lane 0 starts from ``entry`` (an int32[3]
    tensor, or a ``(p, c, z)`` triple) where that is given and lane 0 is
    not a segment first; every other lane starts from lane i-1's state in
    ``(p, c, z)``, the previous round's. Each ``valid`` lane then decodes
    its own subsequence until its next symbol would cross the subsequence
    end; the other lanes are frozen at ``(rel * 1024, 0, 0, 0)``. Where
    ``flag`` (int32[1]) is given, it is raised (set to 1, never cleared)
    if a lane whose start state comes from its predecessor has a
    predecessor whose state changed, ``torch.roll(delta, 1) & frontier_ok``
    as a whole. Returns int32 (p, c, z, n), n the coefficient positions
    (run + 1 per symbol) the lane produced.

    CUDA tensors: kernel K1 (``kernels/csrc/subseq_pass.cu``; replaces the
    Pallas kernel behind ``jpeggpu_tpu/ops/huffman_pallas.py:
    subseq_pass``), the whole round in one launch. Bound by the dependent
    instructions per symbol of the slowest lane, not by bytes; see the
    note in the source. CPU tensors: the plain version.
    """
    dev = (valid if p is None else p).device
    if dev.type == "cpu":
        return subseq_pass_plain(cfg, arrs, ctx, p, c, z, valid, entry=entry,
                                 flag=flag)
    if dev.type != "cuda":
        raise ValueError(f"subseq_pass: unsupported device {dev}")
    lanes = cfg.lanes
    i32 = torch.int32
    lane_in = dict(valid=(valid, torch.bool), word_end=(ctx.word_end, i32),
                   seg_base_bits=(ctx.seg_base_bits, i32),
                   end_subseq=(ctx.end_subseq, i32), rel=(ctx.rel, i32))
    if p is not None:
        lane_in.update(p=(p, i32), c=(c, i32), z=(z, i32))
    _check_lane_tensors("subseq_pass", dev, lanes, **lane_in)
    _check_lane_tensors("subseq_pass", dev, lanes * C.CHUNK_SIZE_WORDS,
                        words=(arrs.words, i32))
    entry = _entry_tensor(entry, dev)
    if entry is not None:
        _check_lane_tensors("subseq_pass", dev, 3, entry=(entry, i32))
    if flag is not None:
        if p is None:
            raise ValueError("subseq_pass: the blind round has no "
                             "convergence flag")
        _check_lane_tensors("subseq_pass", dev, 1, flag=(flag, i32))
    out = torch.empty((4, lanes), dtype=i32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = kernels.get("jpeggpu_subseq_pass")
    err = fn(arrs.words.data_ptr(), ctx.word_end.data_ptr(),
             ctx.seg_base_bits.data_ptr(), ctx.end_subseq.data_ptr(),
             ctx.rel.data_ptr(), valid.data_ptr(),
             *_symtab_ptrs("subseq_pass", cfg, arrs, ctx, dev),
             ptr(p), ptr(c), ptr(z), ptr(entry),
             out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
             out[3].data_ptr(), ptr(flag), slot_pairs(cfg), lanes,
             cfg.du_per_mcu, int(cfg.fast_tables),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "subseq_pass")
    subseq_pass.launches += 1
    return out[0], out[1], out[2], out[3]


subseq_pass.launches = 0


def _entry_tensor(entry, dev: torch.device):
    """A boundary state ``(p, c, z)`` (ints or 0-d tensors, or an int32[3]
    tensor) as a contiguous int32[3] tensor on ``dev``; None stays None."""
    if entry is None or isinstance(entry, torch.Tensor):
        return (None if entry is None
                else entry.to(device=dev, dtype=torch.int32).reshape(3)
                .contiguous())
    return torch.stack([torch.as_tensor(v, dtype=torch.int32, device=dev)
                        for v in entry])


def _enter(ctx: Ctx, starts, entry):
    """Lane 0's start state from ``entry``, a ``(p, c, z)`` triple of ints
    or 0-d tensors, where lane 0 is not a segment first; ``starts``
    unchanged where ``entry`` is None."""
    if entry is None:
        return starts
    use = ~ctx.first_of_seg[:1]
    out = []
    for s, e in zip(starts, entry):
        e = torch.as_tensor(e, dtype=s.dtype, device=s.device).reshape(1)
        out.append(torch.cat([torch.where(use, e, s[:1]), s[1:]]))
    return tuple(out)


# --- K1's gathered mode: one pass over a compacted set of lanes -------------

def subseq_pass_at_plain(cfg, arrs, ctx, idx, sp, sc, sz, active):
    """Plain version of :func:`subseq_pass_at`: :func:`decode_pass_plain`
    over the context gathered by ``idx``."""
    i = idx.to(torch.int64)
    gathered = dataclasses.replace(
        ctx, word_end=ctx.word_end[i], seg_base_bits=ctx.seg_base_bits[i],
        end_subseq=ctx.end_subseq[i])
    return decode_pass_plain(cfg, arrs, gathered, sp, sc, sz, active)


def subseq_pass_at(cfg: ScanConfig, arrs: ScanArrays, ctx: Ctx, idx, sp, sc,
                   sz, active):
    """One decode pass over a gathered set of lanes, the pass of a
    compacted sync round: column i decodes the subsequence of lane
    ``idx[i]`` (int32, in ``[0, cfg.lanes)``) from the explicit start
    ``(sp[i], sc[i], sz[i])`` where ``active[i]``, until its next symbol
    would cross that lane's end. Returns int32 ``(p, c, z, n)`` of the
    width of ``idx``; an inactive column keeps its start, with ``n`` 0.
    An active start lies where a predecessor's end state can: at most 31
    bits before the lane's subsequence and not before its segment (the
    kernel reads no word before ``ScanArrays.lead_words``).

    CUDA tensors: kernel K1 in its gathered mode
    (``kernels/csrc/subseq_pass.cu``, ``jpeggpu_subseq_pass_at``; replaces
    the Pallas kernel behind ``jpeggpu_tpu/ops/huffman_pallas.py:
    subseq_pass`` run on a context that ``make_ctx_gatherer`` compacted),
    one launch; the kernel reads the lane's context at ``idx[i]`` itself.
    CPU tensors: the plain version.
    """
    dev = idx.device
    if dev.type == "cpu":
        return subseq_pass_at_plain(cfg, arrs, ctx, idx, sp, sc, sz, active)
    if dev.type != "cuda":
        raise ValueError(f"subseq_pass_at: unsupported device {dev}")
    width = idx.numel()
    i32 = torch.int32
    _check_lane_tensors("subseq_pass_at", dev, width, idx=(idx, i32),
                        sp=(sp, i32), sc=(sc, i32), sz=(sz, i32),
                        active=(active, torch.bool))
    _check_lane_tensors("subseq_pass_at", dev, cfg.lanes,
                        word_end=(ctx.word_end, i32),
                        seg_base_bits=(ctx.seg_base_bits, i32),
                        end_subseq=(ctx.end_subseq, i32))
    _check_lane_tensors("subseq_pass_at", dev,
                        cfg.lanes * C.CHUNK_SIZE_WORDS,
                        words=(arrs.words, i32))
    out = torch.empty((4, width), dtype=i32, device=dev)
    fn = kernels.get("jpeggpu_subseq_pass_at")
    err = fn(arrs.words.data_ptr(), ctx.word_end.data_ptr(),
             ctx.seg_base_bits.data_ptr(), ctx.end_subseq.data_ptr(),
             idx.data_ptr(), sp.data_ptr(), sc.data_ptr(), sz.data_ptr(),
             active.data_ptr(),
             *_symtab_ptrs("subseq_pass_at", cfg, arrs, ctx, dev),
             out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
             out[3].data_ptr(), slot_pairs(cfg), width, cfg.du_per_mcu,
             int(cfg.fast_tables), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "subseq_pass_at")
    subseq_pass_at.launches += 1
    return out[0], out[1], out[2], out[3]


subseq_pass_at.launches = 0


# --- the synchronisation -----------------------------------------------------

def _resolve_sync_tiers(cfg: ScanConfig, dev: torch.device) -> Optional[str]:
    """The shape of the compacted tiers that :func:`sync_states` runs on
    ``dev``: None (full-width Jacobi rounds) where the plan's tuning names
    none of the seven sync fields, else ``Tuning.sync_tiers``, whose "auto"
    resolves as the JAX package's does on the same kind of device:
    "classic" on the CPU, "ladder" on the card (see ``config.Tuning``)."""
    t = cfg.tuning
    if not t.names_sync_tiers:
        return None
    if t.sync_tiers != "auto":
        return t.sync_tiers
    return "classic" if dev.type == "cpu" else "ladder"


def _resolve_frontier_width(cfg: ScanConfig, dev: torch.device) -> int:
    """``Tuning.frontier_width``; 0 (auto) is 0, the Jacobi, where the
    tuning names no sync field, else the JAX package's auto: lanes / 4 for
    the ladder (its top tier is the compaction budget), lanes / 12 for the
    classic tiers, so that the width scales with a merged batch's lanes."""
    fw = cfg.tuning.frontier_width
    if fw:
        return fw
    tiers = _resolve_sync_tiers(cfg, dev)
    if tiers is None:
        return 0
    if tiers == "ladder":
        return max(128, cfg.lanes // 4)
    return max(2048, cfg.lanes // 12)


def _compact_round(cfg: ScanConfig, arrs: ScanArrays, ctx: Ctx,
                   st: torch.Tensor, head: torch.Tensor, follow: int, entry,
                   launches: Optional[list] = None):
    """One chain-follow round over the chain heads ``head`` (int32[width],
    sorted, dead heads at the ``lanes`` sentinel), each advanced up to
    ``follow`` columns; updates the states ``st`` (int32[4, lanes + slots],
    rows p, c, z, n; the columns past ``lanes`` take the dropped writes)
    in place and returns the next heads.

    The port of ``compact_round`` (``jpeggpu_tpu/ops/huffman.py``): a chain
    is bounded by the closest live head above, so its columns never meet
    another chain's and the heads stay sorted and distinct; the chain stops
    at its first column that is not a real lane or is a segment first
    (past the head), and phase f starts from phase f-1's fresh end state,
    the head from its predecessor's state of the previous round (``entry``
    at lane 0). ``p``, ``c`` and ``z`` are written where they changed, ``n``
    for every decoded column. The next head is the successor of the one
    column that changed without its successor decoded in this round. One
    launch of :func:`subseq_pass_at` a phase; no host read. ``launches``,
    if a list, receives each launch's inputs ``(idx, sp, sc, sz, active)``
    (copies)."""
    lanes = cfg.lanes
    width = head.numel()
    dev = head.device
    i32 = torch.int32
    offs = torch.arange(follow, dtype=i32, device=dev)
    alive = head < lanes
    headc = head.clamp(0, lanes - 1)
    # bound[j] = the closest live head above (dead heads never bound)
    nxt = torch.cat([head[1:], head.new_full((1,), lanes)])
    bound = torch.cummin(nxt.flip(0), 0).values.flip(0)
    idx2 = headc[:, None] + offs[None, :]  # (width, follow) columns
    idx2c = idx2.clamp(max=lanes - 1)
    cols = idx2c.to(torch.int64)
    okcol = (alive[:, None] & (idx2 < bound[:, None]) & (idx2 < lanes)
             & ctx.lane_valid[cols]
             & ((offs == 0)[None, :] | ~ctx.first_of_seg[cols]))
    # chains stop at the first bad column (cumulative AND along f)
    ok = torch.cumprod(okcol.to(i32), dim=1).bool()
    p, c, z = st[0, :lanes], st[1, :lanes], st[2, :lanes]
    prevh = (headc - 1).clamp(min=0).to(torch.int64)
    sp, sc, sz = p[prevh], c[prevh], z[prevh]
    if entry is not None:
        at0 = headc == 0
        sp, sc, sz = (torch.where(at0, e, s)
                      for e, s in zip(entry, (sp, sc, sz)))
    changed = alive  # heads always re-decode (their predecessor changed)
    new, act, chs, mark = [], [], [], []
    for f in range(follow):
        colf = cols[:, f]
        activef = ok[:, f] & changed
        args = (idx2c[:, f].contiguous(), sp, sc, sz, activef)
        if launches is not None:
            launches.append(tuple(a.clone() for a in args))
        p2, c2, z2, n2 = subseq_pass_at(cfg, arrs, ctx, *args)
        ch = activef & ((p2 != p[colf]) | (c2 != c[colf]) | (z2 != z[colf]))
        # the chain goes on past this round only from a changed column
        # whose successor was not decoded as the next phase
        nxt_dec = ok[:, f + 1] if f + 1 < follow else torch.zeros_like(ch)
        new.append(torch.stack([p2, c2, z2, n2]))
        act.append(activef)
        chs.append(ch)
        mark.append(ch & ~nxt_dec)
        sp, sc, sz = p2, c2, z2
        changed = ch
    act, chs, mark = (torch.stack(t, 1) for t in (act, chs, mark))
    new = torch.stack(new, 2).reshape(4, -1)  # (4, width * follow)
    # decoded columns are disjoint; dropped ones go to distinct slots
    # past `lanes`
    drop = lanes + torch.arange(width * follow, dtype=i32,
                                device=dev).reshape(width, follow)
    upd_s = torch.where(chs, idx2c, drop).reshape(-1).to(torch.int64)
    upd_n = torch.where(act, idx2c, drop).reshape(-1).to(torch.int64)
    st[:3, upd_s] = new[:3]
    st[3, upd_n] = new[3]
    # next head = successor of the (single) marked column, kept only where
    # it is a real lane and not a segment first
    cand = torch.where(mark, idx2 + 1, 0).sum(1).to(i32)
    candc = cand.clamp(max=lanes - 1).to(torch.int64)
    keep = (mark.any(1) & (cand < lanes) & ctx.lane_valid[candc]
            & ~ctx.first_of_seg[candc])
    return torch.where(keep, cand, lanes)


def sync_states(cfg: ScanConfig, arrs: ScanArrays, ctx: Ctx,
                frontier_width: Optional[int] = None, diag: bool = False,
                entry=None, record: Optional[dict] = None):
    """Fixed-point synchronisation of subsequence decoder states.

    Round 0 decodes every subsequence speculatively ("blind"); round 1
    re-decodes every subsequence from its predecessor's end state (almost
    all lanes self-synchronise here). Then one of two modes, resolved from
    the plan's tuning (``config.Tuning``, :func:`_resolve_frontier_width`):

    - ``frontier_width`` 0, the default: full-width rounds until no lane's
      predecessor changed. Every round is one :func:`subseq_pass`, which
      raises that round's own convergence flag; reading it back is the
      round's one host read.
    - the compacted tiers of the JAX package: full-width rounds (one
      :func:`subseq_pass` and a count of the frontier, its host read)
      while more than ``frontier_width`` lanes have a predecessor that
      changed, then chain-follow rounds (:func:`_compact_round`, one
      :func:`subseq_pass_at` a phase) over the chain heads, in the tiers
      of ``Tuning.sync_tiers``: "ladder", one tier per halving width, or
      "classic", wide, narrow and tail tiers. A tier's rounds run while
      more heads live than the next tier holds (one host read a round).

    ``entry``, if given, is a ``(p, c, z)`` triple (or an int32[3] tensor)
    used as lane 0's predecessor state when lane 0 is not a segment first:
    the boundary state of a subsequence shard (parallel/segments.py),
    segment-relative like every decoder state, so it transfers between
    shards unchanged; lane 0 then never re-enters the frontier.

    Returns converged int32 (p, c, z, n) per subsequence: the state *after*
    decoding subsequence i, with n its coefficient-position count. With
    ``diag`` also the JAX package's round counts ``(it0, it)``: the
    full-width rounds after round 1 (and the classic wide tier's), and all
    rounds after round 1. ``record``, if a dict, receives under "rounds"
    the rounds after round 1 by tier ("full" for the full-width rounds,
    "wide", "narrow" and "tail" for the classic tiers, "ladder <width>"),
    and under "gathered", where it holds a list, the inputs of every
    launch of :func:`subseq_pass_at`.
    """
    valid = ctx.lane_valid
    dev = valid.device
    lanes = cfg.lanes
    entry = _entry_tensor(entry, dev)
    record = {} if record is None else record
    launches = record.get("gathered")
    if frontier_width is None:
        frontier_width = _resolve_frontier_width(cfg, dev)
    p, c, z, n = subseq_pass(cfg, arrs, ctx, None, None, None, valid)
    if frontier_width == 0:
        flags = torch.zeros(lanes + 1, dtype=torch.int32, device=dev)
        for r in range(lanes + 1):
            p, c, z, n = subseq_pass(cfg, arrs, ctx, p, c, z, valid,
                                     entry=entry, flag=flags[r:r + 1])
            if not bool(flags[r]):
                break
        record["rounds"] = {"full": r}
        return (p, c, z, n, r, r) if diag else (p, c, z, n)

    K = min(frontier_width, lanes)
    lane = torch.arange(lanes, dtype=torch.int32, device=dev)
    # lanes whose start comes from a predecessor that may change
    frontier_ok = ~ctx.first_of_seg & valid
    if entry is not None:
        frontier_ok = frontier_ok & (lane > 0)

    def full_round(p, c, z):
        p2, c2, z2, n2 = subseq_pass(cfg, arrs, ctx, p, c, z, valid,
                                     entry=entry)
        delta = (p2 != p) | (c2 != c) | (z2 != z)
        return p2, c2, z2, n2, torch.roll(delta, 1) & frontier_ok

    # round 1, then phase A: full-width rounds while the frontier exceeds K
    p, c, z, n, frontier = full_round(p, c, z)
    it0 = 0
    while it0 < lanes and int(frontier.sum()) > K:
        p, c, z, n, frontier = full_round(p, c, z)
        it0 += 1

    t = cfg.tuning
    F = t.chain_follow or (1 if dev.type == "cpu" else 2)
    F = min(F, max(K, 1))
    Fw = min(t.wide_follow or 1, max(K, 1))
    Kc = min(t.head_width or max(1, K // F), lanes, max(K, 1))
    Kt = t.tail_width or 64
    Ft = min(t.tail_follow or 4, max(Kt, 1))
    ladder = _resolve_sync_tiers(cfg, dev) == "ladder"
    if ladder:
        widths = []
        w = K
        while w >= 128:
            widths.append(w)
            w //= 2
        widths.append(max(w, 32))
        slots = max(wd * (Fw if wd > 512 else F) for wd in widths)
    else:
        slots = max(K * Fw, Kc * F, Kt * Ft)
    st = torch.empty((4, lanes + slots), dtype=torch.int32, device=dev)
    st[:, :lanes] = torch.stack([p, c, z, n])
    # the first heads: the frontier's lanes in order, dead heads after
    heads = torch.sort(torch.where(frontier, lane, lanes)).values

    rounds = record["rounds"] = {"full": it0}

    def tier(name, head, follow, live_above, it):
        rounds[name] = 0
        while it < lanes and int((head < lanes).sum()) > live_above:
            head = _compact_round(cfg, arrs, ctx, st, head, follow, entry,
                                  launches)
            it += 1
            rounds[name] += 1
        return head, it

    if ladder:
        head = torch.cat([heads[:K], heads.new_full(
            (max(widths[0] - K, 0),), lanes)])
        it = it0
        for i, wd in enumerate(widths):
            nxt = widths[i + 1] if i + 1 < len(widths) else 0
            head, it = tier(f"ladder {wd}", head, Fw if wd > 512 else F,
                            nxt, it)
            if nxt:
                # the live heads, in their order, to the next width (a
                # take, as in the JAX package; they are sorted already)
                pos = torch.arange(wd, dtype=torch.int32, device=dev)
                take = torch.sort(torch.where(head < lanes, pos, wd))
                take = take.values[:nxt].to(torch.int64)
                head = torch.where(take < wd, head[take.clamp(max=wd - 1)],
                                   lanes)
    else:
        head = heads[:K]
        if Kc < K:
            # the wide tier: rounds at K heads while more than Kc live
            head, it0 = tier("wide", head, Fw, Kc, it0)
            head = torch.sort(head).values[:Kc]
        has_tail = Kt < Kc
        head, it = tier("narrow", head, F, Kt if has_tail else 0, it0)
        if has_tail:
            head, it = tier("tail", torch.sort(head).values[:Kt], Ft, 0,
                            it)
    p, c, z, n = st[:, :lanes]
    return (p, c, z, n, it0, it) if diag else (p, c, z, n)


def symbol_offsets(cfg: ScanConfig, arrs: ScanArrays,
                   n: torch.Tensor) -> torch.Tensor:
    """Per-subsequence exclusive prefix of position counts within its
    segment, int32[lanes]."""
    cum = torch.cumsum(n, dim=0)  # int64
    excl = cum - n
    base = excl[arrs.seg_first_lane.clamp(0, cfg.lanes - 1).to(torch.int64)]
    return (excl - base).to(torch.int32)


def write_start_states(ctx: Ctx, p, c, z, entry=None):
    """Per-lane start states for the writing decode: lane i continues from
    lane i-1's synced end state; segment firsts restart from zero. With
    ``entry`` (subsequence shards), lane 0 of a shard that begins
    mid-segment starts from the previous shard's boundary state instead of
    the roll wrap."""
    zeros = torch.zeros_like(p)
    sp = torch.where(ctx.first_of_seg, zeros, torch.roll(p, 1))
    sc = torch.where(ctx.first_of_seg, zeros, torch.roll(c, 1))
    sz = torch.where(ctx.first_of_seg, zeros, torch.roll(z, 1))
    return _enter(ctx, (sp, sc, sz), entry)


# --- K2: the writing decode -------------------------------------------------

def _write_inputs(cfg, arrs, ctx, p, c, z, n_off, pos_base=None, bound=None,
                  total_out=None, entry=None):
    """Start states, first position, position bound and activity of every
    lane for the writing decode, the output length, and the bound the
    direct write (K2) stores to.

    The keywords are a shard's (parallel/segments.py): ``pos_base`` (int32
    per lane) replaces the segment's first position, ``bound`` (int32 per
    lane) the segment's write bound, which is then taken as given, not
    clamped to ``total_out``; ``total_out`` replaces the scan's position
    count; ``entry`` is lane 0's boundary state (:func:`write_start_states`).
    The direct write drops a store at or past the output's end, as the
    reference's scatter does, so its bound is the given one clamped to the
    output length; the default bound is clamped already.
    """
    total = cfg.total_positions if total_out is None else total_out
    if total > C.I32_MAX:
        raise ValueError(f"{total} output positions overflow int32")
    seg = arrs.seg_of_subseq
    if pos_base is None:
        pos_base = seg * cfg.positions_per_seg
    if bound is None:
        # per-segment write bound, clamped to the real buffer size
        bound = ((seg + 1) * cfg.positions_per_seg).clamp(max=total)
        store_bound = bound
    else:
        store_bound = bound.clamp(max=total)
    sp, sc, sz = write_start_states(ctx, p, c, z, entry)
    pos0 = (pos_base + n_off).to(torch.int32)
    bound = bound.to(torch.int32)
    active0 = ctx.lane_valid & (pos0 < bound) & (sp < ctx.end_subseq)
    return (sp, sc, sz, pos0, bound, active0, total,
            store_bound.to(torch.int32))


def decode_write_plain(cfg, arrs, ctx, p, c, z, n_off, *, pos_base=None,
                       bound=None, total_out=None,
                       entry=None) -> torch.Tensor:
    """Plain version of :func:`decode_write`: all lanes in lock step, one
    symbol and one scatter per iteration, on whatever device holds the
    tensors."""
    sp, sc, sz, pos0, _, active, total, bound = _write_inputs(
        cfg, arrs, ctx, p, c, z, n_off, pos_base, bound, total_out, entry)
    t = _plain_operands(arrs, ctx)
    p, c, z = sp.to(torch.int64), sc.to(torch.int64), sz.to(torch.int64)
    pos = pos0.to(torch.int64)
    bound = bound.to(torch.int64)
    natural = ctx.natural.to(torch.int64)
    out = torch.zeros(total + 1, dtype=torch.int16, device=p.device)
    while True:
        alive = active & (pos < bound)
        if not bool(alive.any()):
            break
        p, c, z, sym, run, commit = _symbol_step(cfg, t, p, c, z, alive)
        wp = pos + run
        # writes are clamped to the lane's segment bound so a corrupt
        # segment's final run cannot overrun into the next segment's range
        do_write = commit & (sym != 0) & (wp < bound)
        tgt = (wp & ~63) + natural[wp & 63]
        # slot `total` absorbs the lanes that do not write this step
        out.index_put_((torch.where(do_write, tgt, total),),
                       torch.where(do_write, sym, 0).to(torch.int16))
        pos = torch.where(commit, wp + 1, pos)
        active = commit
    return out[:total]


def decode_write(cfg: ScanConfig, arrs: ScanArrays, ctx: Ctx, p, c, z,
                 n_off, *, pos_base=None, bound=None, total_out=None,
                 entry=None) -> torch.Tensor:
    """Final writing decode: re-decode every subsequence once from its
    synced start state, storing nonzero coefficients zig-zag -> natural
    into the stream-order coefficient buffer. Lane i owns the positions
    ``[pos0, pos0 + n)`` of its restart segment's range, so no two lanes
    store to the same element.

    CUDA tensors: kernel K2 (``kernels/csrc/decode_write.cu``; replaces
    ``jpeggpu_tpu/ops/huffman_pallas.py: decode_write_fused``, kernel,
    window scatter and overflow rounds together). Nominally bound by the
    bytes of the stream it fills, in practice by the slowest lane's chain
    of dependent instructions; see the note in the source. CPU tensors:
    the plain version.

    The keywords are a shard's (parallel/segments.py; see
    :func:`_write_inputs`).

    Returns int16[total_positions] (``total_out`` with that keyword), DC
    still difference-coded.
    """
    keywords = dict(pos_base=pos_base, bound=bound, total_out=total_out,
                    entry=entry)
    dev = p.device
    if dev.type == "cpu":
        return decode_write_plain(cfg, arrs, ctx, p, c, z, n_off, **keywords)
    if dev.type != "cuda":
        raise ValueError(f"decode_write: unsupported device {dev}")
    sp, sc, sz, pos0, _, active0, total, bound = _write_inputs(
        cfg, arrs, ctx, p, c, z, n_off, **keywords)
    lanes = cfg.lanes
    i32 = torch.int32
    _check_lane_tensors(
        "decode_write", dev, lanes, p0=(sp, i32), c0=(sc, i32), z0=(sz, i32),
        pos0=(pos0, i32), bound=(bound, i32), active0=(active0, torch.bool),
        word_end=(ctx.word_end, i32), seg_base_bits=(ctx.seg_base_bits, i32),
        end_subseq=(ctx.end_subseq, i32))
    _check_lane_tensors("decode_write", dev, lanes * C.CHUNK_SIZE_WORDS,
                        words=(arrs.words, i32))
    _check_lane_tensors("decode_write", dev, 64, natural=(ctx.natural, i32))
    out = torch.zeros(total, dtype=torch.int16, device=dev)
    fn = kernels.get("jpeggpu_decode_write")
    err = fn(arrs.words.data_ptr(), ctx.word_end.data_ptr(),
             ctx.seg_base_bits.data_ptr(), ctx.end_subseq.data_ptr(),
             *_symtab_ptrs("decode_write", cfg, arrs, ctx, dev),
             ctx.natural.data_ptr(),
             sp.data_ptr(), sc.data_ptr(), sz.data_ptr(), pos0.data_ptr(),
             bound.data_ptr(), active0.data_ptr(), out.data_ptr(),
             slot_pairs(cfg), lanes, cfg.du_per_mcu, int(cfg.fast_tables),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "decode_write")
    decode_write.launches += 1
    return out


decode_write.launches = 0


# --- K4: the writing decode, record-emission form ---------------------------

_REC_INERT = 0xFFFF  # packed record of an inert slot: value 0, local pos -1


def _emit_cap(chunk: int) -> int:
    """Record slots per subsequence: one per bit of the 1024-bit
    subsequence, plus the <= 31-bit overhang a lane can inherit when its
    predecessor stopped short of the boundary, times 8/7, rounded up to
    whole chunks. The 8/7 is the reference's allowance for the inert holes
    its decoder leaves between committed slots; this package's records are
    dense, and the factor is kept so that the buffer has the reference's
    shape and arrays can cross between the two."""
    cap = C.SUBSEQ_SIZE_BITS + 32
    cap = -(-cap * 8 // 7)
    return -(-cap // chunk) * chunk


def pack_record(val: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
    """Pack one emitted symbol as ``(val << 16) | (local_pos & 0xFFFF)``,
    int32. The value keeps its low 16 bits (a coefficient is int16-exact)
    and the lane-local position ``wl = wp - pos0`` its low 16 bits; inert
    slots carry ``wl = -1``."""
    packed = (val.to(torch.int64) << 16) | (wl.to(torch.int64) & 0xFFFF)
    return _wrap_i32(packed).to(torch.int32)


def unpack_record(rec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed int32 records -> ``(val, local_pos)``, both int32 (arithmetic
    shifts sign-extend each half)."""
    return rec >> 16, (rec << 16) >> 16


def decode_write_emit_plain(cfg, arrs, ctx, p, c, z, n_off, *, pos_base=None,
                            bound=None, total_out=None, entry=None):
    """Plain version of :func:`decode_write_emit`: all lanes in lock step,
    one symbol and one row of records per iteration, on whatever device
    holds the tensors. Unreached slots hold the inert record."""
    s_cap = _emit_cap(cfg.tuning.write_chunk)
    sp, sc, sz, pos0, bound, active, _, _ = _write_inputs(
        cfg, arrs, ctx, p, c, z, n_off, pos_base, bound, total_out, entry)
    t = _plain_operands(arrs, ctx)
    p, c, z = sp.to(torch.int64), sc.to(torch.int64), sz.to(torch.int64)
    pos = pos0.to(torch.int64)
    pos_start = pos
    bound = bound.to(torch.int64)
    rec = torch.full((s_cap, cfg.lanes), _REC_INERT, dtype=torch.int32,
                     device=p.device)
    m = torch.zeros(cfg.lanes, dtype=torch.int32, device=p.device)
    for slot in range(s_cap):
        alive = active & (pos < bound)
        if not bool(alive.any()):
            break
        p, c, z, sym, run, commit = _symbol_step(cfg, t, p, c, z, alive)
        wp = pos + run
        # the position is recorded even where the value is dropped by the
        # segment bound
        val = torch.where(commit & (wp < bound), sym, 0)
        rec[slot] = torch.where(commit, pack_record(val, wp - pos_start),
                                _REC_INERT)
        m = torch.where(commit, slot + 1, m)
        pos = torch.where(commit, wp + 1, pos)
        active = commit
    return rec, m


def decode_write_emit(cfg: ScanConfig, arrs: ScanArrays, ctx: Ctx, p, c, z,
                      n_off, *, pos_base=None, bound=None, total_out=None,
                      entry=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Writing decode, record-emission form: re-decode every subsequence
    once from its synced start state and emit one packed record per
    committed symbol.

    Returns ``(rec, m)``: ``rec[s, l]`` (int32[s_cap, lanes]) packs the
    value and the lane-local output position of lane ``l``'s ``s``-th
    symbol as ``(val << 16) | ((wp - pos0[l]) & 0xFFFF)`` (see
    :func:`pack_record`); the value is 0 for symbols that write nothing
    (EOB, ZRL, zero DC differences) and for positions at or past the
    segment's bound, whose positions are recorded all the same. ``m[l]``
    (int32[lanes]) is one past the lane's last committed slot. A consumer
    treats a slot as real iff ``s < m[l]`` and ``local_pos >= 0``; real
    slots are in stream order. Records are dense here (slot ``s`` is the
    lane's ``s``-th symbol and ``m`` its symbol count); the reference may
    leave inert holes between them, which the contract allows.

    CUDA tensors: kernel K4 (``kernels/csrc/emit_pass.cu``; replaces the
    Pallas kernel behind ``jpeggpu_tpu/ops/huffman_pallas.py: emit_pass``),
    which decodes as K2 does, by the one-lookup symbol table. Bound like
    K2 by the slowest lane's chain of dependent operations; see the note
    in the source. On the card the slots at and past ``m[l]``
    are left uninitialised (the buffer is ``torch.empty``: filling it with
    the inert record would write s_cap * lanes * 4 bytes that no consumer
    reads). CPU tensors: the plain version, which fills them. The keywords
    are a shard's, as for :func:`decode_write`; ``pos0`` is then
    ``pos_base + n_off``.
    """
    keywords = dict(pos_base=pos_base, bound=bound, total_out=total_out,
                    entry=entry)
    dev = p.device
    if dev.type == "cpu":
        return decode_write_emit_plain(cfg, arrs, ctx, p, c, z, n_off,
                                       **keywords)
    if dev.type != "cuda":
        raise ValueError(f"decode_write_emit: unsupported device {dev}")
    sp, sc, sz, pos0, bound, active0, _, _ = _write_inputs(
        cfg, arrs, ctx, p, c, z, n_off, **keywords)
    lanes = cfg.lanes
    s_cap = _emit_cap(cfg.tuning.write_chunk)
    i32 = torch.int32
    _check_lane_tensors(
        "decode_write_emit", dev, lanes, p0=(sp, i32), c0=(sc, i32),
        z0=(sz, i32), pos0=(pos0, i32), bound=(bound, i32),
        active0=(active0, torch.bool), word_end=(ctx.word_end, i32),
        seg_base_bits=(ctx.seg_base_bits, i32),
        end_subseq=(ctx.end_subseq, i32))
    _check_lane_tensors("decode_write_emit", dev, lanes * C.CHUNK_SIZE_WORDS,
                        words=(arrs.words, i32))
    rec = torch.empty((s_cap, lanes), dtype=i32, device=dev)
    m = torch.empty(lanes, dtype=i32, device=dev)
    fn = kernels.get("jpeggpu_emit_pass")
    err = fn(arrs.words.data_ptr(), ctx.word_end.data_ptr(),
             ctx.seg_base_bits.data_ptr(), ctx.end_subseq.data_ptr(),
             *_symtab_ptrs("decode_write_emit", cfg, arrs, ctx, dev),
             sp.data_ptr(), sc.data_ptr(), sz.data_ptr(), pos0.data_ptr(),
             bound.data_ptr(), active0.data_ptr(), rec.data_ptr(),
             m.data_ptr(), slot_pairs(cfg), lanes, s_cap, cfg.du_per_mcu,
             int(cfg.fast_tables), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "decode_write_emit")
    decode_write_emit.launches += 1
    return rec, m


decode_write_emit.launches = 0


def decode_scan(cfg: ScanConfig, arrs: ScanArrays, return_dc: bool = False,
                *, num_subseq=None, pos_base=None, bound=None,
                total_out=None):
    """Full entropy decode of one scan: sync, offsets, write.

    Returns int16[total_positions] stream-order coefficients (natural order
    within each data unit, DC still difference-coded). With ``return_dc``
    returns ``(coeffs, dc)`` where ``dc`` is the per-data-unit
    difference-coded DC side vector, or ``None`` when the write mode has
    none. The keywords are a segment shard's (parallel/segments.py):
    ``num_subseq`` goes to :func:`make_ctx`, the others to the write stage
    (:func:`_write_inputs`).
    """
    with scope("jpeggpu.sync", arrs.words.device):
        ctx = make_ctx(cfg, arrs, num_subseq=num_subseq)
        p, c, z, n = sync_states(cfg, arrs, ctx)
        n_off = symbol_offsets(cfg, arrs, n)
    return decode_scan_from_states(cfg, arrs, ctx, p, c, z, n_off,
                                   return_dc=return_dc, pos_base=pos_base,
                                   bound=bound, total_out=total_out)


def decode_scan_from_states(cfg: ScanConfig, arrs: ScanArrays, ctx: Ctx, p, c,
                            z, n_off, return_dc: bool = False, *,
                            pos_base=None, bound=None, total_out=None,
                            entry=None):
    """Writing decode from already-synced states: the write-stage dispatch
    of :func:`decode_scan` on ``cfg.tuning.write_mode``, callable with
    states converged elsewhere (a subsequence shard syncs across shards
    first, parallel/segments.py). The keywords go to the write stage;
    ``entry`` is the boundary start state of a lane 0 that begins
    mid-segment."""
    keywords = dict(pos_base=pos_base, bound=bound, total_out=total_out,
                    entry=entry)
    mode = cfg.tuning.write_mode
    with scope(f"jpeggpu.write.{mode}", arrs.words.device):
        if mode == "tiles":
            from . import write

            return write.decode_write_tiles(cfg, arrs, ctx, p, c, z, n_off,
                                            return_dc=return_dc, **keywords)
        coeffs = decode_write(cfg, arrs, ctx, p, c, z, n_off, **keywords)
    return (coeffs, None) if return_dc else coeffs
