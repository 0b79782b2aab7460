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
every sync round), :func:`decode_write` (K2, the writing decode that stores
into the coefficient stream) and :func:`decode_write_emit` (K4, the writing
decode that emits packed records for the records write path of
``ops/write.py``). Each has its plain PyTorch version beside it, lock-step
over all lanes with gathers for the bit loads and table lookups; a wrapper
takes the plain version only for CPU tensors and launches its kernel for
CUDA tensors.
The word stream is carried as int32 bit patterns of the big-endian uint32
words (the kernels reinterpret them as unsigned, the plain versions widen
to int64).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import constants as C
from .. import kernels
from ..config import Tuning

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

    words: torch.Tensor  # int32[lanes*32] bit patterns of big-endian words
    seg_of_subseq: torch.Tensor  # int32[lanes]
    seg_first_lane: torch.Tensor  # int32[lanes] first subsequence of my segment
    seg_num_subseq: torch.Tensor  # int32[lanes] subsequence count of my segment
    maxcode: torch.Tensor  # int32[8,16]
    vsm: torch.Tensor  # int32[8,16] valptr - mincode
    huffval: torch.Tensor  # int32[8*256]
    # words staged in front of ``words`` in its storage (0 or 1). A
    # subsequence shard (parallel/segments.py, which gives its segments a
    # negative ``seg_first_lane``) has 1: the word before the shard, since
    # lane 0 of a shard that begins mid-segment may start up to 31 bits
    # before its own words. The kernels and the plain versions both read
    # word -1 from there; with 0 no index below 0 occurs.
    lead_words: int = 0


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


def make_ctx(cfg: ScanConfig, arrs: ScanArrays, num_subseq=None) -> Ctx:
    """Build the decode context on the device of ``arrs``. ``num_subseq``,
    if given, makes exactly the lanes below it valid (a shard of the
    sharded decode, where every shard owns a different number of
    subsequences)."""
    dev = arrs.words.device
    lanes = cfg.lanes
    # limits[t, j] = first 32-bit-left-aligned value whose code is longer
    # than j+1 bits; the running max makes empty lengths inherit, so that
    # `data >= limits[j]` is exactly "code length > j+1". A saturated table
    # would overflow 32 bits here and is routed to the maxcode path.
    shift = 31 - torch.arange(16, device=dev, dtype=torch.int64)
    raw_lim = (((arrs.maxcode.to(torch.int64) + 1) & _M32) << shift) & _M32
    limits = _wrap_i32(torch.cummax(raw_lim, dim=1).values).to(torch.int32)

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


def _decode_symbol(cfg: ScanConfig, t: _Plain, data, c, z,
                   need_value: bool = True):
    """One symbol on all lanes. Returns (length, sym, run), int64.

    With ``need_value=False`` (sync passes, which only track states) the
    EXTEND value is not computed and sym is 0.
    """
    is_dc = z == 0
    pair = t.slots.index_select(0, c)  # (lanes, 2)
    tbl = torch.where(is_dc, pair[:, 0], pair[:, 1])
    if cfg.fast_tables:
        l_idx = _category_fast(t, data, tbl)
    else:
        l_idx = _category_slow(t, data, tbl)
    cat_len = l_idx + 1
    code = data >> (32 - cat_len)
    vsm = t.vsm[tbl, l_idx]
    idx = (vsm + code) & 0xFF
    sym_cat = t.huffval[tbl * 256 + idx]

    run_ac = sym_cat >> 4
    cat_ac = sym_cat & 0xF
    cat = torch.where(is_dc, sym_cat, cat_ac)
    # EOB fills the data unit, ZRL skips 16
    eob_or_zrl = torch.where(run_ac == 15, 15, 63 - z)
    run = torch.where(is_dc, 0, torch.where(cat_ac == 0, eob_or_zrl, run_ac))
    length = cat_len + cat
    if not need_value:
        return length, torch.zeros_like(cat), run

    # value bits (T.81 F.12 EXTEND); shift amounts guarded for garbage cat,
    # int32 wraparound written out
    off = ((data << (cat_len & 31)) & _M32) >> ((32 - cat) & 31)
    off = _wrap_i32(off)
    one = _wrap_i32(torch.ones_like(cat) << cat.clamp(max=31))
    half = one >> 1
    value = torch.where(off < half, _wrap_i32(off - one + 1), off)
    sym = torch.where(cat > 0, value, 0)
    return length, sym, run


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


# --- K1: one decode pass over every lane's own subsequence ------------------

def _check_lane_tensors(where: str, dev: torch.device, lanes: int, **tensors):
    for name, (t, dtype) in tensors.items():
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or t.numel() != lanes):
            raise ValueError(
                f"{where}: {name} must be a contiguous {dtype} tensor of "
                f"{lanes} elements on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _table_ptrs(arrs: ScanArrays, ctx: Ctx, dev: torch.device):
    tabs = (arrs.maxcode, arrs.vsm, ctx.limits, arrs.huffval, ctx.slots)
    for t in tabs:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("Huffman tables must be contiguous int32 "
                             f"tensors on {dev}")
    return [t.data_ptr() for t in tabs]


def subseq_pass_plain(cfg, arrs, ctx, p0, c0, z0, active0):
    """Plain version of :func:`subseq_pass`: all lanes in lock step, one
    symbol per iteration, on whatever device holds the tensors."""
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


def subseq_pass(cfg: ScanConfig, arrs: ScanArrays, ctx: Ctx, p0, c0, z0,
                active0):
    """Decode each lane's own subsequence from the given start state, until
    the lane's next symbol would cross its subsequence end. Writes nothing.
    Returns int32 (p, c, z, n).

    CUDA tensors: kernel K1 (``kernels/csrc/subseq_pass.cu``; replaces the
    Pallas kernel behind ``jpeggpu_tpu/ops/huffman_pallas.py:
    subseq_pass``). Bound by the dependent instructions per symbol of the
    slowest lane, not by bytes; see the note in the source. CPU tensors:
    the plain version.
    """
    dev = p0.device
    if dev.type == "cpu":
        return subseq_pass_plain(cfg, arrs, ctx, p0, c0, z0, active0)
    if dev.type != "cuda":
        raise ValueError(f"subseq_pass: unsupported device {dev}")
    lanes = cfg.lanes
    i32 = torch.int32
    _check_lane_tensors(
        "subseq_pass", dev, lanes, p0=(p0, i32), c0=(c0, i32), z0=(z0, i32),
        active0=(active0, torch.bool), word_end=(ctx.word_end, i32),
        seg_base_bits=(ctx.seg_base_bits, i32),
        end_subseq=(ctx.end_subseq, i32))
    _check_lane_tensors("subseq_pass", dev, lanes * C.CHUNK_SIZE_WORDS,
                        words=(arrs.words, i32))
    out = torch.empty((4, lanes), dtype=i32, device=dev)
    fn = kernels.get("jpeggpu_subseq_pass")
    err = fn(arrs.words.data_ptr(), ctx.word_end.data_ptr(),
             ctx.seg_base_bits.data_ptr(), ctx.end_subseq.data_ptr(),
             *_table_ptrs(arrs, ctx, dev),
             p0.data_ptr(), c0.data_ptr(), z0.data_ptr(), active0.data_ptr(),
             out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
             out[3].data_ptr(), lanes, cfg.du_per_mcu, int(cfg.fast_tables),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "subseq_pass")
    subseq_pass.launches += 1
    return out[0], out[1], out[2], out[3]


subseq_pass.launches = 0


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


def sync_states(cfg: ScanConfig, arrs: ScanArrays, ctx: Ctx, entry=None):
    """Fixed-point synchronisation of subsequence decoder states.

    Round 0 decodes every subsequence speculatively ("blind"); round 1
    re-decodes every subsequence from its predecessor's end state (almost
    all lanes self-synchronise here); further full-width rounds run until
    no lane's predecessor changed. Every round is one :func:`subseq_pass`;
    the convergence test costs one host read per round.

    ``entry``, if given, is a ``(p, c, z)`` triple used as lane 0's
    predecessor state when lane 0 is not a segment first: the boundary
    state of a subsequence shard (parallel/segments.py), segment-relative
    like every decoder state, so it transfers between shards unchanged.

    Returns converged int32 (p, c, z, n) per subsequence: the state *after*
    decoding subsequence i, with n its coefficient-position count.
    """
    lanes = cfg.lanes
    blind_p = ctx.rel * C.SUBSEQ_SIZE_BITS
    zeros = torch.zeros_like(blind_p)
    first = ctx.first_of_seg
    valid = ctx.lane_valid
    # lanes whose start state comes from a predecessor (torch.roll wraps
    # the last lane into lane 0, which is a segment first or takes the
    # fixed `entry`: it never re-enters)
    frontier_ok = ~first & valid
    if entry is not None:
        frontier_ok = frontier_ok & (
            torch.arange(lanes, device=valid.device) > 0)

    p, c, z, n = subseq_pass(cfg, arrs, ctx, blind_p, zeros, zeros, valid)
    for _ in range(lanes + 1):
        # start of lane i = end state of lane i-1; segment firsts are exact
        sp = torch.where(first, blind_p, torch.roll(p, 1))
        sc = torch.where(first, zeros, torch.roll(c, 1))
        sz = torch.where(first, zeros, torch.roll(z, 1))
        sp, sc, sz = _enter(ctx, (sp, sc, sz), entry)
        p2, c2, z2, n2 = subseq_pass(cfg, arrs, ctx, sp, sc, sz, valid)
        # padded lanes stay frozen so they never delay convergence
        p2 = torch.where(valid, p2, blind_p)
        c2 = torch.where(valid, c2, zeros)
        z2 = torch.where(valid, z2, zeros)
        n2 = torch.where(valid, n2, zeros)
        delta = (p2 != p) | (c2 != c) | (z2 != z)
        p, c, z, n = p2, c2, z2, n2
        if not bool((torch.roll(delta, 1) & frontier_ok).any()):
            break
    return p, c, z, n


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
             *_table_ptrs(arrs, ctx, dev), ctx.natural.data_ptr(),
             sp.data_ptr(), sc.data_ptr(), sz.data_ptr(), pos0.data_ptr(),
             bound.data_ptr(), active0.data_ptr(), out.data_ptr(), lanes,
             cfg.du_per_mcu, int(cfg.fast_tables),
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
    Pallas kernel behind ``jpeggpu_tpu/ops/huffman_pallas.py: emit_pass``).
    Bound like K2 by the slowest lane's chain of dependent operations;
    see the note in the source. On the card the slots at and past ``m[l]``
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
             *_table_ptrs(arrs, ctx, dev),
             sp.data_ptr(), sc.data_ptr(), sz.data_ptr(), pos0.data_ptr(),
             bound.data_ptr(), active0.data_ptr(), rec.data_ptr(),
             m.data_ptr(), lanes, s_cap, cfg.du_per_mcu,
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
    if cfg.tuning.write_mode == "tiles":
        from . import write

        return write.decode_write_tiles(cfg, arrs, ctx, p, c, z, n_off,
                                        return_dc=return_dc, **keywords)
    coeffs = decode_write(cfg, arrs, ctx, p, c, z, n_off, **keywords)
    return (coeffs, None) if return_dc else coeffs
