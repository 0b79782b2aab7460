"""Segment- and subsequence-sharded decode of one image.

The port of ``jpeggpu_tpu/parallel/segments.py``: one image decoded across
the shards of a :class:`~jpeggpu_tpu_torch.parallel.Mesh`, its tail
included. The shards run in one process, each on its device (several may
share one card), and exchange what the reference's collectives exchange
through :mod:`~jpeggpu_tpu_torch.parallel.collectives`.

Segment granularity (scans with at least as many restart segments as
shards): restart segments are independent decode units, so the host
partitions them into one contiguous group per shard, balancing subsequence
counts, and rebases each group's subsequence, segment and output-position
indexing to be shard-local. Each shard runs the normal decode with the
shard keywords of ``ops.huffman.decode_scan`` and embeds its slice in a
frame of the scan's row-padded length.

Subsequence granularity (fewer segments than shards; most camera JPEGs have
no restart markers at all): the scan's subsequences are cut into equal
runs. Decoder states are segment-relative, so they transfer between
shards: each shard runs the normal Jacobi sync with its lane 0 seeded from
an ``entry`` boundary state (blind at first), and an outer fixed point hands
each shard's last-lane exit state to its successor (``ppermute``) until no
entry changes, at most one round per shard. Symbol offsets cross the seams
through one ``all_gather`` of (tail segment, tail count, head segment)
triples; each shard writes at global positions into a frame of the scan's
row-padded length.

Both end in the same tail: the frames merge by ``psum_scatter`` into
MCU-row chunks (the supports are disjoint, so the sum is the ordered
gather), DC un-delta crosses chunk seams through one ``all_gather`` of
per-component tail sums, and each shard runs the de-interleave and the
plane IDCT (kernel K9, ``ops.idct.dequant_idct_planes``, one launch for
all planes of its rows) on its own rows.
The planes come back row-sharded. Multi-scan images go scan by scan.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from .. import convert
from ..debug import scope
from ..errors import NotSupported
from ..ops.huffman import (ScanConfig, decode_scan, decode_scan_from_states,
                           make_ctx, symbol_offsets, sync_states)
from ..ops.idct import dequant_idct_planes
from ..ops.transpose import deinterleave
from ..pipeline import (DecodePlan, ScanPlanStatic, _bucket, _destuff_host,
                        build_plan)
from ..reader import num_mcus_in_segment, parse
from ..tables import pack_huffman_tables
from . import Mesh, make_mesh
from .collectives import all_gather, ppermute, psum, psum_scatter


# --- segment granularity ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardPlanStatic:
    cfg: ScanConfig  # uniform per-shard config (lanes = padded shard width)
    shard_positions: int  # padded per-shard output length
    num_segments_padded: int
    real_positions: Tuple[int, ...]  # per shard, for trimming
    num_shards: int
    bounds: Tuple[int, ...]  # segment partition boundaries


def plan_shards(plan: DecodePlan, num_shards: int,
                si: int = 0) -> ShardPlanStatic:
    stream = plan.stream
    scan = stream.scans[si]
    if scan.num_segments < num_shards:
        raise NotSupported(
            f"scan has {scan.num_segments} restart segments; need >= "
            f"{num_shards} for segment-granular sharding (subsequence "
            f"sharding handles this case)")
    counts = scan.segments[:, 1].astype(np.int64)
    # contiguous partition balancing subsequence counts
    target = counts.sum() / num_shards
    bounds = [0]
    acc = 0
    for s, c in enumerate(counts):
        acc += int(c)
        if acc >= target * len(bounds) and len(bounds) < num_shards:
            bounds.append(s + 1)
    while len(bounds) < num_shards + 1:
        bounds.append(scan.num_segments)
    bounds = bounds[:num_shards] + [scan.num_segments]
    # every shard must own at least one segment
    for i in range(1, num_shards + 1):
        lo = max(bounds[i], bounds[i - 1] + 1)
        bounds[i] = min(lo, scan.num_segments - (num_shards - i))
    bounds[num_shards] = scan.num_segments

    pps = num_mcus_in_segment(stream, scan) * scan.num_data_units_in_mcu * \
        C.DATA_UNIT_SIZE
    total = scan.total_data_units * C.DATA_UNIT_SIZE
    lanes = _bucket(max(
        int(counts[bounds[d]:bounds[d + 1]].sum()) for d in range(num_shards)))
    nseg_p = _bucket(max(
        bounds[d + 1] - bounds[d] for d in range(num_shards)), 64)
    real_pos = []
    for d in range(num_shards):
        lo = bounds[d] * pps
        hi = min(bounds[d + 1] * pps, total)
        real_pos.append(max(hi - lo, 0))
    shard_positions = -(-max(real_pos) // 128) * 128

    sp = plan.signature.scans[si]
    # the default Tuning, whatever the plan's: segment shards take the
    # direct write (K2), as the reference's
    cfg = ScanConfig(
        lanes=lanes,
        num_segments=nseg_p,
        du_per_mcu=sp.cfg.du_per_mcu,
        mcus_per_seg=sp.cfg.mcus_per_seg,
        total_mcus=sp.cfg.total_mcus,
        comp_groups=sp.cfg.comp_groups,
        fast_tables=sp.cfg.fast_tables,
    )
    return ShardPlanStatic(cfg=cfg, shard_positions=shard_positions,
                           num_segments_padded=nseg_p,
                           real_positions=tuple(real_pos),
                           num_shards=num_shards, bounds=tuple(bounds))


def build_shard_inputs(data: bytes, plan: DecodePlan,
                       shp: ShardPlanStatic, si: int = 0) -> dict:
    """Host staging: per-shard words and segment arrays, stacked on a
    leading shard axis (tables shared)."""
    stream = plan.stream
    scan = stream.scans[si]
    buf = np.frombuffer(data, np.uint8)
    words_full = _destuff_host(buf, scan, _bucket(scan.num_subsequences))
    bounds = shp.bounds
    pps = shp.cfg.positions_per_seg
    total = shp.cfg.total_positions
    D = shp.num_shards
    L = shp.cfg.lanes

    words = np.zeros((D, L * C.CHUNK_SIZE_WORDS), np.uint32)
    seg_of = np.zeros((D, L), np.int32)
    seg_first = np.zeros((D, L), np.int32)
    seg_nsub = np.zeros((D, L), np.int32)
    pos_base = np.zeros((D, L), np.int32)
    pos_bound = np.zeros((D, L), np.int32)
    n_subseq = np.zeros((D, 1), np.int32)
    for d in range(D):
        lo, hi = bounds[d], bounds[d + 1]
        segs = scan.segments[lo:hi]
        first_sub = int(segs[0, 0])
        n_sub = int(segs[:, 1].sum())
        n_subseq[d, 0] = n_sub
        w0 = first_sub * C.CHUNK_SIZE_WORDS
        words[d, :n_sub * C.CHUNK_SIZE_WORDS] = \
            words_full[w0:w0 + n_sub * C.CHUNK_SIZE_WORDS]
        local_ids = np.repeat(np.arange(hi - lo, dtype=np.int32), segs[:, 1])
        seg_of[d, :n_sub] = local_ids
        seg_first[d, :n_sub] = segs[local_ids, 0] - first_sub
        seg_nsub[d, :n_sub] = segs[local_ids, 1]
        if n_sub < L and len(segs):
            seg_of[d, n_sub:] = hi - lo - 1
            seg_first[d, n_sub:] = segs[-1, 0] - first_sub
            seg_nsub[d, n_sub:] = segs[-1, 1]
        shard_lo = lo * pps
        base = (local_ids + lo) * pps - shard_lo
        bnd = np.minimum((local_ids + lo + 1) * pps, total) - shard_lo
        pos_base[d, :n_sub] = base
        pos_bound[d, :n_sub] = np.clip(bnd, 0, shp.shard_positions)

    maxcode, vsm, huffval = pack_huffman_tables(scan.huff_tables)
    return dict(words=words, seg_of=seg_of, seg_first=seg_first,
                seg_nsub=seg_nsub, pos_base=pos_base, pos_bound=pos_bound,
                n_subseq=n_subseq,
                maxcode=maxcode, vsm=vsm, huffval=huffval)


# --- subsequence granularity ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SubseqShardStatic:
    cfg: ScanConfig  # per-shard config (lanes = padded shard width)
    num_shards: int
    bounds: Tuple[int, ...]  # subsequence partition boundaries (global)


def plan_subseq_shards(plan: DecodePlan, num_shards: int,
                       si: int = 0) -> SubseqShardStatic:
    scan = plan.stream.scans[si]
    n = scan.num_subsequences
    if n < num_shards:
        raise NotSupported(
            f"scan has {n} subsequences; need >= {num_shards} to shard "
            f"across the mesh")
    bounds = [d * n // num_shards for d in range(num_shards)] + [n]
    width = max(bounds[d + 1] - bounds[d] for d in range(num_shards))
    # +1: the slot after the last real lane holds a copy of the next
    # shard's first chunk, so the final lane's straddling symbol reads true
    # stream bytes
    lanes = _bucket(width + 1)
    sp = plan.signature.scans[si]
    # the plan's config and tuning: under write_mode="tiles" the records
    # path runs here, with the shard keywords
    cfg = dataclasses.replace(sp.cfg, lanes=lanes)
    return SubseqShardStatic(cfg=cfg, num_shards=num_shards,
                             bounds=tuple(bounds))


def build_subseq_shard_inputs(data: bytes, plan: DecodePlan,
                              shp: SubseqShardStatic, si: int = 0) -> dict:
    """Host staging for subsequence-granular shards.

    Segment tables keep their true geometry in shard-local lane indexing:
    a segment that starts in an earlier shard gets a negative
    ``seg_first``, so relative and blind positions stay segment-relative
    and the boundary state transfers between shards unchanged.
    ``prev_word`` is the word before each shard's first chunk (0 for shard
    0), which a lane 0 that starts inside its predecessor's last symbol
    reads."""
    stream = plan.stream
    scan = stream.scans[si]
    buf = np.frombuffer(data, np.uint8)
    n = scan.num_subsequences
    words_full = _destuff_host(buf, scan, _bucket(n + 1))
    D, L = shp.num_shards, shp.cfg.lanes
    CW = C.CHUNK_SIZE_WORDS
    counts = scan.segments[:, 1].astype(np.int64)
    seg_of_global = np.repeat(
        np.arange(scan.num_segments, dtype=np.int32), counts)

    words = np.zeros((D, L * CW), np.uint32)
    seg_first = np.zeros((D, L), np.int32)
    seg_nsub = np.zeros((D, L), np.int32)
    seg_local = np.zeros((D, L), np.int32)
    seg_global = np.zeros((D, L), np.int32)
    prev_word = np.zeros((D, 1), np.uint32)
    n_subseq = np.zeros((D, 1), np.int32)
    for d in range(D):
        lo, hi = shp.bounds[d], shp.bounds[d + 1]
        nd = hi - lo
        n_subseq[d, 0] = nd
        words[d, :(nd + 1) * CW] = words_full[lo * CW:(hi + 1) * CW]
        if lo > 0:
            prev_word[d, 0] = words_full[lo * CW - 1]
        gseg = seg_of_global[lo:hi]
        seg_global[d, :nd] = gseg
        seg_local[d, :nd] = gseg - gseg[0]
        seg_first[d, :nd] = scan.segments[gseg, 0].astype(np.int32) - lo
        seg_nsub[d, :nd] = scan.segments[gseg, 1]
        if nd < L:  # padded lanes: inert (n_subseq masks them)
            seg_global[d, nd:] = seg_global[d, nd - 1]
            seg_local[d, nd:] = seg_local[d, nd - 1]
            seg_first[d, nd:] = seg_first[d, nd - 1]
            seg_nsub[d, nd:] = seg_nsub[d, nd - 1]

    maxcode, vsm, huffval = pack_huffman_tables(scan.huff_tables)
    return dict(words=words, seg_of=seg_local, seg_first=seg_first,
                seg_nsub=seg_nsub, seg_global=seg_global,
                prev_word=prev_word, n_subseq=n_subseq,
                maxcode=maxcode, vsm=vsm, huffval=huffval)


# --- staged inputs ----------------------------------------------------------

@dataclasses.dataclass
class ShardedScan:
    """One scan's shard inputs on the mesh's devices. ``shards[d]`` holds
    shard ``d``'s ``arrs`` (ScanArrays), ``n_subseq`` (int), ``qtables``
    (int32[4, 64]) and its per-lane position inputs: ``pos_base`` and
    ``pos_bound`` (segment granularity) or ``seg_global`` (subsequence
    granularity)."""

    granularity: str  # "segments" | "subsequences"
    sp: ScanPlanStatic
    shp: object  # ShardPlanStatic | SubseqShardStatic
    rows: int  # MCU rows of each shard's chunk of the tail
    padded_total: int  # the scan's positions, padded to whole chunks
    shards: List[Dict]
    outer_rounds: int = 0  # subsequence granularity, after a decode


def _on(dev: torch.device):
    """The device context of a shard: the kernels launch on the current CUDA
    device, which must be the shard's when the mesh spans several cards."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _chunk_rows(num_mcus_y: int, D: int) -> int:
    return -(-num_mcus_y // D)


def _stage(data: bytes, plan: DecodePlan, si: int, mesh: Mesh,
           granularity: str) -> ShardedScan:
    D = mesh.size
    sp = plan.signature.scans[si]
    rows = _chunk_rows(sp.num_mcus_y, D)
    row_pos = sp.num_mcus_x * sp.cfg.du_per_mcu * C.DATA_UNIT_SIZE
    if granularity == "segments":
        shp = plan_shards(plan, D, si)
        inputs = build_shard_inputs(data, plan, shp, si)
        lane_inputs = ("pos_base", "pos_bound")
    else:
        shp = plan_subseq_shards(plan, D, si)
        inputs = build_subseq_shard_inputs(data, plan, shp, si)
        lane_inputs = ("seg_global",)
    qtables = plan.stream.qtables.astype(np.int32)
    shards = []
    for d, dev in enumerate(mesh.devices):
        shard = dict(arrs=convert.shard_arrays(inputs, d, dev,
                                               shp.cfg.fast_tables),
                     n_subseq=int(inputs["n_subseq"][d, 0]),
                     qtables=torch.from_numpy(qtables).to(dev))
        for k in lane_inputs:
            shard[k] = torch.from_numpy(inputs[k][d].copy()).to(dev)
        shards.append(shard)
    return ShardedScan(granularity=granularity, sp=sp, shp=shp, rows=rows,
                       padded_total=D * rows * row_pos, shards=shards)


def stage_sharded(data: bytes, mesh: Mesh,
                  plan: Optional[DecodePlan] = None) -> List[ShardedScan]:
    """Host staging of every scan for :func:`decode_staged`: segment
    granularity where a scan has at least as many restart segments as the
    mesh has shards, else subsequence granularity."""
    if plan is None:
        plan = build_plan(parse(data))
    return [_stage(data, plan, si, mesh,
                   "segments" if scan.num_segments >= mesh.size
                   else "subsequences")
            for si, scan in enumerate(plan.stream.scans)]


# --- sharded tail -----------------------------------------------------------
#
# The tail stages (DC un-delta, de-interleave, IDCT) partition cleanly by MCU
# rows: a chunk of whole MCU rows is a contiguous coefficient range, its
# de-interleaved pixels are a contiguous plane row block, and the only
# cross-chunk coupling is the DC predictor of a segment that straddles a
# chunk seam: one scalar per scan component per shard, gathered once.


def _undelta_dc_chunks(cfg: ScanConfig, comp_slots,
                       chunks: List[torch.Tensor]) -> List[torch.Tensor]:
    """DC un-delta on the MCU-row chunks of all shards (chunk ``me`` on
    shard ``me``'s device).

    The arithmetic of ``ops.dc.undelta_dc`` (a cumulative sum, one int16
    wrap at the end) with the segment prefix split at chunk seams: a
    segment that began in an earlier chunk takes the partial sums of every
    earlier chunk whose last segment is this chunk's head segment (a
    segment spanning k chunks chains through k-1 such tails), through one
    all_gather of per-component tail sums."""
    D = len(chunks)
    devices = [ch.device for ch in chunks]
    chunk_du = chunks[0].numel() // C.DATA_UNIT_SIZE
    seg_du = cfg.mcus_per_seg * cfg.du_per_mcu
    parts, tails = [], []
    for me, chunk in enumerate(chunks):
        dc = chunk.view(chunk_du, C.DATA_UNIT_SIZE)[:, 0].to(torch.int64)
        d0 = me * chunk_du
        gdu = d0 + torch.arange(chunk_du, device=dc.device)
        slot = gdu % cfg.du_per_mcu
        gseg = gdu // seg_du
        last_seg = (d0 + chunk_du - 1) // seg_du
        per_comp, tail = [], []
        for off, cnt in comp_slots:
            sel = (slot >= off) & (slot < off + cnt)
            x = torch.where(sel, dc, 0)
            per_comp.append((sel, torch.cumsum(x, 0)))
            # this chunk's part of its (possibly continuing) last segment
            tail.append(torch.where(gseg == last_seg, x, 0).sum())
        parts.append((dc, gseg, per_comp))
        tails.append(torch.stack(tail))
    gathered = all_gather(tails, devices)  # (D, ncomp) on every shard

    out = []
    for me, (chunk, (dc, gseg, per_comp), g) in enumerate(
            zip(chunks, parts, gathered)):
        d0 = me * chunk_du
        head_seg = d0 // seg_du
        crosses_in = head_seg * seg_du < d0  # head segment began earlier
        eidx = torch.arange(D, device=dc.device)
        last_seg_all = ((eidx + 1) * chunk_du - 1) // seg_du
        seg_start_loc = gseg * seg_du - d0
        in_head = (gseg == head_seg) & crosses_in
        new_dc = dc
        for ci, (sel, cum) in enumerate(per_comp):
            prefix = torch.where((eidx < me) & (last_seg_all == head_seg),
                                 g[:, ci], 0).sum()
            base_local = torch.where(
                seg_start_loc > 0,
                cum[(seg_start_loc - 1).clamp(0, chunk_du - 1)], 0)
            val = torch.where(in_head, cum + prefix, cum - base_local)
            new_dc = torch.where(sel, val, new_dc)
        wrapped = ((new_dc + 0x8000) & 0xFFFF) - 0x8000
        res = chunk.clone().view(chunk_du, C.DATA_UNIT_SIZE)
        res[:, 0] = wrapped.to(torch.int16)
        out.append(res.view(-1))
    return out


def _tail_chunks(st: ShardedScan, with_idct: bool,
                 frames: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Reduce-scatter the shards' frames (disjoint supports) into MCU-row
    chunks and run DC, de-interleave and IDCT on each shard's own chunk.
    Returns, per scan component, one row block per shard (pixel rows if
    ``with_idct``)."""
    cfg, sp = st.shp.cfg, st.sp
    chunks = psum_scatter(frames, [f.device for f in frames])
    comp_slots = tuple((c[1], c[2] * c[3]) for c in sp.comps)
    with scope("jpeggpu.dc", chunks[0].device):
        chunks = _undelta_dc_chunks(cfg, comp_slots, chunks)
    t_comps = [(c[1], c[2], c[3]) for c in sp.comps]
    blocks = [[] for _ in sp.comps]
    for chunk, shard in zip(chunks, st.shards):
        with scope("jpeggpu.deinterleave", chunk.device):
            planes = deinterleave(chunk, cfg.du_per_mcu, sp.num_mcus_x,
                                  st.rows, t_comps)
        if with_idct:
            with _on(chunk.device), scope("jpeggpu.idct", chunk.device):
                planes = dequant_idct_planes(
                    planes, [shard["qtables"][c[6]] for c in sp.comps])
        for i, plane in enumerate(planes):
            blocks[i].append(plane)
    return blocks


# --- per-granularity decode -------------------------------------------------

def _shard_frames(st: ShardedScan) -> List[torch.Tensor]:
    """Segment granularity: each shard's decode embedded in its frame."""
    shp = st.shp
    frames = []
    for d, shard in enumerate(st.shards):
        with _on(shard["arrs"].words.device):
            coeffs = decode_scan(shp.cfg, shard["arrs"],
                                 num_subseq=shard["n_subseq"],
                                 pos_base=shard["pos_base"],
                                 bound=shard["pos_bound"],
                                 total_out=shp.shard_positions)
        # the frame carries shard_positions of slack, as the reference's,
        # so that no shard's zero-padded slice needs its start clamped; real
        # positions all lie below padded_total, so the trim drops only
        # padding zeros
        frame = torch.zeros(st.padded_total + shp.shard_positions,
                            dtype=torch.int16, device=coeffs.device)
        lo = min(shp.bounds[d] * shp.cfg.positions_per_seg, st.padded_total)
        frame[lo:lo + shp.shard_positions] = coeffs
        frames.append(frame[:st.padded_total])
    return frames


def _subseq_sync(cfg: ScanConfig, shards: List[Dict], ctxs):
    """The outer fixed point of subsequence granularity: re-sync every
    shard from its incoming boundary state until no shard's entry changes,
    at most one round per shard. Returns the per-shard states, the entries
    they were synced from and the number of rounds.

    Shard 0's incoming state stays the zero state of ``ppermute``, equal to
    its blind start (its lane 0 is the scan's start anyway). If the cap
    ends the loop while an entry still changes, the states are decoded with
    the entries they were synced from, never with the newer exits: that
    pair is consistent; on convergence the two are equal."""
    D = len(shards)
    devices = [s["arrs"].words.device for s in shards]
    perm = [(i, i + 1) for i in range(D - 1)]
    lasts = [s["n_subseq"] - 1 for s in shards]

    def sync_once(entries):
        states = []
        for s, ctx, e, dev in zip(shards, ctxs, entries, devices):
            with _on(dev):
                states.append(sync_states(cfg, s["arrs"], ctx, entry=tuple(e)))
        exits = [torch.stack([p[k], c[k], z[k]])
                 for (p, c, z, _), k in zip(states, lasts)]
        return states, ppermute(exits, devices, perm)

    def changed(nxt, used):
        flags = [(a != b).any().to(torch.int32) for a, b in zip(nxt, used)]
        return bool(psum(flags, devices)[0] > 0)

    used = [torch.stack([ctx.rel[0] * C.SUBSEQ_SIZE_BITS,
                         torch.zeros_like(ctx.rel[0]),
                         torch.zeros_like(ctx.rel[0])]) for ctx in ctxs]
    states, nxt = sync_once(used)
    rounds = 1
    while rounds < D and changed(nxt, used):
        used = nxt
        states, nxt = sync_once(used)
        rounds += 1
    return states, used, rounds


def _subseq_frames(st: ShardedScan) -> List[torch.Tensor]:
    """Subsequence granularity: the boundary fixed point, global write
    positions, then each shard's writing decode into a frame of the scan's
    padded length."""
    cfg = st.shp.cfg
    D = len(st.shards)
    devices = [s["arrs"].words.device for s in st.shards]
    ctxs = [make_ctx(cfg, s["arrs"], num_subseq=s["n_subseq"])
            for s in st.shards]
    states, entries, st.outer_rounds = _subseq_sync(cfg, st.shards, ctxs)

    # global write positions: local within-segment offsets, plus, for the
    # head-partial segment, the symbol counts its predecessors decoded
    n_offs, trios = [], []
    for shard, (_, _, _, n) in zip(st.shards, states):
        n_offs.append(symbol_offsets(cfg, shard["arrs"], n))
        gseg = shard["seg_global"]
        valid = torch.arange(cfg.lanes, device=gseg.device) < shard["n_subseq"]
        last_seg = gseg[shard["n_subseq"] - 1]
        tail_sum = torch.where((gseg == last_seg) & valid, n, 0).sum()
        trios.append(torch.stack([last_seg.to(torch.int64), tail_sum,
                                  gseg[0].to(torch.int64)]))
    gathered = all_gather(trios, devices)  # (D, 3) on every shard

    pps, total = cfg.positions_per_seg, cfg.total_positions
    frames = []
    for me, (shard, ctx, (p, c, z, _), n_off, g, entry) in enumerate(zip(
            st.shards, ctxs, states, n_offs, gathered, entries)):
        gseg = shard["seg_global"]
        head_seg = gseg[0]
        eidx = torch.arange(D, device=g.device)
        prefix = torch.where((eidx < me) & (g[:, 0] == head_seg), g[:, 1],
                             0).sum()
        pos_base = gseg * pps + torch.where(gseg == head_seg, prefix, 0)
        bound = ((gseg + 1) * pps).clamp(max=total)
        with _on(gseg.device):
            frames.append(decode_scan_from_states(
                cfg, shard["arrs"], ctx, p, c, z, n_off,
                pos_base=pos_base.to(torch.int32),
                bound=bound.to(torch.int32), total_out=st.padded_total,
                entry=tuple(entry)))
    return frames


def decode_scan_staged(st: ShardedScan,
                       with_idct: bool = True) -> List[List[torch.Tensor]]:
    """One staged scan -> per scan component, one row block per shard, on
    the shards' devices."""
    frames = (_shard_frames(st) if st.granularity == "segments"
              else _subseq_frames(st))
    return _tail_chunks(st, with_idct, frames)


def decode_staged(staged: List[ShardedScan],
                  with_idct: bool = True) -> Dict[int, List[torch.Tensor]]:
    """Every staged scan of :func:`stage_sharded`: component index -> its
    row blocks, one per shard, on the shards' devices (uncropped)."""
    blocks = {}
    for st in staged:
        for c, comp_blocks in zip(st.sp.comps, decode_scan_staged(
                st, with_idct)):
            blocks[c[0]] = comp_blocks
    return blocks


def assemble(plan: DecodePlan,
             blocks: Dict[int, List[torch.Tensor]]) -> List[np.ndarray]:
    """Row blocks -> cropped numpy planes, one per component."""
    return [np.concatenate([b.cpu().numpy() for b in blocks[ci]])[
                :comp.size_y, :comp.size_x]
            for ci, comp in enumerate(plan.stream.components)]


def decode_sharded(data: bytes, mesh: Optional[Mesh] = None, *,
                   plan: Optional[DecodePlan] = None,
                   with_idct: bool = True) -> List[np.ndarray]:
    """Decode one image sharded across ``mesh`` (``None``: every CUDA
    device, see :func:`~jpeggpu_tpu_torch.parallel.make_mesh`): each scan
    at segment granularity when it has at least as many restart segments
    as the mesh has shards, else at subsequence granularity with the
    cross-shard boundary sync. Multi-scan images decode scan by scan.

    Returns the cropped planes as numpy arrays: uint8 pixels, or with
    ``with_idct=False`` the int16 coefficient planes with DC un-deltaed.
    """
    if mesh is None:
        mesh = make_mesh()
    if plan is None:
        plan = build_plan(parse(data))
    return assemble(plan, decode_staged(stage_sharded(data, mesh, plan),
                                        with_idct))
