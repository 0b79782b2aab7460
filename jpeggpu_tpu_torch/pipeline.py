"""Decode planning, host staging and the device pipeline.

A :class:`DecodePlan` captures the static geometry of a parsed stream. The
lane count is rounded up to a shape bucket; the padding is inert (lane
validity is data-driven, see ``ops.huffman.make_ctx``). The device chain is

  sync_states (K1 per round) -> symbol_offsets -> decode_write (K2)
  -> undelta_dc_values -> idct_stream_to_planes (K3, once per scan for all
  its components) -> crop

(``scan_planes``, the tail, also takes the stream of a merged group of B
images whole: ``parallel/batch.py``)

and runs eagerly on the device that holds the staged inputs. Under a plan
built with ``Tuning(write_mode="tiles")`` the write stage is the records
path instead (``ops/write.py``): decode_write_emit (K4), then, per scan, one
of two tile shapes (``Tuning.tile_mode``; "auto" takes the scan's
``ScanConfig.tile_auto``): supertiles_from_records (K5) ->
expand_supertiles (K6) -> leftover scatter, whose DC side vector feeds
undelta_dc_values; or, for sparse scans, tiles_from_records (K7) ->
expand_tiles (K8) -> leftover scatter, which has no side vector
(undelta_dc_values then reads the DC column of the stream).
With ``with_idct=False`` the tail is the reference's non-fused one:
undelta_dc -> deinterleave -> int16 coefficient planes, cropped. Under a
plan built with ``host_destuff=False`` the raw scan bytes are staged and
the chain starts with the device destuff (``ops/destuff.py``, tensor code).
Each stage runs inside a ``debug.scope`` named as in the JAX package
(``jpeggpu.destuff``, ``.sync``, ``.write.<mode>``, ``.dc``,
``.idct_fused``, ``.deinterleave``); the host staging and the tail of a
scan have ranges of their own (``jpeggpu.inputs``, ``.copy_in``,
``.tail``; :mod:`jpeggpu_tpu_torch.debug` lists them all).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import constants as C
from . import convert
from .config import Tuning, default_tuning
from .debug import scope
from .errors import OutOfHostMemory
from .ops.dc import undelta_dc, undelta_dc_values
from .ops.destuff import destuff_scan
from .ops.huffman import (SYMTAB_BITS, ScanArrays, ScanConfig, _emit_cap,
                          decode_scan)
from .ops.idct import idct_stream_to_planes
from .ops.transpose import deinterleave
from .ops.write import resolve_tile_mode
from .reader import JpegStream, Scan, num_mcus_in_segment, parse
from .staging import HostStaging, Region
from .staging import region as staging_region
from .tables import pack_huffman_tables


def resolve_device(device) -> torch.device:
    """``None`` means the card, and raises where there is none; the CPU is
    taken only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "jpeggpu_tpu_torch decodes on a CUDA device and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


def _bucket(n: int, quantum: int = 256) -> int:
    """Round up to a shape bucket: next multiple of `quantum` below
    4*quantum, then multiples of 8*quantum."""
    n = max(n, 1)
    if n <= 4 * quantum:
        return -(-n // quantum) * quantum
    q = 8 * quantum
    return -(-n // q) * q


@dataclasses.dataclass(frozen=True)
class ScanPlanStatic:
    """Hashable static geometry of one scan."""

    cfg: ScanConfig
    # raw scan buffer of the device destuff, bytes (a shape bucket, raised
    # to a batch group's floor), and the segment table's padded length
    scan_bytes_padded: int
    num_segments_padded: int
    num_mcus_x: int
    num_mcus_y: int
    # per scan component: (component_idx, off_in_mcu, ss_eff_x, ss_eff_y,
    #                      data_size_x, data_size_y, qtable_idx)
    comps: Tuple[Tuple[int, int, int, int, int, int, int], ...]
    # True: the host destuffs (native C++, numpy where there is no
    # compiler) and the staged input is the word stream. False: the raw
    # scan bytes are staged and destuffed on the device (ops/destuff.py).
    # The host is the default, as in the JAX package.
    host_destuff: bool = True

    @property
    def idct_geometry(self):
        """The scan as ``ops.idct.idct_stream_to_planes`` takes it:
        ``(num_mcus_x, num_mcus_y, ((off, ssx, ssy, qtable_idx), ...))``."""
        return (self.num_mcus_x, self.num_mcus_y,
                tuple((c[1], c[2], c[3], c[6]) for c in self.comps))


@dataclasses.dataclass(frozen=True)
class PlanSignature:
    scans: Tuple[ScanPlanStatic, ...]
    # per component: (size_x, size_y)
    comp_sizes: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class DecodePlan:
    signature: PlanSignature
    stream: JpegStream


def _tile_geometry(scan: Scan, tuning: Tuning) -> Dict:
    """Tile geometry of the records write path for one scan, in both its
    shapes, from the stream's average data units per subsequence; the
    tuning's nonzero fields override."""
    avg_du = scan.total_data_units / max(scan.num_subsequences, 1)
    # per-lane shape: about 5x the average covers nearly every lane (the
    # outliers drain through the leftover scatter), in four steps so that
    # images of similar density share their shapes
    tile_d = next((d for d in (32, 64, 96, 128) if d >= 5.0 * avg_du), 128)
    # G consecutive lanes share one super_d-row data-unit window. Target a
    # typical fill of about a third (G * avg_du <= 0.35 * super_d):
    # low-entropy lanes span several times the average, and one lane that
    # spans past the window sends itself to the leftover scatter. A power
    # of two, so that it divides the lane bucket.
    super_d = tuning.super_d or 128
    super_g = tuning.super_g
    if not super_g:
        super_g = 2
        while super_g < 32 and (2 * super_g) * avg_du <= 0.703 * super_d:
            super_g *= 2
    group_du = tuning.group_du or 256
    # expand window: supertiles per group_du-wide output group. Dense
    # regions pack 2-3x more supertiles per group than the average, so the
    # window is twice the average extent, with a floor and a cap (lanes
    # past the window drain through the leftover scatter).
    avg_extent = -(-group_du // max(int(super_g * avg_du), 1))
    super_w = (tuning.super_w
               or min(max(2 * avg_extent, 4), 4 + group_du // 16))
    # sparse scans (avg_du above ~55): even a 2-lane group typically spans
    # the 128-row window; "auto" routes those to the per-lane tile shape
    tile_auto = "lane" if avg_du > 55.0 else "super"
    return dict(tile_d=tile_d, super_g=super_g, super_w=super_w,
                super_d=super_d, group_du=group_du, tile_auto=tile_auto)


class ScanPad(NamedTuple):
    """Floors of one scan's content-dependent shape buckets (0 or "": no
    floor), so that the images of a batch group share one padded plan
    (``parallel/batch.py``). Each floor is one that keeps the decode exact:
    padded lanes are inert (lane validity is data-driven, see
    ``ops.huffman.make_ctx``), and a deeper tile, a smaller supertile
    group, a wider window or a larger expand group only sends fewer lanes
    through the leftover scatter, and a longer raw buffer only adds zero
    bytes past the scan, which the device destuff writes as zeros past the
    last segment's data. The reference's pad tuple has two more entries
    that have no counterpart here: ``hv_rows`` / ``hv_slot_rows`` size a
    TPU layout of the Huffman value table, which the CUDA kernels do not
    have."""

    lanes: int = 0  # at least this many lanes
    tile_d: int = 0  # at least this tile depth
    super_g: int = 0  # at most this many lanes per supertile
    super_w: int = 0  # at least this expand window
    tile_auto: str = ""  # "lane": tile_mode="auto" takes the per-lane shape
    group_du: int = 0  # at least this expand group
    super_d: int = 0  # at least this supertile depth
    scan_bytes: int = 0  # at least this raw scan buffer


def group_pad(plans: Sequence[DecodePlan]) -> Tuple[ScanPad, ...]:
    """Per scan, the floors that make every plan of ``plans`` (plans of one
    pixel geometry) the same: the largest lane bucket, tile depth, window,
    expand group, supertile depth and raw scan buffer, the smallest
    supertile group, and "lane" if any of them takes the per-lane shape."""
    pads = []
    for sps in zip(*(p.signature.scans for p in plans)):
        cfgs = [sp.cfg for sp in sps]
        pads.append(ScanPad(
            lanes=max(c.lanes for c in cfgs),
            tile_d=max(c.tile_d for c in cfgs),
            super_g=min(c.super_g for c in cfgs),
            super_w=max(c.super_w for c in cfgs),
            tile_auto=("lane" if any(c.tile_auto == "lane" for c in cfgs)
                       else "super"),
            group_du=max(c.group_du for c in cfgs),
            super_d=max(c.super_d for c in cfgs),
            scan_bytes=max(sp.scan_bytes_padded for sp in sps)))
    return tuple(pads)


def _floored(geometry: Dict, lanes: int, pad: Optional[ScanPad]):
    """Scan geometry and lane bucket raised to ``pad``'s floors."""
    if pad is None:
        return geometry, lanes
    g = dict(geometry)
    g["tile_d"] = max(g["tile_d"], pad.tile_d)
    if pad.super_g:
        g["super_g"] = min(g["super_g"], pad.super_g)
    g["super_w"] = max(g["super_w"], pad.super_w)
    if pad.tile_auto == "lane":
        g["tile_auto"] = "lane"
    g["group_du"] = max(g["group_du"], pad.group_du)
    g["super_d"] = max(g["super_d"], pad.super_d)
    return g, max(lanes, pad.lanes)


def build_plan(stream: JpegStream, tuning: Optional[Tuning] = None, *,
               host_destuff: bool = True,
               pad_scans: Optional[Sequence[ScanPad]] = None) -> DecodePlan:
    """Build the decode plan (static geometry) for a parsed stream under
    ``tuning`` (default: the process default, ``config.default_tuning``).
    ``host_destuff=False`` stages each scan's raw bytes for the device
    destuff (:attr:`ScanPlanStatic.host_destuff`).

    ``pad_scans`` optionally gives per scan a :class:`ScanPad` of floors
    for its shape buckets: a batch pads every image of a mixed group up to
    the group's values (:func:`group_pad`) so that they share one plan."""
    if tuning is None:
        tuning = default_tuning()
    scans = []
    for si, scan in enumerate(stream.scans):
        comps = []
        for sc in scan.components:
            comp = stream.components[sc.component_idx]
            # a non-interleaved scan's MCU is one data unit (T.81 A.2.2)
            ss_x = comp.ss_x if scan.interleaved else 1
            ss_y = comp.ss_y if scan.interleaved else 1
            comps.append((sc.component_idx, sc.off_in_mcu, ss_x, ss_y,
                          sc.data_size_x, sc.data_size_y, comp.qtable_idx))
        comp_groups = []
        end = 0
        for sc in scan.components:
            end += sc.du_per_mcu
            comp_groups.append((end,
                                sc.dc_table_id * C.HUFF_COUNT + C.HUFF_DC,
                                sc.ac_table_id * C.HUFF_COUNT + C.HUFF_AC))
        used_slots = {g[1] for g in comp_groups} | {g[2] for g in comp_groups}
        pad = pad_scans[si] if pad_scans and si < len(pad_scans) else None
        geometry, lanes = _floored(_tile_geometry(scan, tuning),
                                   _bucket(scan.num_subsequences), pad)
        cfg = ScanConfig(
            lanes=lanes,
            num_segments=scan.num_segments,
            du_per_mcu=scan.num_data_units_in_mcu,
            mcus_per_seg=num_mcus_in_segment(stream, scan),
            total_mcus=scan.num_mcus,
            comp_groups=tuple(comp_groups),
            fast_tables=not any(scan.huff_tables[s].saturated
                                for s in used_slots),
            tuning=tuning,
            **geometry,
        )
        scans.append(ScanPlanStatic(
            cfg=cfg,
            scan_bytes_padded=max(_bucket(scan.end - scan.begin, 1024),
                                  pad.scan_bytes if pad else 0),
            num_segments_padded=_bucket(scan.num_segments, 64),
            num_mcus_x=scan.num_mcus_x, num_mcus_y=scan.num_mcus_y,
            comps=tuple(comps), host_destuff=host_destuff))
    sig = PlanSignature(
        scans=tuple(scans),
        comp_sizes=tuple((c.size_x, c.size_y) for c in stream.components),
    )
    return DecodePlan(signature=sig, stream=stream)


# --- host -> device staging -------------------------------------------------

def _destuff_host(buf: np.ndarray, scan: Scan, lanes: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Host destuff -> big-endian uint32 words, padded to `lanes`
    subsequences, written whole into ``out`` (a fresh array where it is
    None): the native C++ destuffer where the machine has a compiler, the
    numpy one otherwise."""
    from . import native
    from .golden import destuff_scan_host

    if out is None:
        out = np.empty(lanes * C.CHUNK_SIZE_WORDS, np.uint32)
    with scope("jpeggpu.destuff.host"):
        if native.destuff_words(buf[scan.begin:scan.end], scan.segments[:, 0],
                                scan.num_subsequences, scan.seg_raw, out):
            return out
        words = np.frombuffer(destuff_scan_host(buf, scan).tobytes(), ">u4")
        out[:len(words)] = words
        out[len(words):] = 0
    return out


# the per-lane segment tables of a scan
_LANE_TABLES = ("seg_of_subseq", "seg_first_lane", "seg_num_subseq")


def scan_fields(sp: ScanPlanStatic, batch: int = 1, merged: bool = False):
    """The fields of one scan's staging region (``staging.Region``): the
    word stream (under ``host_destuff=False`` the raw body and each
    segment's first subsequence), the per-lane segment tables, for a
    merged group of ``batch`` images the position bounds, and the Huffman
    and symbol tables."""
    lanes = batch * sp.cfg.lanes
    if sp.host_destuff:
        fields = [("words", np.uint32, (lanes * C.CHUNK_SIZE_WORDS,))]
    else:
        fields = [("raw", np.uint8, (sp.scan_bytes_padded,)),
                  ("seg_sub_offset", np.int32, (sp.num_segments_padded,))]
    fields += [(name, np.int32, (lanes,)) for name in _LANE_TABLES]
    if merged:
        fields += [(name, np.int32, (lanes,))
                   for name in ("pos_base", "pos_bound")]
    return fields + list(convert.TABLE_FIELDS)


def scan_region(buf: np.ndarray, scan: Scan, sp: ScanPlanStatic,
                staging: Optional[HostStaging] = None) -> Region:
    """One scan's region (of ``staging``, or of its own) with its arrays
    written, padded to the plan's bucket shapes: the destuffed word stream
    (``words``, which the native destuffer writes straight into it; under
    ``host_destuff=False`` the raw scan body ``raw`` and each segment's
    first subsequence ``seg_sub_offset`` instead), the per-lane segment
    tables, the packed Huffman tables and the symbol table."""
    region = staging_region(scan_fields(sp), staging)
    counts = scan.segments[:, 1]
    seg_of = np.repeat(np.arange(scan.num_segments, dtype=np.int32), counts)
    n = len(seg_of)
    region["seg_of_subseq"][:n] = seg_of
    region["seg_of_subseq"][n:] = max(scan.num_segments - 1, 0)
    region["seg_first_lane"][:n] = scan.segments[seg_of, 0]
    region["seg_num_subseq"][:n] = scan.segments[seg_of, 1]
    last = scan.segments[-1] if scan.num_segments else (0, 0)
    region["seg_first_lane"][n:] = last[0]
    region["seg_num_subseq"][n:] = last[1]
    maxcode, vsm, huffval = pack_huffman_tables(scan.huff_tables)
    region["maxcode"][...] = maxcode
    region["vsm"][...] = vsm
    region["huffval"][...] = huffval
    region["symtab"][...] = convert.symbol_table(
        maxcode, vsm, huffval, sp.cfg.fast_tables)
    if sp.host_destuff:
        _destuff_host(buf, scan, sp.cfg.lanes, region["words"])
    else:
        raw, size = region["raw"], scan.end - scan.begin
        raw[:size] = buf[scan.begin:scan.end]
        raw[size:] = 0
        seg_sub_offset = region["seg_sub_offset"]
        seg_sub_offset[:scan.num_segments] = scan.segments[:, 0]
        seg_sub_offset[scan.num_segments:] = scan.num_subsequences
    return region


def build_inputs(data: bytes | np.ndarray, plan: DecodePlan,
                 staging: Optional[HostStaging] = None) -> Dict:
    """The host inputs of a decode: per scan its arrays (the staged state:
    :func:`scan_region`'s, the symbol table left out) and the quantisation
    tables (int32[4, 64]), as views of their regions (``regions``, one per
    scan, and ``qtables_region``), which :func:`stage_inputs` copies whole.
    ``staging`` is the decoder's (``staging.HostStaging``), whose call has
    begun; without one each region is a buffer of its own."""
    buf = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, np.uint8)
    try:
        with scope("jpeggpu.inputs"):
            regions = [scan_region(buf, scan, sp, staging) for scan, sp in
                       zip(plan.stream.scans, plan.signature.scans)]
            q = staging_region(
                [("qtables", np.int32, plan.stream.qtables.shape)], staging)
            q["qtables"][...] = plan.stream.qtables
    except MemoryError as exc:
        raise OutOfHostMemory(
            f"host staging buffers exceed available memory: {exc}") from exc
    return dict(scans=[r.arrays() for r in regions], qtables=q["qtables"],
                regions=regions, qtables_region=q)


def stage_inputs(inputs: Dict, plan: DecodePlan, device: torch.device) -> Dict:
    """Copy the host inputs of :func:`build_inputs` to ``device``, with each
    scan's symbol table under its plan's ``fast_tables``: the word stream,
    or for a scan planned with ``host_destuff=False`` its raw bytes, which
    :func:`destuffed` turns into words on the device. One copy per scan's
    region and one for the quantisation tables."""
    with scope("jpeggpu.copy_in", device):
        return dict(
            scans=[convert.scan_arrays(s, device, sp.cfg.fast_tables, r)
                   for s, sp, r in zip(inputs["scans"], plan.signature.scans,
                                       inputs["regions"])],
            qtables=inputs["qtables_region"].to(device)["qtables"],
        )


def plan_buffer_size(plan: DecodePlan) -> int:
    """Device memory one decode of this plan allocates, in bytes: the sum
    of the tensors the pipeline creates (staged inputs, decode context,
    two generations of sync states, write inputs, the coefficient stream,
    the DC vector and the padded output planes). Knowable from the header
    alone."""
    total = 4 * C.MAX_COMPONENTS * 64  # qtables
    for sp in plan.signature.scans:
        cfg = sp.cfg
        lane_i32 = 4 * cfg.lanes
        tables = (4 * (2 * 128 + 2048 + 128 + 2 * cfg.du_per_mcu + 64)
                  + 2 * (8 << SYMTAB_BITS))
        staged = (C.CHUNK_SIZE_WORDS + 3) * lane_i32
        ctx = 4 * lane_i32 + 2 * cfg.lanes
        sync = (4 + 4 + 3) * lane_i32 + 4 * (cfg.lanes + 1)  # + the flags
        write = 3 * lane_i32 + cfg.lanes
        total_du = cfg.total_mcus * cfg.du_per_mcu
        coeffs = 2 * cfg.total_positions + 2 * total_du
        planes = sum(c[4] * c[5] for c in sp.comps)
        total += tables + staged + ctx + sync + write + coeffs + planes
        if not sp.host_destuff:
            # the raw body and the segment table; the destuff's widest
            # moment, its running maximum (ops.destuff._segment_base):
            # three byte masks, the byte counts, their product with the
            # markers, the maximum and its int64 indices, 23 bytes per raw
            # byte (24 counted, for the allocator's rounding); its output,
            # whose view is the words, has one byte more
            n = sp.scan_bytes_padded
            total += n + 4 * sp.num_segments_padded + 24 * n + 1
        if cfg.tuning.write_mode != "tiles":
            continue
        s_cap = _emit_cap(cfg.tuning.write_chunk)
        total += 4 * s_cap * cfg.lanes  # the emission buffer
        if resolve_tile_mode(cfg.tuning.tile_mode, cfg.tile_auto) == "super":
            # the trimmed records in their widest intermediate form
            # (unpacked value and position, data unit, row index, packed
            # and interleaved rows), the supertiles, the padding of the
            # dense rows and the DC side vector
            trimmed = min(cfg.tuning.s_trim, s_cap) * cfg.lanes
            n_st = cfg.lanes // cfg.super_g
            pad_du = cfg.group_du + 2
            total += (28 * trimmed + 128 * cfg.super_d * n_st
                      + 130 * pad_du + 2 * total_du)
        else:
            # the full-depth records unpacked (int16 value, int32 global
            # position) and, at the widest moment, both unpacked halves as
            # int32, the rebased position and its mask; one tile per lane;
            # the padding of the dense rows (groups of 128 data units)
            total += (6 + 13) * s_cap * cfg.lanes
            total += 128 * cfg.tile_d * cfg.lanes + 128 * (128 + 2)
    return total


# --- the device pipeline ----------------------------------------------------

def scan_planes(sp: ScanPlanStatic, coeffs: torch.Tensor,
                dcd: Optional[torch.Tensor], qtables: torch.Tensor,
                with_idct: bool = True) -> List[torch.Tensor]:
    """The tail of one scan of one image, or of B images of one plan whose
    streams follow one another (a merged group): the stream-order
    coefficients (``coeffs``, DC still difference-coded; ``dcd`` the
    records path's DC side vector or None) -> per scan component its
    uncropped plane. ``qtables`` is int32[(4, 64)] for one image and
    int32[(B, 4, 64)] for B, whose planes are then [(B, H, W)]. The
    tensor ops and launches do not depend on B.

    ``with_idct``: the DC un-delta as a side vector, then K3 (uint8
    pixels). Else the reference's non-fused tail: the DC un-delta rewrites
    the stream, which is de-interleaved into int16 coefficient planes."""
    cfg = sp.cfg
    dev = coeffs.device
    batch = qtables.shape[0] if qtables.dim() == 3 else 1
    comp_slots = tuple((c[1], c[2] * c[3]) for c in sp.comps)
    if not with_idct:
        with scope("jpeggpu.dc", dev):
            coeffs = undelta_dc(cfg, comp_slots, coeffs, batch)
        with scope("jpeggpu.deinterleave", dev):
            # B streams one after another are one image B times as tall
            planes = deinterleave(coeffs, cfg.du_per_mcu, sp.num_mcus_x,
                                  batch * sp.num_mcus_y,
                                  [c[1:4] for c in sp.comps])
        if qtables.dim() == 3:
            planes = [p.view(batch, -1, p.shape[1]) for p in planes]
        return planes
    # DC un-delta as a side vector: the stream -> plane kernel takes slot
    # 0 from it, so the DC stage never rewrites the stream
    with scope("jpeggpu.dc", dev):
        dcv = undelta_dc_values(cfg, comp_slots, coeffs, dc=dcd, batch=batch)
    with scope("jpeggpu.idct_fused", dev):
        return idct_stream_to_planes(coeffs, qtables, sp.idct_geometry,
                                     cfg.du_per_mcu, dcv)


def crop(signature: PlanSignature,
         planes: Dict[int, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Component index -> uncropped plane ([H, W], or [B, H, W] for a
    merged group), to the planes in component order, cropped to component
    size."""
    return tuple(planes[ci][..., :size_y, :size_x]
                 for ci, (size_x, size_y) in enumerate(signature.comp_sizes))


def destuffed(arrs: ScanArrays, lanes: int) -> ScanArrays:
    """A scan staged raw (``host_destuff=False``) -> the same scan with its
    words, destuffed on the device that holds its bytes; a scan that has
    its words already is returned as it is."""
    if arrs.words is not None:
        return arrs
    with scope("jpeggpu.destuff", arrs.raw.device):
        words = destuff_scan(arrs.raw, arrs.seg_sub_offset, lanes)
    return dataclasses.replace(arrs, words=words, raw=None,
                               seg_sub_offset=None)


def decode_pipeline(signature: PlanSignature, scan_arrays: List[ScanArrays],
                    qtables: torch.Tensor, with_idct: bool = True, *,
                    donate: bool = False) -> Tuple[torch.Tensor, ...]:
    """Full-image decode on the device of the staged inputs. Returns the
    per-component planes, cropped to component size: uint8 pixels, or
    with ``with_idct=False`` int16 coefficient planes (DC un-deltaed).

    ``donate=True`` hands the staged scans over: each entry of
    ``scan_arrays`` is set to None as its scan starts, so that, where the
    caller holds no other reference, the raw bytes are freed once
    destuffed and the words and tables once the write stage has read
    them, and the caching allocator reuses that memory for the tail."""
    pix: Dict[int, torch.Tensor] = {}
    for i, sp in enumerate(signature.scans):
        arrs = scan_arrays[i]
        if donate:
            scan_arrays[i] = None
        arrs = destuffed(arrs, sp.cfg.lanes)
        # dcd: the records write path's difference-coded DC side vector
        # (None from the direct write, which has none)
        coeffs, dcd = decode_scan(sp.cfg, arrs, return_dc=True)
        del arrs
        with scope("jpeggpu.tail", coeffs.device):
            planes = scan_planes(sp, coeffs, dcd, qtables, with_idct)
        for c, plane in zip(sp.comps, planes):
            pix[c[0]] = plane
    return crop(signature, pix)


def decode_jpeg_device(data: bytes, *, device=None,
                       plan: Optional[DecodePlan] = None,
                       with_idct: bool = True) -> List[np.ndarray]:
    """One-shot decode of a JPEG; ``device=None`` is the card."""
    dev = resolve_device(device)
    if plan is None:
        plan = build_plan(parse(data))
    staged = stage_inputs(build_inputs(data, plan), plan, dev)
    out = decode_pipeline(plan.signature, staged["scans"], staged["qtables"],
                          with_idct)
    return [p.contiguous().cpu().numpy() for p in out]
