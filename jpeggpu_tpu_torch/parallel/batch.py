"""Batched decode: many images, one wide decode per group.

The port of ``jpeggpu_tpu/parallel/batch.py``. Decoding is lane-parallel,
so a group of B images of one pixel geometry that share their Huffman
tables is one bigger decode: their staged arrays are concatenated along the
lane axis (each image's restart segments become more independent segments,
:func:`merge_region`), the entropy decode runs once at B x lanes width
(K1 once per sync round, then K2, or K4-K8 under a records plan, as
``ops.huffman.decode_scan`` dispatches on the plan's ``write_mode``), and
the tail runs once per scan over the whole merged stream
(``pipeline.scan_planes``): one DC un-delta whose sums restart at every
segment of every image, then K3 once for all the images, or with
``with_idct=False`` the non-fused tail. Each component comes back to the
host in one copy for the group, ``[B, size_y, size_x]``, and each image's
plane is its slice.

Images are grouped by pixel geometry (:func:`_geometry_key`); within a
group the content-dependent shape buckets (lanes, tile geometry) are raised
to the group's (``pipeline.group_pad``), so that images of one size whose
streams differ in length share one padded plan. A group that cannot merge
(tables that differ, ``merged=False``, or a group of one) decodes its
images one after another through ``pipeline.decode_pipeline`` on that
padded plan.

On a :class:`~jpeggpu_tpu_torch.parallel.Mesh` a mergeable group is padded
by repeating its last image to a multiple of the mesh size, and each device
decodes its B/D images as one merged decode; the planes come back in input
order without the padding. The devices may repeat; the devices' decodes run
one after another from one host thread.

The reference splits the merged records path per image on the TPU
(``_merged_scan_coeffs_split``, ``pos_offset``) because merged-size
relayouts lower badly there; here the records path runs over the whole
merged width in both tile shapes, so that split has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from .. import convert
from ..debug import scope
from ..errors import InvalidArgument
from ..ops.huffman import ScanArrays, decode_scan
from ..pipeline import (DecodePlan, PlanSignature, ScanPlanStatic,
                        build_inputs, build_plan, crop, decode_pipeline,
                        group_pad, resolve_device, scan_fields, scan_planes,
                        stage_inputs)
from ..reader import parse
from ..staging import HostStaging, Region
from ..staging import region as staging_region
from . import Mesh
from .segments import _on


def merge_region(sp: ScanPlanStatic, per_image: List[Dict],
                 staging: Optional[HostStaging] = None) -> Region:
    """Concatenate B images' staged arrays of one scan along the lane axis,
    into one region (of ``staging``, or of its own) with the group's symbol
    table; ``.arrays()`` of the region is the merged staged state.

    Segment indices are offset by ``b * num_segments`` and first lanes by
    ``b * lanes``; ``pos_base`` / ``pos_bound`` (int32 per lane) place image
    b's positions at ``[b * T, (b + 1) * T)`` for a scan of T positions.
    The Huffman tables are image 0's: the caller checks that they are
    shared (:func:`_tables_shared`). Raises ``ValueError`` where a merged
    position would pass int32 (``constants.I32_MAX``); the decode itself
    refuses bit offsets past it (``ops.huffman.make_ctx``). The scans
    must be host-destuffed (``host_destuff=True``), as in the JAX
    package: a raw-staged scan raises ``ValueError``."""
    if not sp.host_destuff:
        raise ValueError("the merged decode takes host-destuffed scans "
                         "(host_destuff=True)")
    cfg = sp.cfg
    L = cfg.lanes
    B = len(per_image)
    pps = cfg.positions_per_seg
    total = cfg.total_positions
    if B * total > C.I32_MAX:
        raise ValueError(
            f"merged batch of {B} images x {total} positions overflows int32 "
            f"position indices; split into sub-batches")
    out = staging_region(scan_fields(sp, B, merged=True), staging)
    W = L * C.CHUNK_SIZE_WORDS
    for b, i in enumerate(per_image):
        lanes = slice(b * L, (b + 1) * L)
        out["words"][b * W:(b + 1) * W] = i["words"]
        np.add(i["seg_of_subseq"], b * cfg.num_segments,
               out=out["seg_of_subseq"][lanes])
        np.add(i["seg_first_lane"], b * L, out=out["seg_first_lane"][lanes])
        out["seg_num_subseq"][lanes] = i["seg_num_subseq"]
    seg_local = np.concatenate([i["seg_of_subseq"] for i in per_image])
    seg_local = seg_local.astype(np.int64)
    img_of = np.repeat(np.arange(B, dtype=np.int64), L)
    out["pos_base"][...] = img_of * total + seg_local * pps
    out["pos_bound"][...] = (np.minimum((seg_local + 1) * pps, total)
                             + img_of * total)
    first = per_image[0]
    for name in ("maxcode", "vsm", "huffval"):
        out[name][...] = first[name]
    out["symtab"][...] = convert.symbol_table(
        first["maxcode"], first["vsm"], first["huffval"], cfg.fast_tables)
    return out


def _tables_shared(per_image: List[Dict]) -> bool:
    first = per_image[0]
    return all(
        np.array_equal(i["maxcode"], first["maxcode"]) and
        np.array_equal(i["vsm"], first["vsm"]) and
        np.array_equal(i["huffval"], first["huffval"])
        for i in per_image[1:])


def _geometry_key(sig: PlanSignature) -> PlanSignature:
    """The signature with its content-dependent shape buckets erased:
    images with equal keys share one plan after padding."""
    scans = tuple(
        dataclasses.replace(
            sp, scan_bytes_padded=0,
            cfg=dataclasses.replace(sp.cfg, lanes=0, tile_d=0, super_g=0,
                                    super_w=0, super_d=0, group_du=0,
                                    tile_auto=""))
        for sp in sig.scans)
    return PlanSignature(scans=scans, comp_sizes=sig.comp_sizes)


@dataclasses.dataclass
class MergedScan:
    """One scan of a merged group on its device."""

    arrs: ScanArrays  # B x lanes wide
    pos_base: torch.Tensor  # int32[B * lanes]
    pos_bound: torch.Tensor  # int32[B * lanes]


def stage_merged(sig: PlanSignature, inputs: List[Dict], device: torch.device,
                 staging: Optional[HostStaging] = None
                 ) -> Tuple[List[MergedScan], torch.Tensor]:
    """Host inputs of B images of one plan (``pipeline.build_inputs``) ->
    their merged scans and their quantisation tables (int32[B, 4, 64]) on
    ``device``: per scan one region (of ``staging``, or of its own) in one
    copy, and one for the tables. The symbol table is image 0's."""
    scans = []
    for s, sp in enumerate(sig.scans):
        with scope("jpeggpu.merge", device):
            region = merge_region(sp, [i["scans"][s] for i in inputs],
                                  staging)
        with scope("jpeggpu.copy_in", device):
            t = convert.device_arrays(region.arrays(), device,
                                      sp.cfg.fast_tables, region)
            scans.append(MergedScan(arrs=convert.scan_arrays_of(t),
                                    pos_base=t["pos_base"],
                                    pos_bound=t["pos_bound"]))
    with scope("jpeggpu.copy_in", device):
        q = staging_region([("qtables", np.int32,
                             (len(inputs),) + inputs[0]["qtables"].shape)],
                           staging)
        np.stack([i["qtables"] for i in inputs], out=q["qtables"])
        return scans, q.to(device)["qtables"]


def _merged_scan_coeffs(sp: ScanPlanStatic, ms: MergedScan, batch: int):
    """The entropy decode of one merged scan at ``batch`` x lanes width:
    ``(coeffs, dc)``, the flat int16[batch * T] stream and the records
    path's DC side vector (None from the direct write)."""
    cfg = dataclasses.replace(sp.cfg, lanes=batch * sp.cfg.lanes)
    return decode_scan(cfg, ms.arrs, return_dc=True, pos_base=ms.pos_base,
                       bound=ms.pos_bound,
                       total_out=batch * sp.cfg.total_positions)


def decode_merged(sig: PlanSignature, scans: List[MergedScan],
                  qtables: torch.Tensor,
                  with_idct: bool = True) -> Tuple[torch.Tensor, ...]:
    """A merged group of B images, staged by :func:`stage_merged`: per
    component its cropped planes, ``[B, size_y, size_x]`` (image b's is
    index b), on the device of the staged inputs."""
    batch = qtables.shape[0]
    pix: Dict[int, torch.Tensor] = {}
    for sp, ms in zip(sig.scans, scans):
        coeffs, dcd = _merged_scan_coeffs(sp, ms, batch)
        with scope("jpeggpu.tail", coeffs.device):
            planes = scan_planes(sp, coeffs, dcd, qtables, with_idct)
        for c, plane in zip(sp.comps, planes):
            pix[c[0]] = plane
    return crop(sig, pix)


def _to_numpy(planes) -> List[np.ndarray]:
    """Planes on the device -> numpy, one copy each."""
    with scope("jpeggpu.to_host", planes[0].device):
        return [p.contiguous().cpu().numpy() for p in planes]


@dataclasses.dataclass
class _Group:
    plan: DecodePlan
    indices: List[int]
    inputs: List[Dict]


class BatchDecoder:
    """Decode batches of JPEGs on one device or over a mesh.

    Same-geometry images that share Huffman tables decode through the
    merged-lane path (one decode at B x lanes width); the others one after
    another on their group's padded plan. ``device=None`` is the card;
    ``mesh`` spreads each mergeable group over its devices instead, and
    cannot be given with ``device``.

    After a :meth:`decode`, ``routes`` lists the device decodes it ran, in
    order: ``(route, images)`` with ``route`` one of "merged",
    "mesh_merged" (one entry per device) or "per_image", and ``images``
    the input indices decoded (a padded image repeats its index).

    The decoder stages every call through one host buffer of its own
    (``staging.HostStaging``, pinned on a CUDA device), reused from call to
    call and grown to the largest; :meth:`release` lets it go.
    """

    def __init__(self, mesh: Optional[Mesh] = None, with_idct: bool = True,
                 merged: bool = True, *, device=None):
        if mesh is not None and device is not None:
            raise InvalidArgument("BatchDecoder takes a mesh or a device, "
                                  "not both")
        self.mesh = mesh
        self.with_idct = with_idct
        self.merged = merged
        self.device = None if mesh is not None else resolve_device(device)
        self.routes: List[Tuple[str, Tuple[int, ...]]] = []
        # the host buffer every call stages through, pinned on CUDA
        self._staging = HostStaging(self.device if mesh is None
                                    else mesh.devices[0])

    def _groups(self, datas: Sequence[bytes],
                prelim: Optional[List[DecodePlan]] = None) -> List[_Group]:
        """Parse, the preliminary plans (``prelim``, if the caller has made
        them already), the groups by geometry, and the padded plans; groups
        keyed by the padded signature."""
        dev = self.device
        if prelim is None:
            prelim = []
            for data in datas:
                with scope("jpeggpu.parse", dev):
                    stream = parse(data)
                with scope("jpeggpu.plan", dev):
                    prelim.append(build_plan(stream))
        parsed = [plan.stream for plan in prelim]
        geo: Dict[PlanSignature, List[int]] = {}
        with scope("jpeggpu.group", dev):
            for i, plan in enumerate(prelim):
                geo.setdefault(_geometry_key(plan.signature), []).append(i)
        groups: Dict[PlanSignature, _Group] = {}
        for idxs in geo.values():
            with scope("jpeggpu.group", dev):
                pad = group_pad([prelim[i] for i in idxs])
            for i in idxs:
                if len(idxs) == 1:
                    plan = prelim[i]
                else:
                    with scope("jpeggpu.plan", dev):
                        plan = build_plan(parsed[i], pad_scans=pad)
                g = groups.get(plan.signature)
                if g is None:
                    g = groups[plan.signature] = _Group(plan, [], [])
                g.indices.append(i)
                g.inputs.append(build_inputs(datas[i], plan, self._staging))
        return list(groups.values())

    def _merged(self, g: _Group, indices: List[int], inputs: List[Dict],
                device: torch.device, route: str):
        """Merged decodes of ``inputs`` on ``device``, in sub-batches that
        keep positions and bit offsets within int32 (``C.I32_MAX``)."""
        sig = g.plan.signature
        widest = max(max(sp.cfg.total_positions,
                         sp.cfg.lanes * C.SUBSEQ_SIZE_BITS)
                     for sp in sig.scans)
        limit = max(1, C.I32_MAX // widest)
        out = []
        for lo in range(0, len(inputs), limit):
            with _on(device):
                scans, qtables = stage_merged(sig, inputs[lo:lo + limit],
                                              device, self._staging)
                planes = decode_merged(sig, scans, qtables, self.with_idct)
            # one copy per component for the group; image b's planes are
            # index b of each (C-contiguous)
            group = _to_numpy(planes)
            out += [[a[b] for a in group] for b in range(len(group[0]))]
            self.routes.append((route, tuple(indices[lo:lo + limit])))
        return out

    def _per_image(self, g: _Group, i: int, inputs: Dict,
                   device: torch.device) -> List[np.ndarray]:
        with _on(device):
            staged = stage_inputs(inputs, g.plan, device)
            planes = decode_pipeline(g.plan.signature, staged["scans"],
                                     staged["qtables"], self.with_idct)
        self.routes.append(("per_image", (i,)))
        return _to_numpy(planes)

    def decode(self, datas: Sequence[bytes],
               prelim: Optional[List[DecodePlan]] = None
               ) -> List[List[np.ndarray]]:
        """Decode a sequence of JPEGs; returns per image its component
        planes as numpy arrays, in input order: uint8 pixels, or with
        ``with_idct=False`` int16 coefficient planes, cropped to component
        size. ``prelim`` are the images' plans from ``build_plan(parse(
        data))``, where the caller has made them already."""
        with scope("jpeggpu.batch", self.device):
            return self._decode(datas, prelim)

    def _decode(self, datas: Sequence[bytes],
                prelim: Optional[List[DecodePlan]]
                ) -> List[List[np.ndarray]]:
        self.routes = []
        # the last call's copies from the staging buffer are done before
        # this call writes over it
        self._staging.begin()
        results: List[Optional[List[np.ndarray]]] = [None] * len(datas)
        for g in self._groups(datas, prelim):
            sig = g.plan.signature
            with scope("jpeggpu.group", self.device):
                mergeable = self.merged and all(
                    _tables_shared([bi["scans"][s] for bi in g.inputs])
                    for s in range(len(sig.scans)))
            if mergeable and self.mesh is not None:
                D = self.mesh.size
                pad = (-len(g.inputs)) % D
                indices = g.indices + [g.indices[-1]] * pad
                inputs = g.inputs + [g.inputs[-1]] * pad
                k = len(inputs) // D
                planes = []
                for d, dev in enumerate(self.mesh.devices):
                    planes += self._merged(g, indices[d * k:(d + 1) * k],
                                           inputs[d * k:(d + 1) * k], dev,
                                           "mesh_merged")
                for i, p in zip(g.indices, planes):
                    results[i] = p
            elif mergeable and len(g.inputs) > 1:
                for i, p in zip(g.indices, self._merged(
                        g, g.indices, g.inputs, self.device, "merged")):
                    results[i] = p
            else:
                devices = (self.mesh.devices if self.mesh is not None
                           else (self.device,))
                for n, (i, inputs) in enumerate(zip(g.indices, g.inputs)):
                    dev = devices[n * len(devices) // len(g.inputs)]
                    results[i] = self._per_image(g, i, inputs, dev)
        return results  # type: ignore[return-value]

    def release(self) -> None:
        """Wait for the copies from the staging buffer and let it go; the
        next :meth:`decode` allocates a new one."""
        self._staging.release()


def decode_batch(datas: Sequence[bytes], mesh: Optional[Mesh] = None,
                 with_idct: bool = True, *,
                 device=None) -> List[List[np.ndarray]]:
    """Decode a batch of JPEGs (:class:`BatchDecoder`); ``device=None`` and
    no mesh is the card."""
    decoder = BatchDecoder(mesh=mesh, with_idct=with_idct, device=device)
    try:
        return decoder.decode(datas)
    finally:
        decoder.release()
