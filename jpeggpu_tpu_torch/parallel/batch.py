"""Batched decode: many images, one wide decode per group.

The port of ``jpeggpu_tpu/parallel/batch.py``. Decoding is lane-parallel,
so a group of B images of one pixel geometry that share their Huffman
tables is one bigger decode: their staged arrays are concatenated along the
lane axis (each image's restart segments become more independent segments,
:func:`merge_scan_inputs`), the entropy decode runs once at B x lanes width
(K1 once per sync round, then K2, or K4-K8 under a records plan, as
``ops.huffman.decode_scan`` dispatches on the plan's ``write_mode``), and
the merged coefficient stream is cut per image for the tail: K3 once per
image and scan, or with ``with_idct=False`` the non-fused tail
(``pipeline.scan_planes``).

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
from ..errors import InvalidArgument
from ..ops.huffman import ScanArrays, decode_scan
from ..pipeline import (DecodePlan, PlanSignature, ScanPlanStatic,
                        build_inputs, build_plan, crop, decode_pipeline,
                        group_pad, resolve_device, scan_planes, stage_inputs)
from ..reader import parse
from . import Mesh
from .segments import _on


def merge_scan_inputs(sp: ScanPlanStatic,
                      per_image: List[Dict]) -> Dict[str, np.ndarray]:
    """Concatenate B images' staged arrays of one scan along the lane axis.

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
    seg_local = np.concatenate([i["seg_of_subseq"] for i in per_image])
    seg_local = seg_local.astype(np.int64)
    img_of = np.repeat(np.arange(B, dtype=np.int64), L)
    pos_base = img_of * total + seg_local * pps
    pos_bound = np.minimum((seg_local + 1) * pps, total) + img_of * total
    return dict(
        words=np.concatenate([i["words"] for i in per_image]),
        seg_of_subseq=np.concatenate(
            [i["seg_of_subseq"] + b * cfg.num_segments
             for b, i in enumerate(per_image)]),
        seg_first_lane=np.concatenate(
            [i["seg_first_lane"] + b * L for b, i in enumerate(per_image)]),
        seg_num_subseq=np.concatenate(
            [i["seg_num_subseq"] for i in per_image]),
        pos_base=pos_base.astype(np.int32),
        pos_bound=pos_bound.astype(np.int32),
        maxcode=per_image[0]["maxcode"], vsm=per_image[0]["vsm"],
        huffval=per_image[0]["huffval"],
    )


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


def stage_merged(sig: PlanSignature, inputs: List[Dict], device: torch.device
                 ) -> Tuple[List[MergedScan], torch.Tensor]:
    """Host inputs of B images of one plan (``pipeline.build_inputs``) ->
    their merged scans and their quantisation tables (int32[B, 4, 64]) on
    ``device``. The symbol table is staged once, from image 0's tables."""
    scans = []
    for s, sp in enumerate(sig.scans):
        m = merge_scan_inputs(sp, [i["scans"][s] for i in inputs])
        scans.append(MergedScan(
            arrs=convert.scan_arrays(m, device, sp.cfg.fast_tables),
            pos_base=torch.from_numpy(m["pos_base"]).to(device),
            pos_bound=torch.from_numpy(m["pos_bound"]).to(device)))
    qtables = torch.from_numpy(np.stack([i["qtables"] for i in inputs]))
    return scans, qtables.to(device)


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
                  with_idct: bool = True) -> List[Tuple[torch.Tensor, ...]]:
    """A merged group, staged by :func:`stage_merged`: per image its
    cropped planes, on the device of the staged inputs."""
    batch = qtables.shape[0]
    pix: List[Dict[int, torch.Tensor]] = [{} for _ in range(batch)]
    for sp, ms in zip(sig.scans, scans):
        coeffs, dcd = _merged_scan_coeffs(sp, ms, batch)
        T = sp.cfg.total_positions
        tdu = T // C.DATA_UNIT_SIZE
        for b in range(batch):
            # image b's stream and DC are views at its offset
            dcb = None if dcd is None else dcd[b * tdu:(b + 1) * tdu]
            planes = scan_planes(sp, coeffs[b * T:(b + 1) * T], dcb,
                                 qtables[b], with_idct)
            for c, plane in zip(sp.comps, planes):
                pix[b][c[0]] = plane
    return [crop(sig, p) for p in pix]


def _to_numpy(planes) -> List[np.ndarray]:
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

    def _groups(self, datas: Sequence[bytes],
                prelim: Optional[List[DecodePlan]] = None) -> List[_Group]:
        """Parse, the preliminary plans (``prelim``, if the caller has made
        them already), the groups by geometry, and the padded plans; groups
        keyed by the padded signature."""
        if prelim is None:
            prelim = [build_plan(parse(data)) for data in datas]
        parsed = [plan.stream for plan in prelim]
        geo: Dict[PlanSignature, List[int]] = {}
        for i, plan in enumerate(prelim):
            geo.setdefault(_geometry_key(plan.signature), []).append(i)
        groups: Dict[PlanSignature, _Group] = {}
        for idxs in geo.values():
            pad = group_pad([prelim[i] for i in idxs])
            for i in idxs:
                plan = (prelim[i] if len(idxs) == 1
                        else build_plan(parsed[i], pad_scans=pad))
                g = groups.get(plan.signature)
                if g is None:
                    g = groups[plan.signature] = _Group(plan, [], [])
                g.indices.append(i)
                g.inputs.append(build_inputs(datas[i], plan))
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
                                              device)
                planes = decode_merged(sig, scans, qtables, self.with_idct)
            out += [_to_numpy(p) for p in planes]
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
        self.routes = []
        results: List[Optional[List[np.ndarray]]] = [None] * len(datas)
        for g in self._groups(datas, prelim):
            sig = g.plan.signature
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


def decode_batch(datas: Sequence[bytes], mesh: Optional[Mesh] = None,
                 with_idct: bool = True, *,
                 device=None) -> List[List[np.ndarray]]:
    """Decode a batch of JPEGs (:class:`BatchDecoder`); ``device=None`` and
    no mesh is the card."""
    return BatchDecoder(mesh=mesh, with_idct=with_idct,
                        device=device).decode(datas)
