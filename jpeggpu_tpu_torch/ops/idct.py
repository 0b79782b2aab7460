"""Device dequantize + integer IDCT, and the fused stream -> planes tail.

:func:`dequant_idct_planes` IDCTs coefficient planes (the arithmetic of
:mod:`jpeggpu_tpu_torch.idct_int` on torch tensors, bit-identical to the
golden CPU path by construction): on the card one CUDA kernel (K9) launch
for up to four planes. :func:`idct_stream_to_planes` is the tail the
pipeline runs: on the card one CUDA kernel (K3) launch per scan for all its
components, on CPU tensors its plain version, DC splice + ``deinterleave``
+ the plain plane IDCT. :func:`dequant_idct_plane` and
:func:`idct_stream_to_plane` are their one-plane calls.
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, Sequence, Tuple

import torch

from .. import constants as C
from .. import kernels
from ..idct_int import dequant_idct_blocks
from .transpose import deinterleave

# components (K3) or planes (K9) one launch covers at most
MAX_PLANES = 4
# data units of one K3 run at most: the threads of one of its blocks
RUN_UNITS = 128
# images of one K3 launch at most: its grid's second dimension
MAX_BATCH = 65535

# (num_mcus_x, num_mcus_y, per component (off, ssx, ssy, qtable index))
StreamGeometry = Tuple[int, int, Sequence[Tuple[int, int, int, int]]]


# --- K9: coefficient planes -> pixel planes --------------------------------

def dequant_idct_plane_plain(plane: torch.Tensor,
                             qtable: torch.Tensor) -> torch.Tensor:
    """Plain version of one plane of :func:`dequant_idct_planes`, on
    whatever device holds the tensors."""
    h, w = plane.shape
    blocks = plane.to(torch.int32).reshape(h // 8, 8, w // 8, 8)
    blocks = blocks.permute(0, 2, 1, 3)
    pix = dequant_idct_blocks(torch, blocks, qtable.to(torch.int32))
    return pix.permute(0, 2, 1, 3).reshape(h, w).to(torch.uint8)


def dequant_idct_planes_plain(planes: Sequence[torch.Tensor],
                              qtables: Sequence[torch.Tensor]
                              ) -> List[torch.Tensor]:
    """Plain version of :func:`dequant_idct_planes`."""
    return [dequant_idct_plane_plain(p, q) for p, q in zip(planes, qtables)]


def plane_blocks(shapes: Sequence[Tuple[int, int]]) -> Tuple[List[int], int]:
    """K9's division of work: one flat list of the planes' 8x8 blocks, plane
    after plane, each in 8-row strips top to bottom. Returns each plane's
    first index in the list and the total. Index ``i`` is, as the kernel
    computes it, block ``divmod(i - first[p], w // 8)`` (block row, block
    column) of the last plane ``p`` whose first index is at most ``i``."""
    first, total = [], 0
    for h, w in shapes:
        first.append(total)
        total += (h // 8) * (w // 8)
    return first, total


def dequant_idct_planes(planes: Sequence[torch.Tensor],
                        qtables: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """IDCT coefficient planes, each by its own table, into uint8 pixels.

    CUDA tensors: one launch of kernel K9 (``kernels/csrc/idct_blocks.cu``;
    replaces the Pallas kernel behind ``jpeggpu_tpu/ops/idct_pallas.py:
    dequant_idct_blocks_pallas``, with the block transposes around it) for
    all planes. Bound by bytes: every coefficient is read once and every
    pixel written once; see the note in the source. CPU tensors: the plain
    version.

    Args:
      planes: 1 to 4 int16[(H, W)] coefficient rasters, H and W multiples
        of 8, shapes free.
      qtables: per plane its raw DQT bytes, natural order, shape (64,), any
        int dtype.

    Returns uint8[(H, W)] per plane.
    """
    if not 1 <= len(planes) == len(qtables) <= MAX_PLANES:
        raise ValueError(f"dequant_idct_planes: 1 to {MAX_PLANES} planes, "
                         f"one table each, got {len(planes)} planes and "
                         f"{len(qtables)} tables")
    dev = planes[0].device
    if dev.type == "cpu":
        return dequant_idct_planes_plain(planes, qtables)
    if dev.type != "cuda":
        raise ValueError(f"dequant_idct_planes: unsupported device {dev}")
    tables = []
    for plane, qtable in zip(planes, qtables):
        if (plane.device != dev or plane.dtype != torch.int16
                or plane.dim() != 2 or not plane.is_contiguous()
                or plane.shape[0] % 8 or plane.shape[1] % 8):
            raise ValueError(
                "dequant_idct_planes: each plane must be a contiguous int16 "
                f"(H, W) tensor on {dev} with H and W multiples of 8, got "
                f"{plane.dtype} {tuple(plane.shape)} on {plane.device}")
        if plane.data_ptr() % 16:
            raise ValueError("dequant_idct_planes: planes must be 16-byte "
                             "aligned (the kernel reads 16 bytes at a time)")
        if qtable.device != dev or qtable.numel() != 64:
            raise ValueError(
                f"dequant_idct_planes: each qtable must hold 64 values on "
                f"{dev}, got {tuple(qtable.shape)} on {qtable.device}")
        tables.append(qtable.to(torch.int32).contiguous())
    first, total = plane_blocks([tuple(p.shape) for p in planes])
    outs = [torch.empty(tuple(p.shape), dtype=torch.uint8, device=dev)
            for p in planes]
    values = [total]
    for plane, out, q, f in zip(planes, outs, tables, first):
        values += [plane.data_ptr(), out.data_ptr(), q.data_ptr(),
                   plane.shape[1], f]
    desc = kernels.host_int64(values)
    fn = kernels.get("jpeggpu_dequant_idct_planes")
    err = fn(ctypes.addressof(desc), len(planes),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "dequant_idct_planes")
    dequant_idct_planes.launches += 1
    return outs


dequant_idct_planes.launches = 0


def dequant_idct_plane(plane: torch.Tensor,
                       qtable: torch.Tensor) -> torch.Tensor:
    """One plane of :func:`dequant_idct_planes` (on the card, a launch of
    K9 for it alone). Returns uint8[(H, W)]."""
    return dequant_idct_planes([plane], [qtable])[0]


# --- K3: stream-order coefficients -> the planes of a scan -----------------

def stream_runs(num_mcus_x: int, num_mcus_y: int,
                du_per_mcu: int) -> Tuple[int, int, int]:
    """K3's division of a scan into runs: ``(run_mcus, runs_per_row,
    n_runs)``. A run is ``run_mcus`` consecutive MCUs of one MCU row, the
    largest power of two whose data units fit one block of RUN_UNITS
    threads; the last run of a row takes the rest. Run ``r`` is MCU row
    ``r // runs_per_row`` from MCU column ``(r % runs_per_row) *
    run_mcus``."""
    run_mcus = 1
    while 2 * run_mcus * du_per_mcu <= RUN_UNITS:
        run_mcus *= 2
    per_row = -(-num_mcus_x // run_mcus)
    return run_mcus, per_row, per_row * num_mcus_y


def comp_firsts(comps) -> Tuple[List[int], int]:
    """K3's thread slots per MCU of a run: per component the data units per
    MCU of the components listed before it, and those of all of them."""
    first, units = [], 0
    for _, ssx, ssy, _ in comps:
        first.append(units)
        units += ssx * ssy
    return first, units


def idct_stream_to_planes_plain(coeffs: torch.Tensor, qtables: torch.Tensor,
                                geometry: StreamGeometry, du_per_mcu: int,
                                dcv: torch.Tensor) -> List[torch.Tensor]:
    """Plain version of :func:`idct_stream_to_planes`: DC splice,
    ``deinterleave`` and the plain plane IDCT per component (image by image
    for a batch), on whatever device holds the tensors."""
    if qtables.dim() == 3:
        batch = qtables.shape[0]
        n, m = coeffs.numel() // batch, dcv.numel() // batch
        images = [idct_stream_to_planes_plain(
            coeffs[b * n:(b + 1) * n], qtables[b], geometry, du_per_mcu,
            dcv[b * m:(b + 1) * m]) for b in range(batch)]
        return [torch.stack(planes) for planes in zip(*images)]
    num_mcus_x, num_mcus_y, comps = geometry
    spliced = coeffs.clone().view(-1, C.DATA_UNIT_SIZE)
    spliced[:, 0] = dcv
    planes = deinterleave(spliced.view(-1), du_per_mcu, num_mcus_x,
                          num_mcus_y, [c[:3] for c in comps])
    return [dequant_idct_plane_plain(plane, qtables[c[3]])
            for plane, c in zip(planes, comps)]


def idct_stream_to_planes(coeffs: torch.Tensor, qtables: torch.Tensor,
                          geometry: StreamGeometry, du_per_mcu: int,
                          dcv: torch.Tensor) -> List[torch.Tensor]:
    """Fused de-interleave + DC splice + dequant + IDCT: stream-order
    coefficients of one scan straight to its components' uint8 planes, for
    one image or for B images of one geometry (a merged group), each with
    its own quantisation tables.

    CUDA tensors: one launch of kernel K3 (``kernels/csrc/idct_stream.cu``;
    replaces the Pallas kernel behind ``jpeggpu_tpu/ops/idct_pallas.py:
    idct_stream_to_plane``, which the reference launches per component)
    for all the listed components of all the images. Bound by bytes: every
    coefficient is read once and every pixel written once; see the note in
    the source. CPU tensors: the plain version.

    Args:
      coeffs: int16[B * num_mcus * du_per_mcu * 64] natural-order streams,
        image after image, DC still difference-coded (slot 0 is not read).
      qtables: int32[(n, 64)] for one image, int32[(B, n, 64)] for B
        images: raw DQT bytes in natural order.
      geometry: ``(num_mcus_x, num_mcus_y, comps)``, per component (1 to
        4) its first data-unit slot in the MCU, its sampling factors in
        this scan and its row of ``qtables``: ``(off, ssx, ssy, qidx)``.
      dcv: int16[B * num_mcus * du_per_mcu] un-deltaed DC values
        (``ops.dc.undelta_dc_values``), spliced into slot 0.
    Returns per component uint8[(num_mcus_y*ssy*8, num_mcus_x*ssx*8)], or
    for B images uint8[(B, num_mcus_y*ssy*8, num_mcus_x*ssx*8)].
    """
    num_mcus_x, num_mcus_y, comps = geometry
    batch = qtables.shape[0] if qtables.dim() == 3 else 1
    dev = coeffs.device
    if dev.type == "cpu":
        idct_stream_to_planes.images += batch
        return idct_stream_to_planes_plain(coeffs, qtables, geometry,
                                           du_per_mcu, dcv)
    if dev.type != "cuda":
        raise ValueError(f"idct_stream_to_planes: unsupported device {dev}")
    total_du = batch * num_mcus_x * num_mcus_y * du_per_mcu
    for name, t, dtype, numel in (
            ("coeffs", coeffs, torch.int16, total_du * C.DATA_UNIT_SIZE),
            ("dcv", dcv, torch.int16, total_du),
            ("qtables", qtables, torch.int32, qtables.numel())):
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or t.numel() != numel):
            raise ValueError(
                f"idct_stream_to_planes: {name} must be a contiguous {dtype} "
                f"tensor of {numel} elements on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if coeffs.data_ptr() % 16:
        raise ValueError("idct_stream_to_planes: coeffs must be 16-byte "
                         "aligned (the bulk copy moves 16 bytes at a time)")
    if qtables.dim() not in (2, 3) or qtables.shape[-1] != 64:
        raise ValueError(f"idct_stream_to_planes: qtables must be (n, 64) "
                         f"or (B, n, 64), got {tuple(qtables.shape)}")
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"idct_stream_to_planes: 1 to {MAX_BATCH} images, "
                         f"got {batch}")
    if not 1 <= len(comps) <= MAX_PLANES:
        raise ValueError(f"idct_stream_to_planes: 1 to {MAX_PLANES} "
                         f"components, got {len(comps)}")
    for off, ssx, ssy, qidx in comps:
        if not 0 <= off <= off + ssx * ssy <= du_per_mcu or ssx < 1 or ssy < 1:
            raise ValueError("idct_stream_to_planes: component slots outside "
                             "the MCU")
        if not 0 <= qidx < qtables.shape[-2]:
            raise ValueError(f"idct_stream_to_planes: no table {qidx}")
    if du_per_mcu > RUN_UNITS:
        raise ValueError(f"idct_stream_to_planes: {du_per_mcu} data units "
                         f"per MCU, at most {RUN_UNITS}")
    planes = [torch.empty((batch, num_mcus_y * ssy * 8, num_mcus_x * ssx * 8),
                          dtype=torch.uint8, device=dev)
              for _, ssx, ssy, _ in comps]
    run_mcus, per_row, n_runs = stream_runs(num_mcus_x, num_mcus_y,
                                            du_per_mcu)
    first, units = comp_firsts(comps)
    threads = -(-run_mcus * units // 32) * 32
    values = [num_mcus_x, du_per_mcu, units, run_mcus, per_row, n_runs,
              threads, batch, num_mcus_y, qtables.shape[-2] * 64]
    for plane, (off, ssx, ssy, qidx), f in zip(planes, comps, first):
        values += [plane.data_ptr(), off, ssx, ssy, qidx, f]
    desc = kernels.host_int64(values)
    fn = kernels.get("jpeggpu_idct_stream_to_planes")
    err = fn(coeffs.data_ptr(), dcv.data_ptr(), qtables.data_ptr(),
             ctypes.addressof(desc), len(comps),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "idct_stream_to_planes")
    idct_stream_to_planes.launches += 1
    idct_stream_to_planes.images += batch
    for off, *_ in comps:
        idct_stream_to_planes.launches_by_slot[off] += 1
    return planes if qtables.dim() == 3 else [p[0] for p in planes]


idct_stream_to_planes.launches = 0
# the images the calls covered, the plain version's (CPU tensors) too: on
# the card, over `launches`, the images per launch
idct_stream_to_planes.images = 0
# the components the launches covered, by `off` (a component's first slot)
idct_stream_to_planes.launches_by_slot = collections.Counter()


def idct_stream_to_plane_plain(coeffs, qtable, num_mcus_x, num_mcus_y,
                               du_per_mcu, off, ssx, ssy, dc):
    """Plain version of :func:`idct_stream_to_plane`."""
    return idct_stream_to_planes_plain(
        coeffs, qtable.reshape(1, 64), (num_mcus_x, num_mcus_y,
                                        ((off, ssx, ssy, 0),)),
        du_per_mcu, dc)[0]


def idct_stream_to_plane(coeffs: torch.Tensor, qtable: torch.Tensor,
                         num_mcus_x: int, num_mcus_y: int, du_per_mcu: int,
                         off: int, ssx: int, ssy: int,
                         dc: torch.Tensor) -> torch.Tensor:
    """One component of :func:`idct_stream_to_planes` (on the card, a launch
    of K3 for it alone): ``qtable`` is its int32[64] table, ``off``,
    ``ssx``, ``ssy`` its first data-unit slot in the MCU and its sampling
    factors in this scan. Returns
    uint8[(num_mcus_y*ssy*8, num_mcus_x*ssx*8)]."""
    return idct_stream_to_planes(
        coeffs, qtable.reshape(1, 64),
        (num_mcus_x, num_mcus_y, ((off, ssx, ssy, 0),)), du_per_mcu, dc)[0]
