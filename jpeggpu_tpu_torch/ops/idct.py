"""Device dequantize + integer IDCT, and the fused stream -> plane tail.

:func:`dequant_idct_plane` is the plain planar form (the arithmetic of
:mod:`jpeggpu_tpu_torch.idct_int` on torch tensors, bit-identical to the
golden CPU path by construction). :func:`idct_stream_to_plane` is the tail
the pipeline runs: on the card one CUDA kernel (K3) per component, on CPU
tensors its plain version, ``deinterleave`` + DC splice +
``dequant_idct_plane``.
"""

from __future__ import annotations

import collections

import torch

from .. import constants as C
from .. import kernels
from ..idct_int import dequant_idct_blocks
from .transpose import deinterleave


def dequant_idct_plane_plain(plane: torch.Tensor,
                             qtable: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dequant_idct_plane`, on whatever device holds
    the tensors."""
    h, w = plane.shape
    blocks = plane.to(torch.int32).reshape(h // 8, 8, w // 8, 8)
    blocks = blocks.permute(0, 2, 1, 3)
    pix = dequant_idct_blocks(torch, blocks, qtable.to(torch.int32))
    return pix.permute(0, 2, 1, 3).reshape(h, w).to(torch.uint8)


def dequant_idct_plane(plane: torch.Tensor,
                       qtable: torch.Tensor) -> torch.Tensor:
    """IDCT a coefficient plane into uint8 pixels.

    CUDA tensors: kernel K9 (``kernels/csrc/idct_blocks.cu``; replaces the
    Pallas kernel behind ``jpeggpu_tpu/ops/idct_pallas.py:
    dequant_idct_blocks_pallas``, with the block transposes around it).
    Bound by bytes: every coefficient is read once and every pixel written
    once; see the note in the source. CPU tensors: the plain version.

    Args:
      plane: int16[(H, W)] coefficient raster, H and W multiples of 8.
      qtable: raw DQT bytes, natural order, shape (64,), any int dtype.

    Returns uint8[(H, W)].
    """
    dev = plane.device
    if dev.type == "cpu":
        return dequant_idct_plane_plain(plane, qtable)
    if dev.type != "cuda":
        raise ValueError(f"dequant_idct_plane: unsupported device {dev}")
    if (plane.dtype != torch.int16 or plane.dim() != 2
            or not plane.is_contiguous() or plane.shape[0] % 8
            or plane.shape[1] % 8):
        raise ValueError(
            "dequant_idct_plane: plane must be a contiguous int16 (H, W) "
            f"tensor with H and W multiples of 8, got {plane.dtype} "
            f"{tuple(plane.shape)}")
    if plane.data_ptr() % 16:
        raise ValueError("dequant_idct_plane: plane must be 16-byte aligned "
                         "(the kernel reads 16 bytes at a time)")
    if qtable.device != dev or qtable.numel() != 64:
        raise ValueError(f"dequant_idct_plane: qtable must hold 64 values on "
                         f"{dev}, got {tuple(qtable.shape)} on {qtable.device}")
    q = qtable.to(torch.int32).contiguous()
    h, w = plane.shape
    out = torch.empty((h, w), dtype=torch.uint8, device=dev)
    fn = kernels.get("jpeggpu_dequant_idct_plane")
    err = fn(plane.data_ptr(), q.data_ptr(), out.data_ptr(), h, w,
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "dequant_idct_plane")
    dequant_idct_plane.launches += 1
    return out


dequant_idct_plane.launches = 0


def idct_stream_to_plane_plain(coeffs, qtable, num_mcus_x, num_mcus_y,
                               du_per_mcu, off, ssx, ssy, dc):
    """Plain version of :func:`idct_stream_to_plane`: DC splice,
    ``deinterleave`` and ``dequant_idct_plane_plain`` (never K9), on
    whatever device holds the tensors."""
    total_mcus = num_mcus_x * num_mcus_y
    spliced = coeffs.clone().view(total_mcus * du_per_mcu, C.DATA_UNIT_SIZE)
    spliced[:, 0] = dc
    plane, = deinterleave(spliced.view(-1), du_per_mcu, num_mcus_x,
                          num_mcus_y, [(off, ssx, ssy)])
    return dequant_idct_plane_plain(plane, qtable)


def idct_stream_to_plane(coeffs: torch.Tensor, qtable: torch.Tensor,
                         num_mcus_x: int, num_mcus_y: int, du_per_mcu: int,
                         off: int, ssx: int, ssy: int,
                         dc: torch.Tensor) -> torch.Tensor:
    """Fused de-interleave + DC splice + dequant + IDCT: stream-order
    coefficients straight to one component's uint8 pixel plane.

    CUDA tensors: kernel K3 (``kernels/csrc/idct_stream.cu``; replaces the
    Pallas kernel behind ``jpeggpu_tpu/ops/idct_pallas.py:
    idct_stream_to_plane``). Bound by bytes: every coefficient is read once
    and every pixel written once; see the note in the source. CPU tensors:
    the plain version.

    Args:
      coeffs: int16[num_mcus * du_per_mcu * 64] natural-order stream, DC
        still difference-coded (slot 0 is not read).
      qtable: raw DQT bytes, natural order, int32[64].
      off, ssx, ssy: the component's first data-unit slot in the MCU and
        its sampling factors in this scan.
      dc: int16[num_mcus * du_per_mcu] un-deltaed DC values
        (``ops.dc.undelta_dc_values``), spliced into slot 0.
    Returns uint8[(num_mcus_y*ssy*8, num_mcus_x*ssx*8)].
    """
    dev = coeffs.device
    if dev.type == "cpu":
        return idct_stream_to_plane_plain(
            coeffs, qtable, num_mcus_x, num_mcus_y, du_per_mcu, off, ssx, ssy,
            dc)
    if dev.type != "cuda":
        raise ValueError(f"idct_stream_to_plane: unsupported device {dev}")
    total_du = num_mcus_x * num_mcus_y * du_per_mcu
    for name, t, dtype, numel in (
            ("coeffs", coeffs, torch.int16, total_du * C.DATA_UNIT_SIZE),
            ("dc", dc, torch.int16, total_du),
            ("qtable", qtable, torch.int32, 64)):
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or t.numel() != numel):
            raise ValueError(
                f"idct_stream_to_plane: {name} must be a contiguous {dtype} "
                f"tensor of {numel} elements on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if coeffs.data_ptr() % 16:
        raise ValueError("idct_stream_to_plane: coeffs must be 16-byte "
                         "aligned (the kernel reads 16 bytes at a time)")
    if not 0 <= off <= off + ssx * ssy <= du_per_mcu:
        raise ValueError("idct_stream_to_plane: component slots outside MCU")
    plane = torch.empty((num_mcus_y * ssy * 8, num_mcus_x * ssx * 8),
                        dtype=torch.uint8, device=dev)
    fn = kernels.get("jpeggpu_idct_stream_to_plane")
    err = fn(coeffs.data_ptr(), dc.data_ptr(), qtable.data_ptr(),
             plane.data_ptr(), num_mcus_x, num_mcus_y, du_per_mcu, off, ssx,
             ssy, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "idct_stream_to_plane")
    idct_stream_to_plane.launches += 1
    idct_stream_to_plane.launches_by_slot[off] += 1
    return plane


idct_stream_to_plane.launches = 0
# the same count split by component (keyed by `off`, its first slot)
idct_stream_to_plane.launches_by_slot = collections.Counter()
