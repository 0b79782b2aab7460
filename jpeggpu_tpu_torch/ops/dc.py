"""DC un-delta: segmented inclusive prefix sum over the DC slots.

Per scan component, a masked cumulative sum in stream order that restarts
at every restart segment; the result wraps to int16 like the reference's
int16 scan. ``torch.cumsum`` does the scan (the JAX package computes it
outside any kernel too).
"""

from __future__ import annotations

import torch

from .. import constants as C
from .huffman import ScanConfig


def undelta_dc_values(cfg: ScanConfig, comp_slots,
                      coeffs: torch.Tensor = None,
                      dc: torch.Tensor = None) -> torch.Tensor:
    """Un-deltaed DC values alone: int16[total_du].

    The stream -> plane kernel takes slot 0 of every data unit from this
    side vector, so the DC stage never rewrites the coefficient stream.

    Args:
      cfg: scan geometry.
      comp_slots: per scan component (off_in_mcu, du_per_mcu of the component).
      coeffs: int16[total_positions] stream-order coefficients.
      dc: if given, the per-data-unit difference-coded DC vector
        (int16[>= total_du], the records write path's side output);
        ``coeffs`` is then not read, which spares the strided pass over
        slot 0 of the whole stream.
    """
    total_du = cfg.total_mcus * cfg.du_per_mcu
    if dc is not None:
        dc = dc[:total_du].to(torch.int64)
    else:
        dc = coeffs.view(total_du, C.DATA_UNIT_SIZE)[:, 0].to(torch.int64)
    slot = torch.arange(total_du, device=dc.device) % cfg.du_per_mcu
    seg_du = cfg.mcus_per_seg * cfg.du_per_mcu
    nseg = -(-total_du // seg_du)
    pad = nseg * seg_du - total_du

    new_dc = dc
    for off, cnt in comp_slots:
        sel = (slot >= off) & (slot < off + cnt)
        x = torch.where(sel, dc, 0)
        # segment reset by construction: one row per restart segment
        xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
        cum = torch.cumsum(xp.view(nseg, seg_du), dim=1).reshape(-1)[:total_du]
        new_dc = torch.where(sel, cum, new_dc)
    wrapped = ((new_dc + 0x8000) & 0xFFFF) - 0x8000
    return wrapped.to(torch.int16)


def undelta_dc(cfg: ScanConfig, comp_slots,
               coeffs: torch.Tensor) -> torch.Tensor:
    """Undo DC difference coding in stream order; returns a new coefficient
    stream with slot 0 of every data unit replaced."""
    total_du = cfg.total_mcus * cfg.du_per_mcu
    out = coeffs.clone().view(total_du, C.DATA_UNIT_SIZE)
    out[:, 0] = undelta_dc_values(cfg, comp_slots, coeffs)
    return out.view(-1)
