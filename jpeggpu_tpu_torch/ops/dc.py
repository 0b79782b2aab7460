"""DC un-delta: segmented inclusive prefix sum over the DC slots.

Per scan component, a cumulative sum in stream order that restarts at
every restart segment, over B images of one geometry at once (a merged
group's stream holds its images one after another); the sums wrap to int16
like the reference's int16 scan. ``torch.cumsum`` does the scan (the JAX
package computes it outside any kernel too). The number of tensor ops does
not depend on B.
"""

from __future__ import annotations

import torch

from .. import constants as C
from .huffman import ScanConfig


def _slot_runs(comp_slots):
    """The components' slots as runs ``(off, cnt, single)``: a component of
    several slots alone, neighbouring components of one slot each
    together (``single``)."""
    runs = []
    for off, cnt in comp_slots:
        if cnt == 1 and runs and runs[-1][2]:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1, True)
        else:
            runs.append((off, cnt, cnt == 1))
    return runs


def undelta_dc_values(cfg: ScanConfig, comp_slots,
                      coeffs: torch.Tensor = None,
                      dc: torch.Tensor = None,
                      batch: int = 1) -> torch.Tensor:
    """Un-deltaed DC values alone: int16[batch * total_du].

    The stream -> plane kernel takes slot 0 of every data unit from this
    side vector, so the DC stage never rewrites the coefficient stream.

    Args:
      cfg: scan geometry of one image.
      comp_slots: per scan component (off_in_mcu, du_per_mcu of the
        component), in slot order; together they make up the MCU.
      coeffs: int16[batch * total_positions] stream-order coefficients,
        image after image.
      dc: if given, the per-data-unit difference-coded DC vector
        (int16[>= batch * total_du], the records write path's side output);
        ``coeffs`` is then not read, which spares the strided pass over
        slot 0 of the whole stream.
      batch: images of this geometry, one after another in ``coeffs`` or
        ``dc``.
    """
    total_du = cfg.total_mcus * cfg.du_per_mcu
    if dc is not None:
        dc = dc[:batch * total_du].view(batch, total_du)
    else:
        dc = coeffs.view(batch, total_du, C.DATA_UNIT_SIZE)[:, :, 0]
    seg_du = cfg.mcus_per_seg * cfg.du_per_mcu
    nseg = -(-total_du // seg_du)
    pad = nseg * seg_du - total_du
    if pad:
        dc = torch.nn.functional.pad(dc, (0, pad))
    # one row per restart segment of one image (an image's short last
    # segment padded whole): the sums restart at every segment and image
    rows = dc.reshape(batch * nseg, cfg.mcus_per_seg, cfg.du_per_mcu)
    parts = []
    for off, cnt, single in _slot_runs(comp_slots):
        x = rows[:, :, off:off + cnt]
        # the int16 sums wrap as the reference's int16 scan does; each sum
        # runs along the innermost axis, which the card scans in parallel
        if single:  # one sum down the MCUs for each of these slots
            parts.append(torch.cumsum(x.transpose(1, 2), 2,
                                      dtype=torch.int16).transpose(1, 2))
        else:  # the component's slots in stream order, MCU after MCU
            parts.append(torch.cumsum(
                x.reshape(batch * nseg, -1), 1,
                dtype=torch.int16).view(batch * nseg, -1, cnt))
    out = torch.cat(parts, 2) if len(parts) > 1 else parts[0]
    if pad:
        return out.view(batch, nseg * seg_du)[:, :total_du].reshape(-1)
    return out.reshape(-1)


def undelta_dc(cfg: ScanConfig, comp_slots, coeffs: torch.Tensor,
               batch: int = 1) -> torch.Tensor:
    """Undo DC difference coding in stream order; returns a new coefficient
    stream (``batch`` images of one geometry, one after another) with slot
    0 of every data unit replaced."""
    total_du = cfg.total_mcus * cfg.du_per_mcu
    out = coeffs.clone().view(batch * total_du, C.DATA_UNIT_SIZE)
    out[:, 0] = undelta_dc_values(cfg, comp_slots, coeffs, batch=batch)
    return out.view(-1)
