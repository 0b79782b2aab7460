"""De-interleave: stream-order coefficients -> per-component planar rasters.

A pure reshape/permute chain. On the card the main path never runs it (the
stream -> plane kernel does the de-interleave while it reads); it is the
first half of that kernel's plain version.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import constants as C


def deinterleave(coeffs: torch.Tensor, du_per_mcu: int, num_mcus_x: int,
                 num_mcus_y: int,
                 comps: Sequence[Tuple[int, int, int]]) -> List[torch.Tensor]:
    """Split stream-order coefficients into planar component rasters.

    Args:
      coeffs: int16[total_positions].
      comps: per scan component (off_in_mcu, ss_x, ss_y).

    Returns int16[(num_mcus_y*ss_y*8, num_mcus_x*ss_x*8)] per component.
    """
    arr = coeffs.view(num_mcus_y * num_mcus_x, du_per_mcu,
                      C.DATA_UNIT_SIZE)
    planes = []
    for off, ssx, ssy in comps:
        part = arr[:, off:off + ssx * ssy, :]
        part = part.reshape(num_mcus_y, num_mcus_x, ssy, ssx, 8, 8)
        planes.append(part.permute(0, 2, 4, 1, 3, 5).reshape(
            num_mcus_y * ssy * 8, num_mcus_x * ssx * 8))
    return planes
