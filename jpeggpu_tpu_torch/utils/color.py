"""Chroma upsampling + YCbCr->RGB conversion.

Deliberately OUTSIDE the device decode contract, exactly like the reference
(planar possibly-subsampled output is the library's product, jpeggpu.h:95-100;
color conversion is an example-level utility, util/util.h:33-107). Bundled
as a convenience with the same nearest-neighbor upsampling + float rounding
behavior, vectorized in numpy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def upsample_nearest(plane: np.ndarray, out_h: int, out_w: int,
                     fy: int, fx: int) -> np.ndarray:
    up = np.repeat(np.repeat(plane, fy, axis=0), fx, axis=1)
    return up[:out_h, :out_w]


def to_rgb(planes: Sequence[np.ndarray],
           sampling: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Planar (sub)sampled Y[/CbCr] -> interleaved RGB uint8.

    Supports grayscale and YCbCr with non-subsampled luma and equally
    subsampled chroma — the same envelope as the reference conv_to_rgbi
    (util/util.h:44-75); raises ValueError outside it.
    """
    n = len(planes)
    if n not in (1, 3):
        raise ValueError("only 1- or 3-component images")
    y = planes[0].astype(np.float32)
    h, w = y.shape
    if n == 1:
        g = np.clip(np.round(y), 0, 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)

    (sx0, sy0), (sx1, sy1), (sx2, sy2) = sampling
    if (sx0, sy0) != (max(sx0, sx1, sx2), max(sy0, sy1, sy2)):
        raise ValueError("subsampled luma not supported")
    if (sx1, sy1) != (sx2, sy2):
        raise ValueError("chroma planes subsampled differently")
    fy, fx = sy0 // sy1, sx0 // sx1
    cb = upsample_nearest(planes[1].astype(np.float32), h, w, fy, fx)
    cr = upsample_nearest(planes[2].astype(np.float32), h, w, fy, fx)

    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
