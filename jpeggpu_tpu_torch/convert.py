"""Staged decode state -> the port's device inputs.

The decoder has no weights; what crosses from the host (or from the JAX
package, in the tests) is the staged state of one image: the scan geometry
as plain ints and tuples, the per-scan numpy arrays that
``pipeline.build_scan_inputs`` makes (``words``, ``seg_of_subseq``,
``seg_first_lane``, ``seg_num_subseq``, ``maxcode``, ``vsm``, ``huffval``)
and the quantisation tables. The JAX package's ``build_plan`` /
``build_inputs`` produce the same fields under the same names, so a test
can pull them out of a JAX plan and hand them over; with that both packages
decode the same staged state. Nothing of the JAX package is imported here.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from .ops.huffman import ScanArrays, ScanConfig

GEOMETRY_FIELDS = ("lanes", "num_segments", "du_per_mcu", "mcus_per_seg",
                   "total_mcus", "comp_groups", "fast_tables")


def scan_config(geometry: Mapping) -> ScanConfig:
    """Geometry (a mapping with :data:`GEOMETRY_FIELDS`; extra keys are
    ignored) -> :class:`ScanConfig`."""
    return ScanConfig(
        lanes=int(geometry["lanes"]),
        num_segments=int(geometry["num_segments"]),
        du_per_mcu=int(geometry["du_per_mcu"]),
        mcus_per_seg=int(geometry["mcus_per_seg"]),
        total_mcus=int(geometry["total_mcus"]),
        comp_groups=tuple(tuple(int(v) for v in g)
                          for g in geometry["comp_groups"]),
        fast_tables=bool(geometry["fast_tables"]),
    )


def scan_arrays(scan_inputs: Mapping[str, np.ndarray],
                device: torch.device | str) -> ScanArrays:
    """Per-scan numpy arrays -> :class:`ScanArrays` on ``device``. The
    uint32 word stream is carried as its int32 bit patterns."""
    def i32(name, shape):
        a = np.ascontiguousarray(scan_inputs[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        a = a.astype(np.int32, copy=False).reshape(shape)
        return torch.from_numpy(a).to(device)

    return ScanArrays(
        words=i32("words", -1),
        seg_of_subseq=i32("seg_of_subseq", -1),
        seg_first_lane=i32("seg_first_lane", -1),
        seg_num_subseq=i32("seg_num_subseq", -1),
        maxcode=i32("maxcode", (8, 16)),
        vsm=i32("vsm", (8, 16)),
        huffval=i32("huffval", -1),
    )


def from_reference_inputs(geometry: Mapping,
                          scan_inputs: Mapping[str, np.ndarray],
                          qtables: np.ndarray, device: torch.device | str
                          ) -> Tuple[ScanConfig, ScanArrays, torch.Tensor]:
    """One scan's staged state -> ``(ScanConfig, ScanArrays, qtables)`` on
    ``device``; ``qtables`` is int32[4, 64], raw DQT bytes in natural order.
    """
    cfg = scan_config(geometry)
    arrs = scan_arrays(scan_inputs, device)
    if arrs.words.numel() != cfg.lanes * 32:
        raise ValueError(
            f"words holds {arrs.words.numel()} words, geometry says "
            f"{cfg.lanes} lanes of 32")
    q = torch.from_numpy(
        np.ascontiguousarray(qtables).astype(np.int32)).to(device)
    return cfg, arrs, q
