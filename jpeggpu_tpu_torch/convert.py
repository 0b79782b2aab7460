"""Staged decode state -> the port's device inputs.

The decoder has no weights; what crosses from the host (or from the JAX
package, in the tests) is the staged state of one image: the scan geometry
as plain ints and tuples, the per-scan numpy arrays that
``pipeline.build_inputs`` makes (``words``, ``seg_of_subseq``,
``seg_first_lane``, ``seg_num_subseq``, ``maxcode``, ``vsm``, ``huffval``)
and the quantisation tables. The symbol table of K1, K2 and K4 is built here,
from the packed tables under the plan's ``fast_tables``, whenever a scan or
a shard is staged (:func:`symbol_table`). The JAX package's ``build_plan`` /
``build_inputs`` produce the same fields under the same names, so a test
can pull them out of a JAX plan and hand them over; with that both packages
decode the same staged state. The intermediate arrays of the records write
path cross the same way, as numpy, in both directions (:func:`to_torch`,
:func:`to_numpy`): ``(rec, m)``, ``(val_rows, pk_rows, mmax_st)``,
``(stiles, base, q)`` and the per-lane shape's ``(val, wpos, m, du0,
include)`` and ``(tiles, du0, q)`` have the same shapes, types and meaning
in both packages. The sharded decode's stacked shard inputs cross the
same way (:func:`shard_arrays`). Nothing of the JAX package is imported
here. A scan staged for the device destuff carries ``raw`` and
``seg_sub_offset`` in place of ``words``. Every staging goes through one
helper, :func:`device_arrays`: a scan's or a shard's arrays and its symbol
table in one region of host memory (:mod:`.staging`), copied to the device
at once, the tensors views of that copy.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import constants as C
from . import staging
from .config import Tuning
from .debug import scope
from .ops.huffman import (SYMTAB_BITS, ScanArrays, ScanConfig,
                          build_symbol_table)

GEOMETRY_FIELDS = ("lanes", "num_segments", "du_per_mcu", "mcus_per_seg",
                   "total_mcus", "comp_groups", "fast_tables", "tile_d",
                   "super_g", "super_w", "super_d", "group_du", "tile_auto")
_TUNING_FIELDS = tuple(f.name for f in dataclasses.fields(Tuning))


def tuning(source=None) -> Tuning:
    """A :class:`Tuning` from any object that carries fields of the same
    names (a ``Tuning`` of the JAX package, say); fields it lacks keep the
    defaults. A ``write_mode`` this package does not have ("scatter",
    "matmul") raises, as ``Tuning`` does."""
    return Tuning(**{name: getattr(source, name) for name in _TUNING_FIELDS
                     if hasattr(source, name)})


def scan_config(geometry: Mapping) -> ScanConfig:
    """Geometry (a mapping with :data:`GEOMETRY_FIELDS` and, optionally,
    ``tuning``; other keys are ignored) -> :class:`ScanConfig`."""
    tun = geometry.get("tuning")
    return ScanConfig(
        lanes=int(geometry["lanes"]),
        num_segments=int(geometry["num_segments"]),
        du_per_mcu=int(geometry["du_per_mcu"]),
        mcus_per_seg=int(geometry["mcus_per_seg"]),
        total_mcus=int(geometry["total_mcus"]),
        comp_groups=tuple(tuple(int(v) for v in g)
                          for g in geometry["comp_groups"]),
        fast_tables=bool(geometry["fast_tables"]),
        tile_d=int(geometry["tile_d"]),
        super_g=int(geometry["super_g"]),
        super_w=int(geometry["super_w"]),
        super_d=int(geometry["super_d"]),
        group_du=int(geometry["group_du"]),
        tile_auto=str(geometry["tile_auto"]),
        tuning=tun if isinstance(tun, Tuning) else tuning(tun),
    )


def symbol_table(maxcode, vsm, huffval, fast_tables: bool) -> np.ndarray:
    """The symbol table of K1, K2 and K4 (``ops.huffman.build_symbol_table``)
    of the packed tables under the plan's ``fast_tables``: the cache's own
    array, read-only. Built once per distinct set of tables: most streams
    carry the same few (those of T.81 Annex K), and a build costs
    milliseconds of eager tensor code on the host. A build runs in a
    ``jpeggpu.symtab`` range; ``_symbol_table.cache_info()`` counts the hits
    and misses."""
    key = tuple(np.ascontiguousarray(a, np.int32).tobytes()
                for a in (maxcode, vsm, huffval))
    return _symbol_table(*key, bool(fast_tables))


@functools.lru_cache(maxsize=64)
def _symbol_table(maxcode: bytes, vsm: bytes, huffval: bytes,
                  fast_tables: bool) -> np.ndarray:
    def i32(b):
        return np.frombuffer(b, np.int32).copy()

    with scope("jpeggpu.symtab"):
        table = build_symbol_table(i32(maxcode), i32(vsm), i32(huffval),
                                   fast_tables)
    table.flags.writeable = False
    return table


# the packed Huffman tables and the symbol table of a scan, as staged
# (``staging.Field``s; ``pipeline.scan_fields`` lays them after the rest)
TABLE_FIELDS = (("maxcode", np.int32, (C.MAX_HUFF_PER_SCAN, 16)),
                ("vsm", np.int32, (C.MAX_HUFF_PER_SCAN, 16)),
                ("huffval", np.int32, (C.MAX_HUFF_PER_SCAN * 256,)),
                ("symtab", np.int16, (C.MAX_HUFF_PER_SCAN << SYMTAB_BITS,)))
_TABLE_SHAPES = {name: shape for name, _, shape in TABLE_FIELDS}


def device_arrays(arrays: Mapping[str, np.ndarray],
                  device: torch.device | str, fast_tables: bool,
                  region: Optional[staging.Region] = None
                  ) -> Dict[str, torch.Tensor]:
    """A scan's or a shard's arrays (by their :class:`ScanArrays` names,
    and ``pos_base`` / ``pos_bound`` of a merged scan) with their symbol
    table (``symtab``), under the plan's ``fast_tables``, on ``device`` in
    one copy; each tensor is a view of it. ``region``: the staging region
    that ``arrays`` are the views of, symbol table included
    (``pipeline.scan_region``, ``parallel.batch.merge_region``), which goes
    as it lies; without one the arrays are packed into a region of their
    own first: the uint32 word stream as its int32 bit patterns, the raw
    bytes as uint8, everything else as int32."""
    if region is None:
        packed = {}
        for name, a in arrays.items():
            a = np.ascontiguousarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            a = a.astype(np.uint8 if name == "raw" else np.int32, copy=False)
            packed[name] = a.reshape(_TABLE_SHAPES.get(name, -1))
        packed["symtab"] = symbol_table(
            arrays["maxcode"], arrays["vsm"], arrays["huffval"], fast_tables)
        region = staging.pack(packed)
    return region.to(torch.device(device))


def scan_arrays_of(t: Mapping[str, torch.Tensor], lead: int = 0) -> ScanArrays:
    """The :class:`ScanArrays` of :func:`device_arrays`' tensors."""
    return ScanArrays(
        words=t["words"][lead:] if "words" in t else None,
        raw=t.get("raw"), seg_sub_offset=t.get("seg_sub_offset"),
        seg_of_subseq=t["seg_of_subseq"],
        seg_first_lane=t["seg_first_lane"],
        seg_num_subseq=t["seg_num_subseq"],
        maxcode=t["maxcode"], vsm=t["vsm"], huffval=t["huffval"],
        symtab=t["symtab"], lead_words=lead)


def scan_arrays(scan_inputs: Mapping[str, np.ndarray],
                device: torch.device | str, fast_tables: bool,
                region: Optional[staging.Region] = None) -> ScanArrays:
    """Per-scan numpy arrays -> :class:`ScanArrays` on ``device``, with the
    symbol table under the plan's ``fast_tables``, in one copy
    (:func:`device_arrays`). The uint32 word stream is carried as its int32
    bit patterns. A scan staged for the device destuff (``raw`` and
    ``seg_sub_offset`` in place of ``words``) keeps them as uint8 and int32
    tensors, and ``words`` is None until the destuff fills it
    (``pipeline.destuffed``). ``region``: as :func:`device_arrays` takes
    it."""
    return scan_arrays_of(device_arrays(scan_inputs, device, fast_tables,
                                        region))


def shard_arrays(inputs: Mapping[str, np.ndarray], d: int,
                 device: torch.device | str, fast_tables: bool) -> ScanArrays:
    """Shard ``d`` of stacked shard inputs -> :class:`ScanArrays` on
    ``device``, in one copy (:func:`device_arrays`). ``inputs`` is what
    ``build_shard_inputs`` or ``build_subseq_shard_inputs`` of either
    package returns: numpy arrays with a leading shard axis (``words``,
    ``seg_of``, ``seg_first``, ``seg_nsub``) and the Huffman tables, which
    all shards share. Where ``inputs`` has ``prev_word`` (subsequence
    shards), the words are staged behind the word before the shard,
    ``ScanArrays.words`` is the view that starts after it and
    ``lead_words`` is 1 (see ``ops.huffman.ScanArrays``). The symbol table
    is built under the plan's ``fast_tables``.
    """
    words = np.asarray(inputs["words"][d])
    lead = 1 if "prev_word" in inputs else 0
    if lead:
        words = np.concatenate([np.asarray(inputs["prev_word"][d]).reshape(-1)
                                .astype(words.dtype), words.reshape(-1)])
    t = device_arrays(dict(
        words=words, seg_of_subseq=inputs["seg_of"][d],
        seg_first_lane=inputs["seg_first"][d],
        seg_num_subseq=inputs["seg_nsub"][d], maxcode=inputs["maxcode"],
        vsm=inputs["vsm"], huffval=inputs["huffval"]), device, fast_tables)
    return scan_arrays_of(t, lead)


def from_reference_inputs(geometry: Mapping,
                          scan_inputs: Mapping[str, np.ndarray],
                          qtables: np.ndarray, device: torch.device | str
                          ) -> Tuple[ScanConfig, ScanArrays, torch.Tensor]:
    """One scan's staged state -> ``(ScanConfig, ScanArrays, qtables)`` on
    ``device``; ``qtables`` is int32[4, 64], raw DQT bytes in natural order.
    """
    cfg = scan_config(geometry)
    arrs = scan_arrays(scan_inputs, device, cfg.fast_tables)
    if arrs.words.numel() != cfg.lanes * 32:
        raise ValueError(
            f"words holds {arrs.words.numel()} words, geometry says "
            f"{cfg.lanes} lanes of 32")
    q = torch.from_numpy(
        np.ascontiguousarray(qtables).astype(np.int32)).to(device)
    return cfg, arrs, q


def to_torch(arrays, device: torch.device | str = "cpu"):
    """A tuple of arrays (numpy, or anything ``np.asarray`` takes, such as
    the JAX package's outputs) -> torch tensors of the same types on
    ``device``: one stage's output in the other package, ready for this
    package's next stage."""
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)


def to_numpy(tensors):
    """A tuple of tensors -> numpy arrays, for the other package's next
    stage."""
    return tuple(t.detach().cpu().numpy() for t in tensors)
