"""Typed decode-tuning configuration.

Every knob of the device write stage that the package honours lives in one
frozen dataclass that rides inside the static
:class:`~jpeggpu_tpu_torch.ops.huffman.ScanConfig`; a plan built under a
tuning carries it to every stage (``pipeline.build_plan(stream,
tuning=...)``, or the process default through :func:`set_default_tuning`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Tuning:
    """Static tuning knobs of the device write stage.

    Attributes:
      write_mode: "fused" | "tiles", coefficient materialisation. "fused"
        (the default) is the single writing-decode kernel that stores
        coefficients straight into the stream (``ops.huffman.decode_write``).
        "tiles" is the records path (``ops.write.decode_write_tiles``): the
        writing decode emits packed records, records become tiles, tiles
        are expanded into the dense stream; lanes that do not fit their
        tile drain through a scatter.
      tile_mode: "auto" | "super" | "lane", shape of the records path's
        first assembly stage. "super" groups ``super_g`` consecutive lanes
        into one ``(super_d, 64)`` supertile and also yields the DC side
        vector. "lane" gives every lane a ``(tile_d, 64)`` tile of its own
        (``ScanConfig.tile_d``), for sparse scans where even two lanes
        overflow a supertile. "auto" takes the plan's choice, made scan by
        scan (``ScanConfig.tile_auto``): "lane" above 55 data units per
        subsequence, else "super".
      write_chunk: slots per emission chunk; the record buffer's slot count
        is rounded up to a multiple of it (``ops.huffman._emit_cap``).
      s_trim: record slots per lane that the supertile assembly reads;
        lanes with more records drain through the leftover scatter, so
        exactness never depends on it. A positive multiple of 128. The
        per-lane shape reads the full depth and ignores it.
      group_du: data units per output group of the expand stage (a
        multiple of 128; 0 = auto, resolved by ``build_plan``).
      super_g, super_d, super_w: supertile geometry overrides (0 = auto,
        resolved by ``build_plan``): lanes per supertile (a power of two),
        data-unit rows per supertile (a multiple of 8), and supertiles per
        expand window.
    """

    write_mode: str = "fused"
    tile_mode: str = "auto"
    write_chunk: int = 256
    s_trim: int = 256
    group_du: int = 0
    super_g: int = 0
    super_d: int = 0
    super_w: int = 0

    def __post_init__(self):
        if self.write_mode not in ("fused", "tiles"):
            raise ValueError(
                f"write_mode must be fused|tiles, got {self.write_mode!r}")
        if self.tile_mode not in ("auto", "lane", "super"):
            raise ValueError(
                f"tile_mode must be auto|lane|super, got {self.tile_mode!r}")
        if self.group_du < 0 or self.group_du % 128:
            raise ValueError(
                "group_du must be a multiple of 128, or 0 (auto)")
        if self.super_g < 0 or (self.super_g & (self.super_g - 1)):
            raise ValueError("super_g must be a power of two, or 0 (auto)")
        if self.super_d < 0 or self.super_d % 8:
            raise ValueError(
                "super_d must be a multiple of 8, or 0 (auto)")
        if self.super_w < 0:
            raise ValueError("super_w must be >= 0 (0 = auto)")
        if self.write_chunk <= 0:
            raise ValueError("write_chunk must be positive")
        if self.s_trim <= 0 or self.s_trim % 128:
            raise ValueError("s_trim must be a positive multiple of 128")


_default = Tuning()


def default_tuning() -> Tuning:
    return _default


def set_default_tuning(tuning: Tuning) -> None:
    """Set the process-wide default tuning used by newly built plans."""
    global _default
    _default = tuning
