"""Typed decode-tuning configuration.

Every knob of the device sync and write stages that the package honours
lives in one
frozen dataclass that rides inside the static
:class:`~jpeggpu_tpu_torch.ops.huffman.ScanConfig`; a plan built under a
tuning carries it to every stage (``pipeline.build_plan(stream,
tuning=...)``, or the process default through :func:`set_default_tuning`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Tuning:
    """Static tuning knobs of the device sync and write stages.

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

    The compacted synchronisation tiers of ``ops.huffman.sync_states``
    (the JAX package's fields, defaults and validation):
      frontier_width: lanes of the widest compacted tier; the
        synchronisation runs full-width rounds while more lanes than this
        are mis-synced (0 = auto).
      chain_follow: subsequences a compacted round re-decodes per
        mis-synced chain, each phase starting from the previous phase's
        fresh state (0 = auto).
      head_width: chain heads of the classic narrow tier (0 = auto:
        ``frontier_width // chain_follow``).
      wide_follow: chain-follow depth of the classic wide tier and of the
        ladder's tiers above 512 lanes (0 = 1).
      tail_width, tail_follow: heads and depth of the classic tail tier
        (0 = 64 and 4).
      sync_tiers: "auto" | "classic" | "ladder", the shape of the tiers.
        "classic" is a wide tier at ``frontier_width``, a narrow one at
        ``head_width`` and a tail; "ladder" one tier per halving width from
        ``frontier_width`` down to 32-127 lanes.

    How they resolve (``ops.huffman._resolve_sync_tiers``): with all seven
    at their auto values (``sync_tiers="auto"``, the rest 0), the
    synchronisation is full-width Jacobi rounds to convergence, one K1
    launch a round: the JAX package's ``frontier_width=0`` mode. The JAX
    package's auto values were measured on a TPU, where a full round costs
    about as much as the tiers' compacted rounds together; the card has its
    own K1 round, and the tiers stay an option measured there. Where a
    tuning names any of the seven, the tiers run, resolved as the JAX
    package resolves them on the same kind of device: on CPU tensors as on
    its CPU backend ("classic", ``chain_follow`` auto 1), on CUDA tensors as
    on its accelerator ("ladder", ``chain_follow`` auto 2), and
    ``frontier_width`` auto as ``max(128, lanes // 4)`` for the ladder and
    ``max(2048, lanes // 12)`` for the classic tiers.
    """

    write_mode: str = "fused"
    tile_mode: str = "auto"
    write_chunk: int = 256
    s_trim: int = 256
    group_du: int = 0
    super_g: int = 0
    super_d: int = 0
    super_w: int = 0
    frontier_width: int = 0
    chain_follow: int = 0
    head_width: int = 0
    wide_follow: int = 0
    tail_width: int = 0
    tail_follow: int = 0
    sync_tiers: str = "auto"

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
        for name in SYNC_FIELDS[:-1]:
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 = auto)")
        if self.sync_tiers not in ("auto", "classic", "ladder"):
            raise ValueError(
                f"sync_tiers must be auto|classic|ladder, "
                f"got {self.sync_tiers!r}")

    @property
    def names_sync_tiers(self) -> bool:
        """Whether any of the seven fields of the compacted tiers is set:
        then ``sync_states`` runs the tiers, else the Jacobi rounds."""
        return any(getattr(self, name) != getattr(_AUTO, name)
                   for name in SYNC_FIELDS)


# the fields of the compacted synchronisation tiers
SYNC_FIELDS = ("frontier_width", "chain_follow", "head_width", "wide_follow",
               "tail_width", "tail_follow", "sync_tiers")


_AUTO = Tuning()
_default = _AUTO


def default_tuning() -> Tuning:
    return _default


def set_default_tuning(tuning: Tuning) -> None:
    """Set the process-wide default tuning used by newly built plans."""
    global _default
    _default = tuning
