"""The records write path: emitted records -> tiles -> dense stream.

The alternative to the direct writing decode (``ops.huffman.decode_write``),
selected by ``Tuning(write_mode="tiles")``. It materialises the coefficient
stream in three device stages, with plain tensor code between them. The
middle stages come in two shapes, chosen per scan by ``Tuning.tile_mode``
(:func:`resolve_tile_mode`). The supertile shape:

1. *Records* come from ``ops.huffman.decode_write_emit`` (kernel K4): value
   and lane-local stream position of each committed symbol at
   ``(slot, lane)``.
2. :func:`supertiles_from_records` (kernel K5): the records of ``G``
   consecutive lanes become one ``(super_d, 64)`` *supertile*: row ``d``
   holds data unit ``base[st] + d``, already in natural order.
3. :func:`expand_supertiles` (kernel K6): every dense output row gathers
   and sums the supertile rows that name its data unit, from a window of
   ``W`` supertiles per output group; rows shared by two supertiles (a lane
   group ending inside a data unit) sum. It also returns the
   difference-coded DC value of every data unit as a side vector, which
   ``ops.dc.undelta_dc_values(dc=...)`` consumes.
4. Lanes whose records do not fit (more than ``s_trim`` records, a span of
   more than ``super_d`` data units, a supertile outside its group's
   window) are *leftover*: excluded from the supertiles and added by
   :func:`scatter_leftover`, correct for any input.

:func:`assemble_supertiles` is that whole assembly.

The per-lane shape, for sparse scans (many data units per subsequence, where
even two lanes would overflow a supertile), :func:`assemble_tiles`:

2. :func:`tiles_from_records` (kernel K7): each lane's records become one
   ``(tile_d, 64)`` *tile* of its own: row ``d`` holds data unit
   ``du0[lane] + d``, in natural order.
3. :func:`expand_tiles` (kernel K8): every dense output row gathers and
   sums the tile rows that name its data unit, from a window of 64 lanes
   per group of 128 output rows. It has no DC side vector;
   ``undelta_dc_values`` reads the DC column of the stream instead.
4. Leftover here: a lane that spans more than ``tile_d`` data units, or
   lies past its first group's window; :func:`scatter_leftover` again.

:func:`decode_write_tiles` is the drop-in for ``decode_write`` over both.
Function names and argument order follow the JAX package's
``ops/write_pallas.py``; the operand-type options of its one-hot matrix
products have no counterpart, because K5 and K7 are placements in shared
memory and K6 and K8 row gathers: none multiplies.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from .. import constants as C
from .. import kernels
from .huffman import decode_write_emit, unpack_record

_MAX_SUPER_D = 512  # pk packs (d_rel << 6) | iz into a non-negative int16
_MAX_TILE_D = 512  # K7 keeps tile_d * 256 bytes of shared memory per block
# the per-lane shape's expand stage: data units per output group, and lanes
# per slab (a group gathers from two aligned slabs = 64 candidate lanes)
_GROUP_DU = 128
_SLAB = 32


@functools.lru_cache(maxsize=None)
def _natural(device: torch.device) -> torch.Tensor:
    """int32[64] zig-zag index -> raster index, on ``device``."""
    return torch.tensor(C.ORDER_NATURAL, dtype=torch.int32, device=device)


def _wrap_i16(x: torch.Tensor) -> torch.Tensor:
    """Wrap integer values to int16 (two's complement)."""
    return (((x + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)


def _check(where: str, name: str, t: torch.Tensor, dev: torch.device,
           dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != shape):
        raise ValueError(
            f"{where}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


# --- K5: records -> supertiles ----------------------------------------------

def supertiles_from_records_plain(val_rows, pk_rows, mmax_st, G: int,
                                  super_d: int = 128) -> torch.Tensor:
    """Plain version of :func:`supertiles_from_records`: one ``index_add_``
    over all records, on whatever device holds the tensors."""
    n_st, sg = val_rows.shape
    dev = val_rows.device
    pk = pk_rows.to(torch.int64)
    d = pk >> 6
    col = torch.arange(sg, device=dev)
    ncols = mmax_st.reshape(n_st, 1).to(torch.int64) * G
    ok = (pk >= 0) & (d < super_d) & (col[None, :] < ncols)
    nat = _natural(dev).to(torch.int64)
    st = torch.arange(n_st, device=dev)[:, None]
    tgt = (st * super_d + d) * 64 + nat[pk & 63]
    acc = torch.zeros(n_st * super_d * 64, dtype=torch.int32, device=dev)
    acc.index_add_(0, torch.where(ok, tgt, 0).reshape(-1),
                   torch.where(ok, val_rows, 0).to(torch.int32).reshape(-1))
    return _wrap_i16(acc).view(n_st, super_d, 64)


def supertiles_from_records(val_rows: torch.Tensor, pk_rows: torch.Tensor,
                            mmax_st: torch.Tensor, G: int,
                            super_d: int = 128) -> torch.Tensor:
    """Interleaved records -> int16[n_st, super_d, 64] *natural-order*
    supertiles.

    ``val_rows`` / ``pk_rows`` are int16[n_st, S*G] with column ``s*G + g``
    (slot ``s`` of the group's lane ``g``); ``pk`` packs
    ``(d_rel << 6) | iz``, the record's data-unit row in the supertile and
    its zig-zag index, and is -1 on inert slots. ``mmax_st`` is
    int32[n_st, 1], the largest slot count over the group's included
    lanes: slots at and past it are not read. A record lands at
    ``tile[d_rel][ORDER_NATURAL[iz]]``; records that name the same cell
    sum (int16 wrap), so a value-0 record never disturbs a cell another
    lane of the group writes.

    CUDA tensors: kernel K5 (``kernels/csrc/supertiles.cu``; replaces the
    Pallas kernel behind ``jpeggpu_tpu/ops/write_pallas.py:
    supertiles_from_records``). Bound by bytes: the records are read once
    and every supertile, zeros included, is written once. CPU tensors: the
    plain version.
    """
    dev = val_rows.device
    if not 0 < super_d <= _MAX_SUPER_D:
        raise ValueError(f"super_d must be in 1..{_MAX_SUPER_D}")
    if dev.type == "cpu":
        return supertiles_from_records_plain(val_rows, pk_rows, mmax_st, G,
                                             super_d)
    if dev.type != "cuda":
        raise ValueError(f"supertiles_from_records: unsupported device {dev}")
    where = "supertiles_from_records"
    n_st, sg = val_rows.shape
    if G <= 0 or sg % G or sg % 8 or super_d % 8:
        raise ValueError(f"{where}: {sg} record columns for G={G}, "
                         f"super_d={super_d}: columns must be a multiple of "
                         "G and of 8, super_d a multiple of 8")
    _check(where, "val_rows", val_rows, dev, torch.int16, (n_st, sg))
    _check(where, "pk_rows", pk_rows, dev, torch.int16, (n_st, sg))
    _check(where, "mmax_st", mmax_st, dev, torch.int32, (n_st, 1))
    if val_rows.data_ptr() % 16 or pk_rows.data_ptr() % 16:
        raise ValueError(f"{where}: the record rows must be 16-byte aligned "
                         "(the kernel reads 16 bytes at a time)")
    out = torch.empty((n_st, super_d, 64), dtype=torch.int16, device=dev)
    fn = kernels.get("jpeggpu_supertiles")
    err = fn(val_rows.data_ptr(), pk_rows.data_ptr(), mmax_st.data_ptr(),
             _natural(dev).data_ptr(), out.data_ptr(), n_st, sg, G, super_d,
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, where)
    supertiles_from_records.launches += 1
    return out


supertiles_from_records.launches = 0


# --- K6: supertiles -> dense rows -------------------------------------------

def expand_supertiles_plain(stiles, base, q, n_groups: int, W: int,
                            group_du: int = 128):
    """Plain version of :func:`expand_supertiles`: ``W`` masked row gathers
    summed in int32, on whatever device holds the tensors."""
    n_st, super_d, _ = stiles.shape
    dev = stiles.device
    tiles2d = stiles.reshape(n_st * super_d, 64)
    j = torch.arange(n_groups * group_du, device=dev).view(n_groups, group_du)
    acc = torch.zeros((n_groups * group_du, 64), dtype=torch.int32,
                      device=dev)
    for k in range(W):
        st = q.to(torch.int64) + k  # (n_groups,)
        in_range = (st >= 0) & (st < n_st)
        st = st.clamp(0, n_st - 1)
        d = j - base.to(torch.int64)[st][:, None]
        hit = in_range[:, None] & (d >= 0) & (d < super_d)
        row = (st[:, None] * super_d + d.clamp(0, super_d - 1)).reshape(-1)
        got = tiles2d.index_select(0, row).to(torch.int32)
        acc += torch.where(hit.reshape(-1, 1), got, 0)
    rows = _wrap_i16(acc)
    return rows, rows[:, 0].contiguous()


def expand_supertiles(stiles: torch.Tensor, base: torch.Tensor,
                      q: torch.Tensor, n_groups: int, W: int,
                      group_du: int = 128):
    """Supertiles -> dense int16[n_groups * group_du, 64] natural-order
    rows, and the DC column.

    Output row ``j`` of group ``g = j // group_du`` is the sum (int16 wrap)
    of the rows ``d = j - base[st]`` of the supertiles ``st`` in
    ``q[g] .. q[g] + W - 1`` for which ``0 <= d < super_d``; rows shared by
    lanes in different supertiles sum here. A window position outside
    ``[0, n_st)`` contributes nothing.

    Returns ``(rows, dc)``: ``dc`` is int16[n_groups * group_du], column 0
    of every row: each data unit's difference-coded DC coefficient. (The
    reference's side output is 8 columns wide for its memory tiling, and
    its consumers read column 0; here it is that column alone.)

    CUDA tensors: kernel K6 (``kernels/csrc/expand_supertiles.cu``;
    replaces the Pallas kernel behind ``jpeggpu_tpu/ops/write_pallas.py:
    expand_supertiles``). Bound by bytes: the supertiles are read once, the
    rows written once. CPU tensors: the plain version.
    """
    dev = stiles.device
    if dev.type == "cpu":
        return expand_supertiles_plain(stiles, base, q, n_groups, W, group_du)
    if dev.type != "cuda":
        raise ValueError(f"expand_supertiles: unsupported device {dev}")
    where = "expand_supertiles"
    n_st, super_d, cols = stiles.shape
    if cols != 64 or n_groups <= 0 or W <= 0 or group_du <= 0:
        raise ValueError(f"{where}: supertiles of {cols} columns, "
                         f"{n_groups} groups of {group_du}, window {W}")
    _check(where, "stiles", stiles, dev, torch.int16, (n_st, super_d, 64))
    _check(where, "base", base, dev, torch.int32, (n_st,))
    _check(where, "q", q, dev, torch.int32, (n_groups,))
    if stiles.data_ptr() % 16:
        raise ValueError(f"{where}: stiles must be 16-byte aligned (the "
                         "kernel reads 16 bytes at a time)")
    n_rows = n_groups * group_du
    rows = torch.empty((n_rows, 64), dtype=torch.int16, device=dev)
    dc = torch.empty(n_rows, dtype=torch.int16, device=dev)
    fn = kernels.get("jpeggpu_expand_supertiles")
    err = fn(stiles.data_ptr(), base.data_ptr(), q.data_ptr(),
             rows.data_ptr(), dc.data_ptr(), n_st, super_d, W, group_du,
             n_rows, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, where)
    expand_supertiles.launches += 1
    return rows, dc


expand_supertiles.launches = 0


# --- the assembly around the kernels (plain tensor code) --------------------

def _super_slab(base, max_du, include, G: int, n_groups: int, W: int,
                group_du: int = 128) -> torch.Tensor:
    """q[g]: first supertile of output group g's W-wide gather window,
    anchored at the first supertile whose included lanes reach the group.
    Clipped to ``n_st - W`` so that a window never leaves the supertiles."""
    n_st = base.shape[0]
    reach = torch.where(include, max_du, -1)
    reach_st = torch.cummax(reach.view(n_st, G).max(dim=1).values,
                            dim=0).values
    thresholds = torch.arange(n_groups, dtype=reach_st.dtype,
                              device=base.device) * group_du
    q = torch.searchsorted(reach_st.contiguous(), thresholds)
    return q.clamp(0, max(n_st - W, 0)).to(torch.int32)


def supertile_records(rec, m, du0_raw, pos0, total: int, G: int, W: int,
                      s_trim: int = 512, group_du: int = 128,
                      super_d: int = 128):
    """The preparation in front of K5 and K6: which lanes are leftover, the
    interleaved record rows and the expand windows.

    Returns ``(val_rows, pk_rows, mmax_st, base, q, leftover, n_groups,
    W)``: the three inputs of :func:`supertiles_from_records`, ``base``
    (int32[n_st], first data unit of each supertile) and ``q``
    (int32[n_groups]) for :func:`expand_supertiles`, the leftover lane mask
    (bool[lanes]), and the group count and the window width clipped to the
    supertile count.
    """
    s_cap, lanes = rec.shape
    if total % C.DATA_UNIT_SIZE or G <= 0 or lanes % G:
        raise ValueError(f"{lanes} lanes in groups of {G}, {total} positions")
    if not 0 < super_d <= _MAX_SUPER_D:
        raise ValueError(f"super_d must be in 1..{_MAX_SUPER_D}")
    dev = rec.device
    n_st = lanes // G
    # with fewer supertiles than the window (small dense images) an
    # unclipped window would leave the supertiles
    W = min(W, n_st)
    n_du = total // C.DATA_UNIT_SIZE
    # emitted positions can reach total + 62 (zero-value symbols clamped at
    # the last segment's bound): pad so their rows exist, plus a drop slot
    n_groups = -(-(n_du + 2) // group_du)

    S = min(s_trim, s_cap)
    if S % 8:
        raise ValueError(f"record slot trim {S} must be a multiple of 8")
    val_t, wl_t = unpack_record(rec[:S])
    wpos_t = wl_t + pos0[None, :]  # global position (valid slots only)
    over_trim = m > S

    # du0 must be nondecreasing for the window search: it is for valid
    # streams; a lane that the running max moves is routed to leftover
    du0 = torch.cummax(du0_raw, dim=0).values
    unsorted = du0 != du0_raw
    base = du0.view(n_st, G)[:, 0].contiguous()
    base_l = base.repeat_interleave(G)
    st_l = torch.arange(lanes, dtype=torch.int32, device=dev) // G

    slot = torch.arange(S, dtype=torch.int32, device=dev)[:, None]
    valid = (slot < m[None, :]) & (wl_t >= 0)
    du = wpos_t >> 6
    max_du = torch.where(valid, du, -1).max(dim=0).values
    span_over = (max_du - base_l) >= super_d
    has_rec = m > 0
    inc1 = ~(span_over | unsorted | over_trim) & has_rec
    q1 = _super_slab(base, max_du, inc1, G, n_groups, W, group_du)
    g_first = torch.div(du0, group_du, rounding_mode="floor").clamp(
        0, n_groups - 1)
    window_over = (st_l - q1[g_first.to(torch.int64)]) >= W
    # recordless lanes (padding, or lanes clamped away whole) have nothing
    # to place and are never leftover
    leftover = (span_over | unsorted | window_over | over_trim) & has_rec
    include = ~leftover & has_rec
    # the final q can only move windows upward: every lane that passed the
    # q1 check still fits
    q = _super_slab(base, max_du, include, G, n_groups, W, group_du)

    d_rel = du - base_l[None, :]
    ok = valid & include[None, :] & (d_rel >= 0) & (d_rel < super_d)
    pk = torch.where(ok, (d_rel << 6) | (wpos_t & 63), -1).to(torch.int16)

    def rows(x):
        return x.view(S, n_st, G).permute(1, 0, 2).reshape(n_st, S * G)

    mmax_st = torch.where(include, m, 0).view(n_st, G).max(
        dim=1).values.to(torch.int32).view(n_st, 1)
    return (rows(val_t.to(torch.int16)), rows(pk), mmax_st, base, q,
            leftover, n_groups, W)


def assemble_supertiles(rec, m, du0_raw, pos0, total: int, G: int, W: int,
                        s_trim: int = 512, return_dc: bool = False,
                        group_du: int = 128, super_d: int = 128):
    """Supertile record assembly: preparation, K5, K6, leftover.

    ``rec`` / ``m`` are the packed emission of
    ``ops.huffman.decode_write_emit``, ``pos0`` each lane's first global
    output position and ``du0_raw = pos0 >> 6``. Returns int16[total]
    stream-order coefficients, natural order within each data unit, DC
    still difference-coded; with ``return_dc`` also an
    int16[>= total // 64] vector of per-data-unit difference-coded DC
    values (K6's side output, leftover-corrected).

    ``s_trim`` trims the record slot axis before the interleave: the
    emission buffer is sized for the worst case but real content fills a
    fraction of it. Lanes with more records drain through the leftover
    scatter with their full record lists, so exactness does not depend on
    the trim.
    """
    (val_rows, pk_rows, mmax_st, base, q, leftover, n_groups,
     W) = supertile_records(rec, m, du0_raw, pos0, total, G, W, s_trim,
                            group_du, super_d)
    stiles = supertiles_from_records(val_rows, pk_rows, mmax_st, G, super_d)
    out2d, dc_flat = expand_supertiles(stiles, base, q, n_groups, W, group_du)
    out_flat = out2d.view(-1)
    scatter_leftover(out_flat, rec, m, pos0, leftover, total, s_trim=s_trim,
                     dc_flat=dc_flat if return_dc else None)
    if return_dc:
        return out_flat[:total], dc_flat
    return out_flat[:total]


# --- K7: records -> one tile per lane ----------------------------------------

def tiles_from_records_plain(val, wpos, m, du0, include,
                             tile_d: int = 96) -> torch.Tensor:
    """Plain version of :func:`tiles_from_records`: one ``index_add_`` over
    all records, on whatever device holds the tensors."""
    s_cap, lanes = val.shape
    dev = val.device
    w = wpos.to(torch.int64)
    slot = torch.arange(s_cap, device=dev)[:, None]
    d_rel = (w >> 6) - du0[None, :]
    ok = (include[None, :] & (slot < m[None, :]) & (w >= 0) & (d_rel >= 0)
          & (d_rel < tile_d))
    nat = _natural(dev).to(torch.int64)
    lane = torch.arange(lanes, device=dev)[None, :]
    tgt = (lane * tile_d + d_rel) * 64 + nat[w & 63]
    acc = torch.zeros(lanes * tile_d * 64, dtype=torch.int32, device=dev)
    acc.index_add_(0, torch.where(ok, tgt, 0).reshape(-1),
                   torch.where(ok, val, 0).to(torch.int32).reshape(-1))
    return _wrap_i16(acc).view(lanes, tile_d, 64)


def tiles_from_records(val: torch.Tensor, wpos: torch.Tensor,
                       m: torch.Tensor, du0: torch.Tensor,
                       include: torch.Tensor,
                       tile_d: int = 96) -> torch.Tensor:
    """Records -> int16[lanes, tile_d, 64] *natural-order* tiles, one per
    lane.

    ``val`` (int16) and ``wpos`` (int32) are ``[s_cap, lanes]``, slot-major
    as the emission leaves them: value and global stream position of lane
    ``l``'s record in slot ``s``, ``wpos`` -1 on inert slots. The record is
    live iff ``include[l]``, ``s < m[l]``, ``wpos >= 0`` and its data-unit
    row ``d_rel = (wpos >> 6) - du0[l]`` lies in ``[0, tile_d)``; it lands
    at ``tile[l][d_rel][ORDER_NATURAL[wpos & 63]]``. Records that name the
    same cell sum (int16 wrap), so a value-0 record never disturbs a cell
    that holds a value. A lane with ``include`` false (a leftover lane)
    gives an all-zero tile; every tile is written whole.

    CUDA tensors: kernel K7 (``kernels/csrc/tiles.cu``; replaces the Pallas
    kernel behind ``jpeggpu_tpu/ops/write_pallas.py: tiles_from_records``).
    Bound by bytes: the live records are read once and every tile, zeros
    included, is written once. CPU tensors: the plain version.
    """
    dev = val.device
    if not 0 < tile_d <= _MAX_TILE_D:
        raise ValueError(f"tile_d must be in 1..{_MAX_TILE_D}")
    if dev.type == "cpu":
        return tiles_from_records_plain(val, wpos, m, du0, include, tile_d)
    if dev.type != "cuda":
        raise ValueError(f"tiles_from_records: unsupported device {dev}")
    where = "tiles_from_records"
    s_cap, lanes = val.shape
    _check(where, "val", val, dev, torch.int16, (s_cap, lanes))
    _check(where, "wpos", wpos, dev, torch.int32, (s_cap, lanes))
    _check(where, "m", m, dev, torch.int32, (lanes,))
    _check(where, "du0", du0, dev, torch.int32, (lanes,))
    _check(where, "include", include, dev, torch.bool, (lanes,))
    out = torch.empty((lanes, tile_d, 64), dtype=torch.int16, device=dev)
    fn = kernels.get("jpeggpu_tiles")
    err = fn(val.data_ptr(), wpos.data_ptr(), m.data_ptr(), du0.data_ptr(),
             include.data_ptr(), _natural(dev).data_ptr(), out.data_ptr(),
             s_cap, lanes, tile_d, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, where)
    tiles_from_records.launches += 1
    return out


tiles_from_records.launches = 0


# --- K8: per-lane tiles -> dense rows ----------------------------------------

def expand_tiles_plain(tiles, du0, q, n_groups: int,
                       reach=None) -> torch.Tensor:
    """Plain version of :func:`expand_tiles`: 64 masked row gathers summed
    in int32, on whatever device holds the tensors."""
    lanes, tile_d, _ = tiles.shape
    dev = tiles.device
    tiles2d = tiles.reshape(lanes * tile_d, 64)
    j = torch.arange(n_groups * _GROUP_DU, device=dev).view(n_groups,
                                                            _GROUP_DU)
    acc = torch.zeros((n_groups * _GROUP_DU, 64), dtype=torch.int32,
                      device=dev)
    for k in range(2 * _SLAB):
        lane = q.to(torch.int64) * _SLAB + k  # (n_groups,)
        in_range = (lane >= 0) & (lane < lanes)
        lane = lane.clamp(0, lanes - 1)
        d = j - du0.to(torch.int64)[lane][:, None]
        hit = in_range[:, None] & (d >= 0) & (d < tile_d)
        if reach is not None:
            hit &= j <= reach.to(torch.int64)[lane][:, None]
        row = (lane[:, None] * tile_d + d.clamp(0, tile_d - 1)).reshape(-1)
        got = tiles2d.index_select(0, row).to(torch.int32)
        acc += torch.where(hit.reshape(-1, 1), got, 0)
    return _wrap_i16(acc)


def expand_tiles(tiles: torch.Tensor, du0: torch.Tensor, q: torch.Tensor,
                 n_groups: int, reach=None) -> torch.Tensor:
    """Per-lane tiles -> dense int16[n_groups * 128, 64] natural-order rows.

    Output row ``j`` of group ``g = j // 128`` is the sum (int16 wrap) of
    the rows ``d = j - du0[l]`` of the tiles of the 64 candidate lanes
    ``l`` in ``[32 * q[g], 32 * q[g] + 64)`` for which ``0 <= d < tile_d``
    and, where ``reach`` (int32[lanes]) is given, ``j <= reach[l]``; a row
    shared by two lanes (a subsequence that ends inside a data unit) sums
    here, and the zero tile of an excluded lane matches harmlessly. A
    candidate outside ``[0, lanes)`` contributes nothing. There is no DC
    side output in this shape. ``reach=None`` is the full tile depth, the
    reference's function; :func:`assemble_tiles` passes the last data unit
    each lane's tile can hold nonzero, which leaves the rows unchanged and
    spares reading the rows of zeros past it.

    CUDA tensors: kernel K8 (``kernels/csrc/expand_tiles.cu``; replaces the
    Pallas kernel behind ``jpeggpu_tpu/ops/write_pallas.py: expand_tiles``).
    Bound by bytes: the hit tile rows are read once, the rows written
    once. CPU tensors: the plain version.
    """
    dev = tiles.device
    if dev.type == "cpu":
        return expand_tiles_plain(tiles, du0, q, n_groups, reach)
    if dev.type != "cuda":
        raise ValueError(f"expand_tiles: unsupported device {dev}")
    where = "expand_tiles"
    lanes, tile_d, cols = tiles.shape
    if cols != 64 or n_groups <= 0:
        raise ValueError(f"{where}: tiles of {cols} columns, {n_groups} "
                         "groups")
    _check(where, "tiles", tiles, dev, torch.int16, (lanes, tile_d, 64))
    _check(where, "du0", du0, dev, torch.int32, (lanes,))
    _check(where, "q", q, dev, torch.int32, (n_groups,))
    if reach is not None:
        _check(where, "reach", reach, dev, torch.int32, (lanes,))
    if tiles.data_ptr() % 16:
        raise ValueError(f"{where}: tiles must be 16-byte aligned (the "
                         "kernel reads 16 bytes at a time)")
    n_rows = n_groups * _GROUP_DU
    rows = torch.empty((n_rows, 64), dtype=torch.int16, device=dev)
    fn = kernels.get("jpeggpu_expand_tiles")
    err = fn(tiles.data_ptr(), du0.data_ptr(),
             None if reach is None else reach.data_ptr(), q.data_ptr(),
             rows.data_ptr(), lanes, tile_d, n_rows,
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, where)
    expand_tiles.launches += 1
    return rows


expand_tiles.launches = 0


# --- the per-lane assembly around K7 and K8 (plain tensor code) -------------

def _lane_extents(wpos, m, du0, tile_d: int):
    """Per lane: whether its records span past its tile
    (``span_over``), and the last data unit they reach (``max_du``, -1 for
    a lane without records)."""
    s_cap = wpos.shape[0]
    slot = torch.arange(s_cap, dtype=torch.int32, device=wpos.device)[:, None]
    valid = (slot < m[None, :]) & (wpos >= 0)
    max_du = torch.where(valid, wpos >> 6, -1).amax(dim=0)
    span_over = (max_du - du0) >= tile_d
    return span_over, max_du


def _window_over(du0, q_of_group, lanes: int) -> torch.Tensor:
    """Lanes that lie above the 64-lane window of the first group they
    touch. That group is the worst case, since ``q`` is nondecreasing along
    the groups; and no lane lies below a window, because the running-max
    search anchors each group's window at or before every lane that reaches
    the group."""
    n_groups = q_of_group.shape[0]
    g_first = torch.div(du0, _GROUP_DU, rounding_mode="floor").clamp(
        0, n_groups - 1)
    lane = torch.arange(lanes, dtype=torch.int32, device=du0.device)
    return (lane - _SLAB * q_of_group[g_first.to(torch.int64)]) >= 2 * _SLAB


def _slab_index(du0, max_du, include, lanes: int,
                n_groups: int) -> torch.Tensor:
    """q[g]: the aligned first slab of output group g's window, anchored at
    the first *included* lane whose records reach the group (so that one
    long leftover lane cannot drag the window away). Clipped to ``lanes //
    32 - 2`` so that a window never leaves the lanes."""
    reach = torch.cummax(torch.where(include, max_du, -1), dim=0).values
    thresholds = torch.arange(n_groups, dtype=reach.dtype,
                              device=reach.device) * _GROUP_DU
    l0 = torch.searchsorted(reach.contiguous(), thresholds)
    return torch.div(l0, _SLAB, rounding_mode="floor").clamp(
        0, max(lanes // _SLAB - 2, 0)).to(torch.int32)


def lane_records(rec, m, du0_raw, pos0, total: int, tile_d: int = 96):
    """The preparation in front of K7 and K8: the unpacked records, which
    lanes are leftover and the expand windows.

    Returns ``(val, wpos, du0, q, leftover, n_groups, max_du)``: ``val`` /
    ``wpos`` (int16 / int32 ``[s_cap, lanes]``, value and global position,
    -1 on inert slots) and ``du0`` (int32[lanes], nondecreasing) for
    :func:`tiles_from_records`, whose ``include`` is ``~leftover``; ``q``
    (int32[n_groups]) for :func:`expand_tiles`; the leftover lane mask
    (bool[lanes]), the group count, and the last data unit of each lane's
    records (int32[lanes], -1 for none), from which :func:`assemble_tiles`
    makes :func:`expand_tiles`' ``reach``. The full-depth record buffer is
    unpacked up front: the scans that take this shape are sparse, with few
    lanes and few records.
    """
    lanes = rec.shape[1]
    if total % C.DATA_UNIT_SIZE or lanes % _SLAB:
        raise ValueError(f"{lanes} lanes in slabs of {_SLAB}, {total} "
                         "positions")
    v32, wl = unpack_record(rec)
    val = v32.to(torch.int16)
    wpos = torch.where(wl >= 0, wl + pos0[None, :], -1)
    del v32, wl
    n_du = total // C.DATA_UNIT_SIZE
    # emitted positions can reach total + 62 (zero-value symbols clamped at
    # the last segment's bound): pad so their rows exist, plus a drop slot
    n_groups = -(-(n_du + 2) // _GROUP_DU)
    # du0 must be nondecreasing for the window search: it is for valid
    # streams; a lane that the running max moves is routed to leftover
    du0 = torch.cummax(du0_raw, dim=0).values
    unsorted = du0 != du0_raw

    span_over, max_du = _lane_extents(wpos, m, du0, tile_d)
    q1 = _slab_index(du0, max_du, ~(span_over | unsorted), lanes, n_groups)
    # recordless lanes (padding, or lanes clamped away whole) have nothing
    # to place and are never leftover
    leftover = (span_over | unsorted | _window_over(du0, q1, lanes)) & (m > 0)
    # the final q can only move windows upward: every lane that passed the
    # q1 check still fits
    q = _slab_index(du0, max_du, ~leftover, lanes, n_groups)
    return val, wpos, du0, q, leftover, n_groups, max_du


def assemble_tiles(rec, m, du0_raw, pos0, total: int,
                   tile_d: int = 96) -> torch.Tensor:
    """Per-lane record assembly: preparation, K7, K8, leftover.

    Arguments as :func:`assemble_supertiles`. Returns int16[total]
    stream-order coefficients, natural order within each data unit, DC
    still difference-coded. Leftover lanes drain through
    :func:`scatter_leftover` at its default trim.
    """
    val, wpos, du0, q, leftover, n_groups, max_du = lane_records(
        rec, m, du0_raw, pos0, total, tile_d)
    tiles = tiles_from_records(val, wpos, m, du0, ~leftover, tile_d)
    # K7 places a record only at rows d <= max_du - du0 and writes zeros
    # past them, and a leftover lane's tile is all zeros: the rows past
    # reach add nothing, so K8 need not read them
    reach = torch.where(leftover, -1, max_du)
    out_flat = expand_tiles(tiles, du0, q, n_groups, reach).view(-1)
    scatter_leftover(out_flat, rec, m, pos0, leftover, total)
    return out_flat[:total]


def scatter_leftover(out_flat, rec, m, pos0, leftover, total: int,
                     s_trim: int = 512, dc_flat=None) -> None:
    """Add the records of the leftover lanes to ``out_flat`` (and their DC
    records to ``dc_flat``), in place.

    ``out_flat`` is in natural order and longer than ``total`` (index
    ``total`` is a drop slot); a record's target is
    ``((w >> 6) << 6) | ORDER_NATURAL[w & 63]`` for its global position
    ``w``, a DC record (``w & 63 == 0``) also adds to ``dc_flat[w >> 6]``.
    Sums wrap like int16. One ``nonzero`` (a host read) finds the leftover
    lanes and one ``index_add_`` per tier places them: lanes with at most
    ``s_trim`` records read that many slots, lanes with more read the full
    depth. The count of lanes of the last call is kept in
    ``scatter_leftover.lanes``.
    """
    s_cap = rec.shape[0]
    dev = rec.device
    lanes_idx = torch.nonzero(leftover).view(-1)
    scatter_leftover.lanes = int(lanes_idx.numel())
    if not scatter_leftover.lanes:
        return
    nat = _natural(dev)
    S = min(s_trim, s_cap)
    deep = m[lanes_idx] > S
    for idx, depth in ((lanes_idx[~deep], S), (lanes_idx[deep], s_cap)):
        if not idx.numel():
            continue
        v32, wl = unpack_record(rec[:depth].index_select(1, idx))
        slot = torch.arange(depth, dtype=torch.int32, device=dev)[:, None]
        w = wl + pos0[idx][None, :]
        ok = (slot < m[idx][None, :]) & (wl >= 0) & (w >= 0)
        w = w.clamp(0, total - 1)
        w_nat = ((w >> 6) << 6) | nat[(w & 63).to(torch.int64)]
        v = torch.where(ok, v32, 0).to(torch.int16).reshape(-1)
        out_flat.index_add_(
            0, torch.where(ok, w_nat, total).to(torch.int64).reshape(-1), v)
        if dc_flat is not None:
            okdc = ok & ((w & 63) == 0)
            # drop slot: the last element of the padded side vector
            dtgt = torch.where(okdc, w >> 6, dc_flat.numel() - 1)
            dc_flat.index_add_(
                0, dtgt.to(torch.int64).reshape(-1),
                torch.where(okdc, v32, 0).to(torch.int16).reshape(-1))


scatter_leftover.lanes = 0


def resolve_tile_mode(mode: str, auto_choice: str = "super") -> str:
    """``Tuning.tile_mode`` -> the first assembly stage's shape, "super" or
    "lane". "auto" defers to the plan's per-scan choice
    (``ScanConfig.tile_auto``): ``build_plan`` picks "lane" for sparse
    scans, where even a two-lane group would span more than a supertile
    holds and nearly every lane would drain through the leftover scatter."""
    return auto_choice if mode == "auto" else mode


def decode_write_tiles(cfg, arrs, ctx, p, c, z, n_off,
                       return_dc: bool = False, *, pos_base=None, bound=None,
                       total_out=None, entry=None):
    """Drop-in for ``ops.huffman.decode_write`` through the records path.

    With ``return_dc`` returns ``(coeffs, dc)`` where ``dc`` is the
    supertile shape's per-data-unit difference-coded DC side vector, or
    ``None`` in the per-lane shape, which has none: callers then take the
    DC column from the stream. The keywords are a shard's, as for
    ``decode_write``: the lanes' first positions are ``pos_base + n_off``
    and the output holds ``total_out`` positions."""
    total = cfg.total_positions if total_out is None else total_out
    rec, m = decode_write_emit(cfg, arrs, ctx, p, c, z, n_off,
                               pos_base=pos_base, bound=bound,
                               total_out=total_out, entry=entry)
    if pos_base is None:
        pos_base = arrs.seg_of_subseq * cfg.positions_per_seg
    pos0 = (pos_base + n_off).to(torch.int32)
    if resolve_tile_mode(cfg.tuning.tile_mode, cfg.tile_auto) == "super":
        return assemble_supertiles(
            rec, m, pos0 >> 6, pos0, total, cfg.super_g,
            cfg.super_w, s_trim=cfg.tuning.s_trim, return_dc=return_dc,
            group_du=cfg.group_du, super_d=cfg.super_d)
    coeffs = assemble_tiles(rec, m, pos0 >> 6, pos0, total, cfg.tile_d)
    return (coeffs, None) if return_dc else coeffs
