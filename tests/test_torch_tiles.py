"""PyTorch port, the per-lane tile shape of the records write path
(``Tuning(write_mode="tiles", tile_mode="lane")``, and the ``auto`` that
resolves to it on sparse scans): kernels K7 (tiles_from_records) and K8
(expand_tiles) in their plain versions on the CPU, the tensor code around
them, and the slice as a whole, against the JAX package.

The JAX side runs as its own tests run it on the CPU: the emission through
its XLA loop (one jitted function, compiled once per module), the assembly
eagerly with its Pallas kernels in interpret mode, and one whole decode
through its pipeline under the same tuning. The inputs and outputs of the
JAX assembly's two kernels are captured while it runs, so each port stage is
fed exactly what the JAX stage was fed. Arrays cross as numpy through
``convert``.

The port's records are dense and the JAX decoder's may have holes, so the
port's assembly is fed the JAX ``(rec, m)`` too and outputs are compared,
never ``rec`` slot by slot.

Tolerance: none, every comparison is ``np.array_equal``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import constants as C
from jpeggpu_tpu_torch import convert, golden, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.ops import huffman as TH
from jpeggpu_tpu_torch.ops import write as TW

_S420 = [(2, 2), (1, 1), (1, 1)]
_LANE = T.Tuning(write_mode="tiles", tile_mode="lane")
_SUPER = T.Tuning(write_mode="tiles", tile_mode="super")
_AUTO = T.Tuning(write_mode="tiles")


def _port_stage(data, tuning=_LANE):
    """The port's decode of a one-scan stream up to the write stage."""
    plan = pipeline.build_plan(T.parse(data), tuning=tuning)
    inputs = pipeline.build_inputs(data, plan)
    cfg = plan.signature.scans[0].cfg
    arrs = convert.scan_arrays(inputs["scans"][0], "cpu", cfg.fast_tables)
    ctx = TH.make_ctx(cfg, arrs)
    p, c, z, n = TH.sync_states(cfg, arrs, ctx)
    n_off = TH.symbol_offsets(cfg, arrs, n)
    rec, m = TH.decode_write_emit(cfg, arrs, ctx, p, c, z, n_off)
    pos0 = arrs.seg_of_subseq * cfg.positions_per_seg + n_off
    return dict(data=data, plan=plan, inputs=inputs, cfg=cfg, arrs=arrs,
                ctx=ctx, states=(p, c, z, n_off), rec=rec, m=m, pos0=pos0,
                fused=TH.decode_write(cfg, arrs, ctx, p, c, z, n_off))


def _jax_assemble(rec, m, pos0, total, tile_d, capture=None):
    """The JAX package's per-lane assembly, eagerly (its Pallas kernels in
    interpret mode); with ``capture`` the arguments and results of its two
    kernels are kept there."""
    from jpeggpu_tpu.ops import write_pallas as WP

    orig_tiles, orig_expand = WP.tiles_from_records, WP.expand_tiles

    def tiles(val, wpos, m, du0, include, tile_d, tile_dot):
        out = orig_tiles(val, wpos, m, du0, include, tile_d, tile_dot)
        if capture is not None:
            capture["tiles"] = tuple(np.asarray(x) for x in (
                val, wpos, m, du0, include)) + (tile_d, np.asarray(out))
        return out

    def expand(tiles_in, du0, q, n_groups):
        out = orig_expand(tiles_in, du0, q, n_groups)
        if capture is not None:
            capture["expand"] = (np.asarray(tiles_in), np.asarray(du0),
                                 np.asarray(q), n_groups, np.asarray(out))
        return out

    WP.tiles_from_records, WP.expand_tiles = tiles, expand
    try:
        return np.asarray(WP.assemble_tiles(
            jnp.asarray(rec), jnp.asarray(m), jnp.asarray(pos0 >> 6),
            jnp.asarray(pos0), total, tile_d, "f32"))
    finally:
        WP.tiles_from_records, WP.expand_tiles = orig_tiles, orig_expand


@pytest.fixture(scope="module")
def port_stage(test_image):
    return _port_stage(encode(test_image, EncodeSpec(
        sampling=_S420, restart_interval=2)))


@pytest.fixture(scope="module")
def jax_stage(port_stage):
    """The JAX package's per-lane records path on the same staged state and
    the same converged states: ``(rec, m)`` from its XLA emitter, and the
    assembly's result with the arguments and results of its two kernels."""
    from jpeggpu_tpu.config import Tuning as JTuning
    from jpeggpu_tpu.ops import huffman as JH
    from jpeggpu_tpu.pipeline import build_plan
    from jpeggpu_tpu.reader import parse

    s = port_stage
    jcfg = build_plan(parse(s["data"]), tuning=JTuning(
        write_mode="tiles", tile_mode="lane")).signature.scans[0].cfg
    inp = s["inputs"]["scans"][0]
    states = [x.numpy() for x in s["states"]]

    def emit(inp, p, c, z, n_off):
        arrs = JH.ScanArrays(
            words=inp["words"], seg_of_subseq=inp["seg_of_subseq"],
            seg_first_lane=inp["seg_first_lane"],
            seg_num_subseq=inp["seg_num_subseq"], maxcode=inp["maxcode"],
            vsm=inp["vsm"], huffval=inp["huffval"])
        ctx = JH.make_ctx(jcfg, arrs)
        return JH.decode_write_emit(jcfg, arrs, ctx, p, c, z, n_off)

    args = (inp, *states)
    rec, m = [np.asarray(x)
              for x in jax.jit(emit).lower(*args).compile()(*args)]
    captured = {}
    coeffs = _jax_assemble(rec, m, s["pos0"].numpy(), jcfg.total_positions,
                           jcfg.tile_d, captured)
    return dict(cfg=jcfg, rec=rec, m=m, coeffs=coeffs, **captured)


# --- geometry ----------------------------------------------------------------

def test_plan_geometry_matches_jax(port_stage, jax_stage):
    """build_plan's tile geometry, tile_d included, equals the reference's,
    and a reference geometry crosses whole through convert."""
    cfg, jcfg = port_stage["cfg"], jax_stage["cfg"]
    assert "tile_d" in convert.GEOMETRY_FIELDS
    for k in convert.GEOMETRY_FIELDS:
        assert getattr(cfg, k) == getattr(jcfg, k), k
    assert convert.scan_config(
        {**{k: getattr(jcfg, k) for k in convert.GEOMETRY_FIELDS},
         "tuning": jcfg.tuning}) == cfg
    assert TH.ScanConfig.__dataclass_fields__["tile_d"].default == 96
    assert (TW._GROUP_DU, TW._SLAB) == (128, 32)


@pytest.mark.parametrize("content,quality,expect", [
    ("noise", 95, (32, "super")), ("smooth", 85, (64, "super")),
    ("smooth", 50, (96, "super")), ("smooth", 10, (128, "super")),
    ("smooth", 5, (128, "lane")), ("flat", 50, (128, "lane"))])
def test_tile_d_follows_density(test_image, noise_image, content, quality,
                                expect):
    """tile_d and the auto choice from dense to sparse scans, against the
    reference's build_plan."""
    from jpeggpu_tpu.pipeline import build_plan
    from jpeggpu_tpu.reader import parse

    img = {"noise": noise_image[..., 0],
           "smooth": np.tile(test_image[..., 0], (3, 3)),
           "flat": np.full((128, 136), 130, np.uint8)}[content]
    data = encode(img, EncodeSpec(quality=quality))
    cfg = pipeline.build_plan(T.parse(data)).signature.scans[0].cfg
    jcfg = build_plan(parse(data)).signature.scans[0].cfg
    assert (cfg.tile_d, cfg.tile_auto) == (jcfg.tile_d, jcfg.tile_auto)
    assert (cfg.tile_d, cfg.tile_auto) == expect


# --- K7 ----------------------------------------------------------------------

def test_tiles_match_jax(jax_stage):
    """K7's plain version on the real records of 420_rst2, as the JAX
    assembly handed them to its kernel."""
    val, wpos, m, du0, include, tile_d, expect = jax_stage["tiles"]
    got = TW.tiles_from_records(
        *convert.to_torch((val, wpos, m, du0, include)), tile_d)
    assert got.dtype == torch.int16 and expect.dtype == np.int16
    assert got.shape == expect.shape == (val.shape[1], tile_d, 64)
    assert np.array_equal(got.numpy(), expect)
    assert expect.any()


def test_tiles_synthetic_extremes_match_jax():
    """The synthetic records of the reference's own value-range test:
    int16 extremes at random distinct positions, tile_d 32."""
    from jpeggpu_tpu.ops import write_pallas as WP

    lanes, s_cap, tile_d = 128, 128, 32
    rng = np.random.default_rng(7)
    vals = np.zeros((s_cap, lanes), np.int16)
    wpos = np.full((s_cap, lanes), -1, np.int32)
    m = np.zeros(lanes, np.int32)
    du0 = np.arange(lanes, dtype=np.int32) * 2
    extremes = np.array([-32768, -32767, -256, -255, -129, -128, -127, -1,
                         0, 1, 127, 128, 255, 256, 32766, 32767], np.int64)
    for lane in range(lanes):
        k = int(rng.integers(1, 40))
        m[lane] = k
        pos = np.sort(rng.choice(tile_d * 64, size=k, replace=False))
        vals[:k, lane] = rng.permuted(np.resize(extremes, k)).astype(np.int16)
        wpos[:k, lane] = du0[lane] * 64 + pos
    include = rng.random(lanes) > 0.1
    expect = np.asarray(WP.tiles_from_records(
        jnp.asarray(vals), jnp.asarray(wpos), jnp.asarray(m),
        jnp.asarray(du0), jnp.asarray(include), tile_d, "f32"))
    got = TW.tiles_from_records(
        *convert.to_torch((vals, wpos, m, du0, include)), tile_d).numpy()
    assert np.array_equal(got, expect)
    assert got.any() and not got[~include].any()


def _lane_records(records, lanes, s_cap):
    """(slot, lane, value, global position) -> val, wpos."""
    val = np.zeros((s_cap, lanes), np.int16)
    wpos = np.full((s_cap, lanes), -1, np.int32)
    for s, lane, v, w in records:
        val[s, lane] = v
        wpos[s, lane] = w
    return val, wpos


# name -> (records, m of lanes 0..3, include of lanes 0..3, expected cells
# as (lane, row, zig-zag index) -> value, whether the reference is asked too)
_NAT = C.ORDER_NATURAL
_K7_CASES = {
    "natural_column_order": (
        [(0, 0, 7, 10 * 64 + 5), (1, 0, -9, 12 * 64 + 63)], [2, 0, 0, 0],
        [True] * 4, {(0, 0, 5): 7, (0, 2, 63): -9}, True),
    "include_false_gives_a_zero_tile": (
        [(0, 0, 7, 10 * 64 + 5), (0, 1, 8, 20 * 64 + 1)], [1, 1, 0, 0],
        [False, True, True, True], {(1, 0, 1): 8}, True),
    "rows_outside_the_tile_are_dropped": (
        # lane 1 starts at data unit 20: unit 19 lies below, 20 + 16 above
        [(0, 1, 5, 19 * 64 + 3), (1, 1, 6, 36 * 64 + 3), (2, 1, 4, 35 * 64)],
        [0, 3, 0, 0], [True] * 4, {(1, 15, 0): 4}, True),
    "slots_at_and_past_m_are_not_read": (
        [(0, 2, 3, 30 * 64 + 2), (1, 2, 99, 30 * 64 + 3)], [0, 0, 1, 0],
        [True] * 4, {(2, 0, 2): 3}, True),
    "inert_slot_inside_m": (
        [(0, 3, 11, 40 * 64), (2, 3, 12, 41 * 64 + 9)], [0, 0, 0, 3],
        [True] * 4, {(3, 0, 0): 11, (3, 1, 9): 12}, True),
    "zero_record_on_a_live_cell": (
        # an EOB run's position names the cell the lane wrote just before
        [(0, 0, 1234, 10 * 64 + 5), (1, 0, 0, 10 * 64 + 5),
         (2, 0, 0, 11 * 64 + 7), (3, 0, -77, 11 * 64 + 7)], [4, 0, 0, 0],
        [True] * 4, {(0, 0, 5): 1234, (0, 1, 7): -77}, True),
    "two_records_on_one_cell_sum": (
        [(0, 1, 100, 21 * 64 + 2), (1, 1, 23, 21 * 64 + 2)], [0, 2, 0, 0],
        [True] * 4, {(1, 1, 2): 123}, True),
    "sums_wrap_like_int16": (
        # past int16 the reference's float32 sum has no defined cast
        [(0, 1, 30000, 21 * 64 + 2), (1, 1, 30000, 21 * 64 + 2),
         (2, 1, -32768, 22 * 64), (3, 1, -1, 22 * 64)], [0, 4, 0, 0],
        [True] * 4, {(1, 1, 2): 60000 - 65536, (1, 2, 0): 32767}, False),
}


@pytest.mark.parametrize("name", list(_K7_CASES))
def test_tiles_edge_cases(name):
    """What K7 must do with each kind of slot, against cells written out by
    hand and, wherever its sums fit int16, against the reference."""
    from jpeggpu_tpu.ops import write_pallas as WP

    records, m4, include4, cells, ask_reference = _K7_CASES[name]
    lanes, s_cap, tile_d = 64, 8, 16
    val, wpos = _lane_records(records, lanes, s_cap)
    m = np.zeros(lanes, np.int32)
    m[:4] = m4
    include = np.ones(lanes, bool)
    include[:4] = include4
    du0 = np.full(lanes, 50, np.int32)
    du0[:4] = [10, 20, 30, 40]
    got = TW.tiles_from_records(
        *convert.to_torch((val, wpos, m, du0, include)), tile_d).numpy()
    expect = np.zeros((lanes, tile_d, 64), np.int16)
    for (lane, row, iz), v in cells.items():
        expect[lane, row, _NAT[iz]] = v
    assert np.array_equal(got, expect)
    assert _NAT[5] != 5  # a swapped permutation would show
    if ask_reference:
        ref = np.asarray(WP.tiles_from_records(
            jnp.asarray(val), jnp.asarray(wpos), jnp.asarray(m),
            jnp.asarray(du0), jnp.asarray(include), tile_d, "f32"))
        assert np.array_equal(ref, expect)


# --- K8 ----------------------------------------------------------------------

def test_expand_matches_jax(jax_stage):
    """K8's plain version on the JAX tiles, du0 and q of 420_rst2."""
    tiles, du0, q, n_groups, expect = jax_stage["expand"]
    got = TW.expand_tiles(*convert.to_torch((tiles, du0, q)), n_groups)
    assert got.dtype == torch.int16
    assert got.shape == expect.shape == (n_groups * 128, 64)
    assert np.array_equal(got.numpy(), expect)
    assert expect.any()


def test_expand_shared_rows_and_zero_tiles():
    """Rows shared by two lanes sum, at int16 extremes where one lane owns
    the row alone; the zero tile of an excluded lane matches harmlessly;
    groups take their own windows. Against the reference."""
    from jpeggpu_tpu.ops import write_pallas as WP

    rng = np.random.default_rng(5)
    lanes, tile_d, n_groups = 128, 32, 8
    moderate = np.array([-16000, -4087, -256, -129, -128, -1, 0, 1, 127,
                         128, 255, 256, 4086, 16000], np.int64)
    tiles = rng.permuted(np.resize(moderate, lanes * tile_d * 64)).reshape(
        lanes, tile_d, 64).astype(np.int16)
    # lanes 24 data units apart with tiles of 32: every lane shares its
    # last 8 rows with the next lane's first 8; lanes 40..79 start
    # together with lane 39 and are excluded (zero tiles)
    du0 = np.concatenate([np.arange(40) * 24, np.full(40, 39 * 24),
                          39 * 24 + 24 * np.arange(1, 49)]).astype(np.int32)
    tiles[40:80] = 0
    extremes = np.array([-32768, -32767, -1, 0, 1, 32766, 32767], np.int64)
    tiles[0, 8:24] = np.resize(extremes, (16, 64)).astype(np.int16)
    tiles[1:, :8] //= 2  # shared rows: two terms stay inside int16
    tiles[:, 24:] //= 2
    # the window of group g starts at the slab of the first lane reaching it
    reach = np.maximum.accumulate(du0 + tile_d - 1)
    q = np.clip(np.searchsorted(reach, np.arange(n_groups) * 128) // 32, 0,
                lanes // 32 - 2).astype(np.int32)
    got = TW.expand_tiles(*convert.to_torch((tiles, du0, q)),
                          n_groups).numpy()
    ref = np.asarray(WP.expand_tiles(jnp.asarray(tiles), jnp.asarray(du0),
                                     jnp.asarray(q), n_groups))
    assert np.array_equal(got, ref)
    # row 30 lies in lane 0 (its row 30) and lane 1 (its row 6)
    both = tiles[0, 30].astype(np.int32) + tiles[1, 6].astype(np.int32)
    assert np.array_equal(got[30], both.astype(np.int16))
    assert np.array_equal(got[8:24], tiles[0, 8:24])  # lane 0 alone
    assert len(set(q.tolist())) > 1 and got[-64:].any()


def test_expand_window_never_leaves_the_lanes():
    """A candidate lane outside [0, lanes) contributes nothing, whatever q
    holds, and sums past int16 wrap."""
    lanes, tile_d = 96, 8
    tiles = np.full((lanes, tile_d, 64), 30000, np.int16)
    du0 = np.zeros(lanes, np.int32)
    du0[64:] = 128
    q = np.array([-1, 2], np.int32)
    rows = TW.expand_tiles(*convert.to_torch((tiles, du0, q)), 2).numpy()
    # group 0 sees lanes -32..31: the 32 real ones, rows 0..7
    assert np.all(rows[:8] == np.int16((32 * 30000) % 65536 - 65536))
    assert not rows[8:128].any()
    # group 1 sees lanes 64..127: the 32 real ones start at data unit 128
    assert np.all(rows[128:136] == rows[0, 0]) and not rows[136:].any()


@pytest.mark.parametrize("records", ["port", "jax"])
def test_expand_with_reach_matches_full_depth_and_jax(port_stage, jax_stage,
                                                      records):
    """On the tiles that K7's plain version makes from the 420_rst2 records
    (the port's own, and the JAX emitter's with its holes), K8 with the
    reach that assemble_tiles passes (max_du, -1 for a leftover lane) gives
    the rows of the full tile depth and of the JAX expand_tiles, though it
    leaves tile rows out."""
    from jpeggpu_tpu.ops import write_pallas as WP

    s, cfg = port_stage, port_stage["cfg"]
    rec, m = ((s["rec"], s["m"]) if records == "port" else
              convert.to_torch((jax_stage["rec"], jax_stage["m"])))
    val, wpos, du0, q, leftover, n_groups, max_du = TW.lane_records(
        rec, m, s["pos0"] >> 6, s["pos0"], cfg.total_positions, cfg.tile_d)
    tiles = TW.tiles_from_records_plain(val, wpos, m, du0, ~leftover,
                                        cfg.tile_d)
    reach = torch.where(leftover, -1, max_du)
    got = TW.expand_tiles(tiles, du0, q, n_groups, reach)
    full = TW.expand_tiles(tiles, du0, q, n_groups)
    expect = np.asarray(WP.expand_tiles(*(jnp.asarray(x.numpy()) for x in (
        tiles, du0, q)), n_groups))
    assert got.dtype == torch.int16 and got.shape == (n_groups * 128, 64)
    assert np.array_equal(got.numpy(), full.numpy())
    assert np.array_equal(got.numpy(), expect) and expect.any()
    # reach leaves rows of the tiles out, and only rows of zeros
    past = (du0[:, None].to(torch.int64) + torch.arange(cfg.tile_d)
            > reach[:, None])
    assert past.any() and not tiles[past].any()


@pytest.mark.parametrize("pattern", ["inside", "extremes"])
def test_expand_reach_masks_exactly_the_rows_past_it(pattern):
    """On stuffed random tiles (no row of zeros) K8 with reach equals K8 at
    the full depth on the same tiles with the rows past reach zeroed, and
    the JAX expand_tiles on those; without the zeroing they differ."""
    from jpeggpu_tpu.ops import write_pallas as WP

    rng = np.random.default_rng(17)
    lanes, tile_d, n_groups = 128, 32, 8
    # sums of up to ten rows stay inside int16, where the reference, which
    # sums in float32, agrees
    tiles = rng.integers(-3000, 3001, (lanes, tile_d, 64)).astype(np.int16)
    du0 = np.sort(rng.integers(0, n_groups * 128 - tile_d, lanes)).astype(
        np.int32)
    reach = du0.astype(np.int64) + rng.integers(-3, tile_d + 3, lanes)
    if pattern == "extremes":
        i32 = np.iinfo(np.int32)
        reach[::5] = -1
        reach[1::7] = i32.min
        reach[2::7] = i32.max
    reach = reach.astype(np.int32)
    chosen = (du0[:, None].astype(np.int64) + np.arange(tile_d)
              <= reach[:, None])
    masked = np.where(chosen[..., None], tiles, 0).astype(np.int16)
    reach_q = np.maximum.accumulate(du0 + tile_d - 1)
    q = np.clip(np.searchsorted(reach_q, np.arange(n_groups) * 128) // 32, 0,
                lanes // 32 - 2).astype(np.int32)
    t, d, qq, r, mk = convert.to_torch((tiles, du0, q, reach, masked))
    got = TW.expand_tiles(t, d, qq, n_groups, r).numpy()
    assert np.array_equal(got, TW.expand_tiles(mk, d, qq, n_groups).numpy())
    expect = np.asarray(WP.expand_tiles(jnp.asarray(masked), jnp.asarray(du0),
                                        jnp.asarray(q), n_groups))
    assert np.array_equal(got, expect)
    assert not np.array_equal(got, TW.expand_tiles(t, d, qq, n_groups).numpy())
    assert (~chosen).any() and chosen.any()


# --- the tensor code around the kernels -------------------------------------

@pytest.fixture(scope="module")
def window_inputs(jax_stage):
    """Real (wpos, m, du0) of 420_rst2, and a synthetic sparse case with
    long lanes, crowded lanes and a lane out of order."""
    val, wpos, m, du0, include, tile_d, _ = jax_stage["tiles"]
    rng = np.random.default_rng(11)
    lanes, s_cap = 256, 16
    sdu0 = np.sort(rng.integers(0, 2000, lanes)).astype(np.int32)
    sdu0[100:180] = sdu0[100]  # 80 lanes crowd one data unit
    sm = rng.integers(0, s_cap + 1, lanes).astype(np.int32)
    step = rng.integers(1, 12 * 64, (s_cap, lanes))
    swpos = (sdu0[None, :] * 64 + np.cumsum(step, axis=0)).astype(np.int32)
    swpos[rng.random((s_cap, lanes)) < 0.1] = -1
    return {"real": (wpos, m, du0, tile_d), "synthetic": (swpos, sm, sdu0, 64)}


@pytest.mark.parametrize("which", ["real", "synthetic"])
def test_lane_extents_slab_index_window_over_match_jax(window_inputs, which):
    """_lane_extents, _slab_index and _window_over, chained as
    assemble_tiles chains them, equal the reference's at every step."""
    from jpeggpu_tpu.ops import write_pallas as WP

    wpos, m, du0, tile_d = window_inputs[which]
    lanes = wpos.shape[1]
    n_groups = int(du0.max()) // 128 + 3
    t = convert.to_torch((wpos, m, du0))
    j = [jnp.asarray(x) for x in (wpos, m, du0)]
    span, max_du = TW._lane_extents(*t, tile_d)
    jspan, jmax_du = WP._lane_extents(*j, tile_d)
    assert np.array_equal(span.numpy(), np.asarray(jspan))
    assert np.array_equal(max_du.numpy(), np.asarray(jmax_du))
    q1 = TW._slab_index(t[2], max_du, ~span, lanes, n_groups)
    jq1 = WP._slab_index(j[2], jmax_du, ~jspan, lanes, n_groups)
    assert q1.dtype == torch.int32
    assert np.array_equal(q1.numpy(), np.asarray(jq1))
    over = TW._window_over(t[2], q1, lanes)
    jover = WP._window_over(j[2], jq1, lanes)
    assert np.array_equal(over.numpy(), np.asarray(jover))
    if which == "synthetic":
        assert span.any() and over.any() and len(set(q1.tolist())) > 2


def test_assemble_on_jax_records_matches_jax(port_stage, jax_stage):
    """The port's assembly fed the JAX emitter's ``(rec, m)`` (holes and
    all) gives the JAX assembly's coefficients."""
    s, cfg = port_stage, port_stage["cfg"]
    rec, m = convert.to_torch((jax_stage["rec"], jax_stage["m"]))
    coeffs = TW.assemble_tiles(rec, m, s["pos0"] >> 6, s["pos0"],
                               cfg.total_positions, cfg.tile_d)
    assert coeffs.dtype == torch.int16
    assert np.array_equal(coeffs.numpy(), jax_stage["coeffs"])


def test_assemble_on_own_records_matches_direct_write(port_stage, jax_stage):
    """The per-lane assembly on the port's own records equals the direct
    writing decode (K2's plain version), the JAX assembly and the supertile
    shape; decode_write_tiles returns no DC side vector in this shape."""
    s, cfg = port_stage, port_stage["cfg"]
    coeffs = TW.assemble_tiles(s["rec"], s["m"], s["pos0"] >> 6, s["pos0"],
                               cfg.total_positions, cfg.tile_d)
    assert np.array_equal(coeffs.numpy(), s["fused"].numpy())
    assert np.array_equal(coeffs.numpy(), jax_stage["coeffs"])
    sup = TW.assemble_supertiles(
        s["rec"], s["m"], s["pos0"] >> 6, s["pos0"], cfg.total_positions,
        cfg.super_g, cfg.super_w, s_trim=cfg.tuning.s_trim,
        group_du=cfg.group_du, super_d=cfg.super_d)
    assert np.array_equal(coeffs.numpy(), sup.numpy())
    both = TW.decode_write_tiles(cfg, s["arrs"], s["ctx"], *s["states"],
                                 return_dc=True)
    assert both[1] is None and np.array_equal(both[0].numpy(),
                                              coeffs.numpy())
    alone = TW.decode_write_tiles(cfg, s["arrs"], s["ctx"], *s["states"])
    assert np.array_equal(alone.numpy(), coeffs.numpy())


def _garbage_body(image):
    """A valid header in front of a random scan body (no 0xFF bytes)."""
    data = encode(image[..., 0], EncodeSpec(restart_interval=3))
    scan = T.parse(data).scans[0]
    rng = np.random.default_rng(23)
    body = rng.integers(0, 255, scan.end - scan.begin, dtype=np.uint8)
    body[body == 0xFF] = 0x7F
    return data[:scan.begin] + body.tobytes() + data[scan.end:]


def _flat_gray(image):
    """Flat gray: ~3 bits per data unit, a subsequence spans more data
    units than a tile holds."""
    return encode(np.full((128, 136), 130, np.uint8), EncodeSpec(quality=50))


@pytest.mark.parametrize("make", [_garbage_body, _flat_gray])
def test_assemble_leftover_routes_match_jax(test_image, make):
    """On a garbage body and on the flat low-entropy image (whose lanes
    drain through the leftover scatter) the port's assembly equals the JAX
    assembly on the same records, and the direct write."""
    s = _port_stage(make(test_image))
    cfg = s["cfg"]
    coeffs = TW.assemble_tiles(s["rec"], s["m"], s["pos0"] >> 6, s["pos0"],
                               cfg.total_positions, cfg.tile_d)
    if make is _flat_gray:
        assert TW.scatter_leftover.lanes > 0
    expect = _jax_assemble(s["rec"].numpy(), s["m"].numpy(),
                           s["pos0"].numpy(), cfg.total_positions, cfg.tile_d)
    assert np.array_equal(coeffs.numpy(), expect)
    assert np.array_equal(coeffs.numpy(), s["fused"].numpy())


def test_assemble_passes_reach_from_lane_records(test_image, monkeypatch):
    """assemble_tiles hands K8 reach = max_du of lane_records, -1 for the
    leftover lanes, on the flat image (whose lanes drain through the
    leftover scatter too); the decode still equals golden and the direct
    write."""
    seen = {}
    orig_prep, orig_expand = TW.lane_records, TW.expand_tiles

    def prep(*a, **k):
        seen["prep"] = orig_prep(*a, **k)
        return seen["prep"]

    def expand(tiles, du0, q, n_groups, reach=None):
        seen["reach"] = reach
        return orig_expand(tiles, du0, q, n_groups, reach)

    monkeypatch.setattr(TW, "lane_records", prep)
    monkeypatch.setattr(TW, "expand_tiles", expand)
    data = _flat_gray(test_image)
    s = _port_stage(data)
    cfg = s["cfg"]
    coeffs = TW.assemble_tiles(s["rec"], s["m"], s["pos0"] >> 6, s["pos0"],
                               cfg.total_positions, cfg.tile_d)
    assert np.array_equal(coeffs.numpy(), s["fused"].numpy())
    _, wpos, du0, _, leftover, _, max_du = seen["prep"]
    span, ext = TW._lane_extents(wpos, s["m"], du0, cfg.tile_d)
    assert np.array_equal(max_du.numpy(), ext.numpy())
    assert leftover.any() and (~leftover & (s["m"] > 0)).any()
    assert np.array_equal(seen["reach"].numpy(),
                          torch.where(leftover, -1, max_du).numpy())
    _, planes = _decode(data, _LANE)
    assert _same(planes, golden.decode(data))


def test_assemble_routes_unsorted_lanes_to_leftover(port_stage):
    """A lane whose first data unit lies below its predecessor's (no valid
    stream has one) is moved by the running max and drains through the
    leftover scatter: the result is unchanged."""
    s, cfg = port_stage, port_stage["cfg"]
    du0 = (s["pos0"] >> 6).clone()
    lane = int(torch.nonzero(s["m"] > 0)[10])
    du0[lane] = du0[lane - 1] - 1
    coeffs = TW.assemble_tiles(s["rec"], s["m"], du0, s["pos0"],
                               cfg.total_positions, cfg.tile_d)
    assert TW.scatter_leftover.lanes >= 1
    assert np.array_equal(coeffs.numpy(), s["fused"].numpy())


# --- the slice as a whole ----------------------------------------------------

def _decode(data, tuning=None):
    plan = pipeline.build_plan(T.parse(data), tuning=tuning)
    return plan, pipeline.decode_jpeg_device(data, device="cpu", plan=plan)


def _same(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype == np.uint8 and np.array_equal(x, y)
        for x, y in zip(a, b))


def test_lane_decode_matches_jax_pipeline(port_stage):
    """decode_jpeg_device under Tuning(write_mode="tiles",
    tile_mode="lane") equals the JAX pipeline under the same tuning (its
    Pallas kernels in interpret mode), golden, the default path and the
    supertile shape."""
    from jpeggpu_tpu.config import Tuning as JTuning
    from jpeggpu_tpu.pipeline import build_plan, decode_jpeg_device
    from jpeggpu_tpu.reader import parse

    data = port_stage["data"]
    plan, got = _decode(data, _LANE)
    assert plan.signature.scans[0].cfg.tuning == _LANE
    expect = decode_jpeg_device(data, plan=build_plan(
        parse(data), tuning=JTuning(write_mode="tiles", tile_mode="lane")))
    assert len(got) == 3 and _same(got, expect)
    assert _same(got, golden.decode(data))
    assert _same(got, _decode(data)[1])
    assert _same(got, _decode(data, _SUPER)[1])


def _mixed_scans(image):
    """Non-interleaved, a detailed luma scan and two flat chroma scans: the
    first dense, the others sparse."""
    rng = np.random.default_rng(31)
    gray = rng.integers(0, 255, (128, 136, 1)).astype(np.uint8)
    return encode(np.repeat(gray, 3, axis=2), EncodeSpec(
        sampling=[(1, 1)] * 3, interleaved=False, quality=50))


_STREAMS = {
    "420_rst2": lambda image: encode(image, EncodeSpec(
        sampling=_S420, restart_interval=2)),
    "444": lambda image: encode(image, EncodeSpec(sampling=[(1, 1)] * 3)),
    "422_rst5_q95": lambda image: encode(image, EncodeSpec(
        sampling=[(2, 1), (1, 1), (1, 1)], restart_interval=5, quality=95)),
    "garbage_body": _garbage_body,
    "flat_gray_q50": _flat_gray,
    "non_interleaved": lambda image: encode(image, EncodeSpec(
        sampling=_S420, interleaved=False)),
    "mixed_scans": _mixed_scans,
}


@pytest.mark.parametrize("name", list(_STREAMS))
def test_lane_decode_matches_golden(test_image, name):
    """The forced per-lane shape equals golden, the default path and the
    supertile shape, over the reference's three specs, a garbage body, the
    flat image and two non-interleaved streams."""
    data = _STREAMS[name](test_image)
    _, got = _decode(data, _LANE)
    if name == "flat_gray_q50":
        assert TW.scatter_leftover.lanes > 0
    assert _same(got, golden.decode(data))
    assert _same(got, _decode(data)[1])
    assert _same(got, _decode(data, _SUPER)[1])


def test_auto_resolves_to_lane_on_the_flat_image(test_image, monkeypatch):
    """tile_mode="auto" on a sparse scan takes the per-lane shape, through
    the plan and through a Decoder under the process default."""
    data = _flat_gray(test_image)
    calls = []
    orig = TW.assemble_tiles
    monkeypatch.setattr(TW, "assemble_tiles", lambda *a, **k: (
        calls.append("lane"), orig(*a, **k))[1])
    plan, got = _decode(data, _AUTO)
    cfg = plan.signature.scans[0].cfg
    assert (cfg.tile_auto, cfg.tile_d) == ("lane", 128)
    assert calls == ["lane"] and _same(got, golden.decode(data))
    base = T.default_tuning()
    try:
        T.set_default_tuning(_AUTO)
        with T.Decoder(device="cpu") as d:
            d.parse_header(data)
            size = d.get_buffer_size()
            planes = d.decode()
    finally:
        T.set_default_tuning(base)
    assert calls == ["lane", "lane"] and _same(planes, got)
    # the accounting covers the shape's large tensors: the emission buffer,
    # the unpacked records and one tile per lane
    slots = TH._emit_cap(cfg.tuning.write_chunk) * cfg.lanes
    assert size >= (4 + 6) * slots + 128 * cfg.tile_d * cfg.lanes
    assert size > pipeline.plan_buffer_size(pipeline.build_plan(T.parse(data)))


def test_auto_resolves_scan_by_scan(test_image, monkeypatch):
    """In one decode of a non-interleaved image, "auto" takes the supertile
    shape for the dense scan and the per-lane shape for the sparse ones."""
    data = _mixed_scans(test_image)
    calls = []
    for name in ("assemble_tiles", "assemble_supertiles"):
        orig = getattr(TW, name)
        monkeypatch.setattr(TW, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    plan, got = _decode(data, _AUTO)
    assert [s.cfg.tile_auto for s in plan.signature.scans] == [
        "super", "lane", "lane"]
    assert calls == ["assemble_supertiles", "assemble_tiles",
                     "assemble_tiles"]
    assert _same(got, golden.decode(data))


def test_lane_wrappers_refuse_other_devices():
    """K7's and K8's wrappers take the plain version for CPU tensors only:
    any other device that is not CUDA is refused; a tile_d past the shared
    memory of a block is refused everywhere."""
    i16 = torch.zeros((8, 64), dtype=torch.int16, device="meta")
    i32 = torch.zeros((8, 64), dtype=torch.int32, device="meta")
    lane = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TW.tiles_from_records(i16, i32, lane, lane, lane.bool(), 32)
    with pytest.raises(ValueError, match="unsupported device"):
        TW.expand_tiles(torch.zeros((64, 32, 64), dtype=torch.int16,
                                    device="meta"), lane, lane[:2], 2)
    with pytest.raises(ValueError, match="tile_d"):
        TW.tiles_from_records(
            torch.zeros((8, 64), dtype=torch.int16),
            torch.zeros((8, 64), dtype=torch.int32),
            torch.zeros(64, dtype=torch.int32),
            torch.zeros(64, dtype=torch.int32),
            torch.ones(64, dtype=torch.bool), 1024)
    assert TW.tiles_from_records.launches == 0
    assert TW.expand_tiles.launches == 0
