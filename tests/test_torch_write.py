"""PyTorch port, the records write path (``Tuning(write_mode="tiles")``):
kernels K4 (decode_write_emit), K5 (supertiles_from_records) and K6
(expand_supertiles) in their plain versions on the CPU, and the tensor code
around them, stage by stage against the JAX package.

The JAX side runs as its own tests run it on the CPU: the emission through
its XLA loop and through its Pallas kernel in interpret mode (one jitted
function, compiled once per module), the assembly eagerly with its Pallas
kernels in interpret mode. The inputs and outputs of the JAX assembly's two
kernels are captured while it runs, so each port stage is fed exactly what
the JAX stage was fed. Arrays cross as numpy through ``convert``.

Records are compared *compacted* (per lane, the real slots in order): the
JAX decoder may leave inert holes between committed slots, the port's
records are dense, and the contract both hold to is "slot real iff
``s < m[l]`` and ``local_pos >= 0``".

Tolerance: none, every comparison is ``np.array_equal``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import constants as C
from jpeggpu_tpu_torch import convert, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.ops import dc as tdc
from jpeggpu_tpu_torch.ops import huffman as TH
from jpeggpu_tpu_torch.ops import write as TW

_S420 = [(2, 2), (1, 1), (1, 1)]
_TILES = T.Tuning(write_mode="tiles", tile_mode="super")


@pytest.fixture(scope="module")
def port_stage(test_image):
    """The port's decode of 420_rst2 up to the write stage, and both write
    stages' results."""
    data = encode(test_image, EncodeSpec(sampling=_S420, restart_interval=2))
    plan = pipeline.build_plan(T.parse(data), tuning=_TILES)
    inputs = pipeline.build_inputs(data, plan)
    sp = plan.signature.scans[0]
    cfg = sp.cfg
    arrs = convert.scan_arrays(inputs["scans"][0], "cpu", cfg.fast_tables)
    ctx = TH.make_ctx(cfg, arrs)
    p, c, z, n = TH.sync_states(cfg, arrs, ctx)
    n_off = TH.symbol_offsets(cfg, arrs, n)
    rec, m = TH.decode_write_emit(cfg, arrs, ctx, p, c, z, n_off)
    pos0 = arrs.seg_of_subseq * cfg.positions_per_seg + n_off
    return dict(data=data, plan=plan, inputs=inputs, sp=sp, cfg=cfg,
                arrs=arrs, ctx=ctx, states=(p, c, z, n_off), rec=rec, m=m,
                pos0=pos0,
                fused=TH.decode_write(cfg, arrs, ctx, p, c, z, n_off))


@pytest.fixture(scope="module")
def jax_stage(port_stage):
    """The JAX package's records path on the same staged state and the
    same converged states: ``(rec, m)`` from both of its emitters, and the
    assembly's result with the arguments and results of its two kernels."""
    from jpeggpu_tpu.config import Tuning as JTuning
    from jpeggpu_tpu.ops import huffman as JH
    from jpeggpu_tpu.ops import write_pallas as WP
    from jpeggpu_tpu.pipeline import build_plan
    from jpeggpu_tpu.reader import parse

    s = port_stage
    jcfg = build_plan(parse(s["data"]), tuning=JTuning(
        write_mode="tiles", tile_mode="super")).signature.scans[0].cfg
    jcfg_pallas = dataclasses.replace(jcfg, tuning=dataclasses.replace(
        jcfg.tuning, entropy_backend="pallas"))
    inp = s["inputs"]["scans"][0]
    states = [x.numpy() for x in s["states"]]

    def emit(inp, p, c, z, n_off):
        arrs = JH.ScanArrays(
            words=inp["words"], seg_of_subseq=inp["seg_of_subseq"],
            seg_first_lane=inp["seg_first_lane"],
            seg_num_subseq=inp["seg_num_subseq"], maxcode=inp["maxcode"],
            vsm=inp["vsm"], huffval=inp["huffval"])
        out = []
        for cfg in (jcfg, jcfg_pallas):
            ctx = JH.make_ctx(cfg, arrs)
            out.extend(JH.decode_write_emit(cfg, arrs, ctx, p, c, z, n_off))
        return out

    args = (inp, *states)
    rec_x, m_x, rec_p, m_p = [
        np.asarray(x) for x in jax.jit(emit).lower(*args).compile()(*args)]

    captured = {}
    orig_stage1, orig_expand = WP.supertiles_from_records, WP.expand_supertiles

    def stage1(val_rows, pk_rows, mmax_st, G, **kw):
        out = orig_stage1(val_rows, pk_rows, mmax_st, G, **kw)
        captured["stage1"] = (np.asarray(val_rows), np.asarray(pk_rows),
                              np.asarray(mmax_st), G, kw["super_d"],
                              np.asarray(out))
        return out

    def expand(stiles, base, q, n_groups, W, **kw):
        out = orig_expand(stiles, base, q, n_groups, W, **kw)
        captured["expand"] = (np.asarray(stiles), np.asarray(base),
                              np.asarray(q), n_groups, W, kw["group_du"],
                              np.asarray(out[0]), np.asarray(out[1]))
        return out

    pos0 = s["pos0"].numpy()
    WP.supertiles_from_records, WP.expand_supertiles = stage1, expand
    try:
        coeffs, dc = WP.assemble_supertiles(
            jnp.asarray(rec_x), jnp.asarray(m_x), jnp.asarray(pos0 >> 6),
            jnp.asarray(pos0), jcfg.total_positions, jcfg.super_g,
            jcfg.super_w, s_trim=jcfg.tuning.s_trim, dot="bf16",
            expand_dot="f32", return_dc=True, group_du=jcfg.group_du,
            super_d=jcfg.super_d)
    finally:
        WP.supertiles_from_records, WP.expand_supertiles = (orig_stage1,
                                                            orig_expand)
    return dict(cfg=jcfg, emit={"xla": (rec_x, m_x), "pallas": (rec_p, m_p)},
                coeffs=np.asarray(coeffs), dc=np.asarray(dc), **captured)


def _compacted(rec: np.ndarray, m: np.ndarray):
    """Per-lane counts of real slots, and the real records lane by lane in
    slot order."""
    wl = (rec << 16) >> 16
    real = (np.arange(rec.shape[0])[:, None] < m[None, :]) & (wl >= 0)
    return real.sum(axis=0), rec.T[real.T]


def test_plan_geometry_matches_jax(port_stage, jax_stage):
    """build_plan's supertile geometry and the emission capacity equal the
    reference's."""
    from jpeggpu_tpu.ops import huffman as JH

    cfg, jcfg = port_stage["cfg"], jax_stage["cfg"]
    for k in convert.GEOMETRY_FIELDS:
        assert getattr(cfg, k) == getattr(jcfg, k), k
    assert convert.scan_config(
        {**{k: getattr(jcfg, k) for k in convert.GEOMETRY_FIELDS},
         "tuning": jcfg.tuning}) == cfg
    for chunk in (1, 64, 256, 1000):
        assert TH._emit_cap(chunk) == JH._emit_cap(chunk)
    assert TH._REC_INERT == JH._REC_INERT


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_emit_records_match_jax(port_stage, jax_stage, backend):
    """K4's plain version emits, lane by lane, the records the JAX emitters
    commit; its ``m`` is the lane's count of real slots."""
    rec, m = convert.to_numpy((port_stage["rec"], port_stage["m"]))
    jrec, jm = jax_stage["emit"][backend]
    assert rec.shape == jrec.shape and rec.dtype == jrec.dtype == np.int32
    counts, flat = _compacted(rec, m)
    jcounts, jflat = _compacted(jrec, jm)
    assert np.array_equal(counts, jcounts)
    assert np.array_equal(flat, jflat)
    assert flat.size > 1000
    # dense: m is the count itself, and unreached slots are inert
    assert np.array_equal(m, jcounts)
    assert np.all(rec[np.arange(rec.shape[0])[:, None] >= m[None, :]]
                  == TH._REC_INERT)


def test_supertiles_match_jax(jax_stage):
    val_rows, pk_rows, mmax_st, G, super_d, expect = jax_stage["stage1"]
    got = TW.supertiles_from_records(
        *convert.to_torch((val_rows, pk_rows, mmax_st)), G, super_d)
    assert got.dtype == torch.int16 and expect.dtype == np.int16
    assert np.array_equal(got.numpy(), expect)
    assert expect.any()


def test_expand_matches_jax(jax_stage):
    (stiles, base, q, n_groups, W, group_du, rows,
     dc_cols) = jax_stage["expand"]
    got_rows, got_dc = TW.expand_supertiles(
        *convert.to_torch((stiles, base, q)), n_groups, W, group_du)
    assert np.array_equal(got_rows.numpy(), rows)
    # the reference's side output is 8 columns wide; column 0 is the DC
    assert np.array_equal(got_dc.numpy(), dc_cols[:, 0])
    assert rows.any()


def test_assemble_on_jax_records_matches_jax(port_stage, jax_stage):
    """The port's assembly fed the JAX emitter's ``(rec, m)`` (holes and
    all) gives the JAX assembly's coefficients and DC side vector."""
    s, cfg = port_stage, port_stage["cfg"]
    rec, m = convert.to_torch(jax_stage["emit"]["xla"])
    coeffs, dc = TW.assemble_supertiles(
        rec, m, s["pos0"] >> 6, s["pos0"], cfg.total_positions, cfg.super_g,
        cfg.super_w, s_trim=cfg.tuning.s_trim, return_dc=True,
        group_du=cfg.group_du, super_d=cfg.super_d)
    assert np.array_equal(coeffs.numpy(), jax_stage["coeffs"])
    assert np.array_equal(dc.numpy(), jax_stage["dc"])


@pytest.mark.parametrize("s_trim", [256, 128])
def test_assemble_on_own_records_matches_direct_write(port_stage, jax_stage,
                                                      s_trim):
    """The records path on the port's own records equals the direct
    writing decode (K2's plain version) and the JAX assembly, with the
    default trim and with a trim that sends lanes to the leftover scatter."""
    s, cfg = port_stage, port_stage["cfg"]
    coeffs, dc = TW.assemble_supertiles(
        s["rec"], s["m"], s["pos0"] >> 6, s["pos0"], cfg.total_positions,
        cfg.super_g, cfg.super_w, s_trim=s_trim, return_dc=True,
        group_du=cfg.group_du, super_d=cfg.super_d)
    assert (TW.scatter_leftover.lanes > 0) == (s_trim == 128)
    assert np.array_equal(coeffs.numpy(), s["fused"].numpy())
    assert np.array_equal(coeffs.numpy(), jax_stage["coeffs"])
    total_du = cfg.total_positions // 64
    assert np.array_equal(dc.numpy()[:total_du], s["fused"].numpy()[::64])


def test_undelta_dc_values_from_side_vector(port_stage):
    """undelta_dc_values(dc=side vector) == undelta_dc_values(coeffs), and
    equals the JAX function on the same side vector."""
    from jpeggpu_tpu.ops import dc as jdc

    s, cfg = port_stage, port_stage["cfg"]
    _, dc = TW.decode_write_tiles(cfg, s["arrs"], s["ctx"], *s["states"],
                                  return_dc=True)
    comp_slots = tuple((k[1], k[2] * k[3]) for k in s["sp"].comps)
    from_stream = tdc.undelta_dc_values(cfg, comp_slots, s["fused"])
    from_side = tdc.undelta_dc_values(cfg, comp_slots, dc=dc)
    assert dc.numel() > from_side.numel() == cfg.total_positions // 64
    assert np.array_equal(from_side.numpy(), from_stream.numpy())
    expect = jdc.undelta_dc_values(cfg, comp_slots, dc=jnp.asarray(dc.numpy()))
    assert np.array_equal(from_side.numpy(), np.asarray(expect))


@pytest.mark.parametrize("val,wl", [
    (0, 0), (1, 1), (-1, -1), (32767, 32767), (-32768, -32768),
    (-32768, 32767), (32767, -1), (0, -1), (255, 256), (-129, 12345)])
def test_pack_unpack_round_trip(val, wl):
    """pack_record / unpack_record keep both int16 halves at the extremes,
    and pack as the reference packs."""
    from jpeggpu_tpu.ops import huffman as JH

    v = torch.tensor([val], dtype=torch.int32)
    w = torch.tensor([wl], dtype=torch.int32)
    rec = TH.pack_record(v, w)
    assert rec.dtype == torch.int32
    got_v, got_w = TH.unpack_record(rec)
    assert (int(got_v), int(got_w)) == (val, wl)
    expect = JH.pack_record(jnp.asarray([val], jnp.int32),
                            jnp.asarray([wl], jnp.int32))
    assert int(rec) == int(expect[0])
    if (val, wl) == (0, -1):
        assert int(rec) == TH._REC_INERT


def _records_rows(records, n_st, S, G):
    """(st, slot, lane in group, value, d_rel, iz) -> val_rows, pk_rows."""
    val = np.zeros((n_st, S * G), np.int16)
    pk = np.full((n_st, S * G), -1, np.int16)
    for st, s, g, v, d, iz in records:
        val[st, s * G + g] = v
        pk[st, s * G + g] = (d << 6) | iz
    return val, pk


def test_supertiles_zero_record_on_live_cell():
    """A value-0 record (an EOB run's position, say) that names a cell
    another lane of the group really writes leaves that value alone;
    records naming one cell sum; slots at and past mmax_st are not read;
    the column order is natural[zig-zag]."""
    from jpeggpu_tpu.ops import write_pallas as WP

    n_st, S, G, D = 8, 128, 2, 16
    records = [
        (0, 0, 0, 1234, 3, 5),   # lane 0 writes cell (3, zig-zag 5)
        (0, 1, 1, 0, 3, 5),      # lane 1's zero record names the same cell
        (0, 0, 1, -77, 0, 63),
        (0, 2, 0, 9, 15, 1),
        (1, 4, 1, 100, 2, 2),
        (1, 5, 0, 23, 2, 2),     # two nonzero records, one cell: they sum
        (2, 7, 0, 555, 1, 1),    # slot 7 >= mmax_st[2] = 7: not read
        (2, 6, 1, -32768, 1, 7),
    ]
    val, pk = _records_rows(records, n_st, S, G)
    mmax = np.array([[3], [6], [7], [0], [0], [0], [0], [0]], np.int32)
    got = TW.supertiles_from_records(*convert.to_torch((val, pk, mmax)), G,
                                     D).numpy()
    nat = C.ORDER_NATURAL
    expect = np.zeros((n_st, D, 64), np.int16)
    expect[0, 3, nat[5]] = 1234
    expect[0, 0, nat[63]] = -77
    expect[0, 15, nat[1]] = 9
    expect[1, 2, nat[2]] = 123
    expect[2, 1, nat[7]] = -32768
    assert np.array_equal(got, expect)
    assert nat[5] != 5  # a swapped permutation would show
    # the reference agrees wherever it reads (it rounds mmax_st up to whole
    # 128-slot rounds, so its supertile 2 holds the slot-7 record too)
    ref = np.asarray(WP.supertiles_from_records(
        jnp.asarray(val), jnp.asarray(pk), jnp.asarray(mmax), G,
        dot="bf16", super_d=D))
    expect[2, 1, nat[1]] = 555
    assert np.array_equal(ref, expect)


def test_expand_shared_cells_extremes():
    """Rows shared by several supertiles sum, at int16 extremes: the
    synthetic supertiles of the reference's own expand test, against the
    reference's exact (f32) expand."""
    from jpeggpu_tpu.ops import write_pallas as WP

    rng = np.random.default_rng(3)
    n_st, D = 8, 128
    # sums stay within int16 (up to 8 overlapping rows x 4088)
    moderate = np.array([-4088, -4087, -256, -255, -129, -128, -127, -1,
                         0, 1, 127, 128, 255, 256, 4086, 4087], np.int64)
    stiles = rng.permuted(np.resize(moderate, n_st * D * 64)).reshape(
        n_st, D, 64).astype(np.int16)
    # heavy overlap: consecutive supertiles only 16 data units apart
    base = np.arange(n_st, dtype=np.int32) * 16
    # output rows 0..15 are covered by supertile 0 alone: full-range values
    extremes = np.array([-32768, -32767, -129, -128, -127, -1, 0, 1, 127,
                         128, 255, 256, 32766, 32767, -256, 257], np.int64)
    stiles[0, :16, :] = np.resize(extremes, (16, 64)).astype(np.int16)
    n_groups = 2
    q = np.zeros(n_groups, np.int32)
    rows, dc = TW.expand_supertiles(*convert.to_torch((stiles, base, q)),
                                    n_groups, n_st, 128)
    ref_rows, ref_dc = WP.expand_supertiles(
        jnp.asarray(stiles), jnp.asarray(base), jnp.asarray(q), n_groups,
        n_st, dot="f32")
    assert np.array_equal(rows.numpy(), np.asarray(ref_rows))
    assert np.array_equal(dc.numpy(), np.asarray(ref_dc)[:, 0])
    assert np.array_equal(dc.numpy(), rows.numpy()[:, 0])
    # row 20 lies in supertiles 0 and 1
    expect = stiles[0, 20].astype(np.int32) + stiles[1, 4].astype(np.int32)
    assert np.array_equal(rows.numpy()[20], expect.astype(np.int16))


def test_expand_window_never_leaves_the_supertiles():
    """A window position outside [0, n_st) contributes nothing (no
    re-fetch, no double sum), and sums past int16 wrap."""
    n_st, D = 3, 8
    stiles = np.full((n_st, D, 64), 30000, np.int16)
    base = np.array([0, 0, 4], np.int32)
    q = np.array([-1, 2], np.int32)
    rows, dc = TW.expand_supertiles(*convert.to_torch((stiles, base, q)),
                                    2, 3, 8)
    # group 0 (rows 0..7) sees supertiles 0 and 1 (position -1 is outside)
    assert np.all(rows.numpy()[:8] == np.int16(60000 - 65536))
    # group 1 (rows 8..15) sees supertile 2 alone: its rows 4..7
    assert np.all(rows.numpy()[8:12] == 30000)
    assert np.all(rows.numpy()[12:] == 0)
    assert np.array_equal(dc.numpy(), rows.numpy()[:, 0])


def test_super_slab_clips_to_the_supertiles():
    base = torch.tensor([0, 10, 20, 30], dtype=torch.int32)
    max_du = torch.tensor([9, 19, 29, 39], dtype=torch.int32)
    include = torch.tensor([True, True, False, True])
    q = TW._super_slab(base, max_du, include, 1, 5, 2, 8)
    # thresholds 0, 8, 16, 24, 32 against reach 9, 19, 19, 39
    assert q.dtype == torch.int32 and q.tolist() == [0, 0, 1, 2, 2]


def test_records_wrappers_refuse_other_devices():
    meta16 = torch.zeros((8, 256), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TW.supertiles_from_records(meta16, meta16, torch.zeros(
            (8, 1), dtype=torch.int32, device="meta"), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        TW.expand_supertiles(
            torch.zeros((8, 128, 64), dtype=torch.int16, device="meta"),
            torch.zeros(8, dtype=torch.int32), torch.zeros(
                2, dtype=torch.int32), 2, 4)
    assert TW.supertiles_from_records.launches == 0
    assert TW.expand_supertiles.launches == 0
    assert TH.decode_write_emit.launches == 0


@pytest.mark.parametrize("kwargs", [
    dict(write_mode="scatter"), dict(write_mode="matmul"),
    dict(tile_mode="wide"), dict(group_du=100),
    dict(group_du=-128), dict(super_g=3), dict(super_g=-2), dict(super_d=12),
    dict(super_w=-1), dict(write_chunk=0), dict(s_trim=0), dict(s_trim=200)])
def test_tuning_validation(kwargs):
    """Tuning refuses what the reference's Tuning refuses, with the same
    message for the fields both have. The reference's TPU write modes
    "scatter" and "matmul" are refused, by ``Tuning`` and by
    ``convert.tuning`` of a reference tuning that names them."""
    from jpeggpu_tpu.config import Tuning as JTuning

    with pytest.raises(ValueError) as port_err:
        T.Tuning(**kwargs)
    if "write_mode" in kwargs:  # the reference has more modes
        assert "write_mode must be auto|fused|tiles" in str(port_err.value)
        with pytest.raises(ValueError, match=r"auto\|fused\|tiles"):
            convert.tuning(JTuning(**kwargs))
        return
    with pytest.raises(ValueError) as ref_err:
        JTuning(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


def test_tuning_defaults_and_process_default():
    from jpeggpu_tpu_torch import config

    t = T.Tuning()
    assert (t.write_mode, t.tile_mode, t.s_trim, t.write_chunk) == (
        "fused", "auto", 256, 256)
    assert T.default_tuning() == t
    try:
        T.set_default_tuning(_TILES)
        assert config.default_tuning() is _TILES
    finally:
        T.set_default_tuning(t)
    # a reference tuning converts field by field; its default write_mode
    # "auto" passes through and resolves to "fused" in the plan
    from jpeggpu_tpu.config import Tuning as JTuning

    assert convert.tuning(JTuning(write_mode="tiles", tile_mode="super",
                                  s_trim=128)) == T.Tuning(
        write_mode="tiles", tile_mode="super", s_trim=128)
    ref_default = convert.tuning(JTuning())
    assert ref_default.write_mode == "auto"
    cfg = TH.ScanConfig(lanes=256, num_segments=1, du_per_mcu=6,
                        mcus_per_seg=1, total_mcus=1, comp_groups=(),
                        tuning=ref_default)
    assert cfg.tuning == dataclasses.replace(ref_default, write_mode="fused")


def test_write_mode_auto(port_stage, monkeypatch):
    """Tuning(write_mode="auto"), the reference's default, resolves to the
    direct write once, where the plan is built: every scan's config holds
    "fused", the decode equals golden and the default path, and the write
    stage runs K2 (one call, counted here through its plain version) and
    none of K4."""
    calls = {"decode_write": 0, "decode_write_emit": 0}

    def counting(name):
        plain = getattr(TH, f"{name}_plain")

        def run(*args, **kwargs):
            calls[name] += 1
            return plain(*args, **kwargs)
        return run

    for name in calls:
        monkeypatch.setattr(TH, f"{name}_plain", counting(name))
    data = port_stage["data"]
    plan = pipeline.build_plan(T.parse(data),
                               tuning=T.Tuning(write_mode="auto"))
    assert all(sp.cfg.tuning.write_mode == "fused"
               for sp in plan.signature.scans)
    planes = pipeline.decode_jpeg_device(data, device="cpu", plan=plan)
    assert calls == {"decode_write": len(plan.signature.scans),
                     "decode_write_emit": 0}
    for got, expect, default in zip(planes, T.golden.decode(data),
                                    T.decode(data, device="cpu")):
        assert np.array_equal(got, expect)
        assert np.array_equal(got, default)
