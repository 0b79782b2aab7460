"""PyTorch port, tail of the decode: DC un-delta and kernel K3
(idct_stream_to_planes, one launch per scan on the card, and its
one-component call idct_stream_to_plane) in its plain version on the CPU.

(a) Against the JAX package on one stream (420_rst2 of the shared test
image): the same coefficient stream, DC vector and quantisation table go
through ``jpeggpu_tpu.ops.idct_pallas.idct_stream_to_plane`` with
``dc_override`` (its Pallas kernel in interpret mode, as its own tests run
it on the CPU) for the luma component, and through ``deinterleave`` +
``dequant_idct_plane`` for the chroma components.
(b) Against the numpy golden decoder over a matrix of sampling layouts, from
golden's own coefficient stream, so that the tail is checked alone.
(c) K3's division of a scan into runs (the host's ``stream_runs`` and
``comp_firsts``, read with the kernel's arithmetic) covers every data unit
of the listed components exactly once, at its place in its plane.

Tolerance: none (integer arithmetic), every comparison is
``np.array_equal``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import golden, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.ops import dc as tdc
from jpeggpu_tpu_torch.ops import idct as tidct
from jpeggpu_tpu_torch.ops.transpose import deinterleave

_S420 = [(2, 2), (1, 1), (1, 1)]

LAYOUTS = {
    "420_rst2": dict(sampling=_S420, restart_interval=2),
    "420_rst7": dict(sampling=_S420, restart_interval=7),
    "444": dict(sampling=[(1, 1)] * 3),
    "422": dict(sampling=[(2, 1), (1, 1), (1, 1)]),
    "440": dict(sampling=[(1, 2), (1, 1), (1, 1)]),
    "411_rst3": dict(sampling=[(4, 1), (1, 1), (1, 1)], restart_interval=3),
    "non_interleaved_rst2": dict(sampling=_S420, interleaved=False,
                                 restart_interval=2),
    "q10": dict(quality=10),
}


def _golden_scans(data):
    """Per scan: the plan's geometry and golden's raw coefficient stream."""
    buf = np.frombuffer(data, np.uint8)
    plan = pipeline.build_plan(T.parse(data))
    out = []
    for scan, sp in zip(plan.stream.scans, plan.signature.scans):
        raw = golden.decode_scan_coefficients(plan.stream, scan, buf)
        out.append((scan, sp, raw))
    return plan, out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tail_matches_golden(test_image, name):
    """undelta_dc_values == golden.undelta_dc, and idct_stream_to_plane
    (plain) on the raw stream + DC vector == golden.decode's planes."""
    data = encode(test_image, EncodeSpec(**LAYOUTS[name]))
    plan, scans = _golden_scans(data)
    expect_planes = golden.decode(data)
    qt = torch.from_numpy(plan.stream.qtables.astype(np.int32))
    for scan, sp, raw in scans:
        cfg = sp.cfg
        coeffs = torch.from_numpy(raw.copy())
        comp_slots = tuple((c[1], c[2] * c[3]) for c in sp.comps)
        dcv = tdc.undelta_dc_values(cfg, comp_slots, coeffs)
        undone = raw.copy()
        golden.undelta_dc(plan.stream, scan, undone)
        assert dcv.dtype == torch.int16
        assert np.array_equal(dcv.numpy(), undone[::64])
        assert np.array_equal(
            tdc.undelta_dc(cfg, comp_slots, coeffs).numpy(), undone)
        for c in sp.comps:
            plane = tidct.idct_stream_to_plane(
                coeffs, qt[c[6]], sp.num_mcus_x, sp.num_mcus_y,
                cfg.du_per_mcu, c[1], c[2], c[3], dcv)
            assert plane.dtype == torch.uint8
            assert plane.shape == (c[5], c[4])
            size_x, size_y = plan.signature.comp_sizes[c[0]]
            assert np.array_equal(plane[:size_y, :size_x].numpy(),
                                  expect_planes[c[0]])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_stream_to_planes_matches_golden(test_image, name):
    """idct_stream_to_planes (plain) on the raw stream + DC vector, all the
    components of a scan in one call, == golden.decode's planes."""
    data = encode(test_image, EncodeSpec(**LAYOUTS[name]))
    plan, scans = _golden_scans(data)
    expect_planes = golden.decode(data)
    qt = torch.from_numpy(plan.stream.qtables.astype(np.int32))
    for scan, sp, raw in scans:
        coeffs = torch.from_numpy(raw.copy())
        comp_slots = tuple((c[1], c[2] * c[3]) for c in sp.comps)
        dcv = tdc.undelta_dc_values(sp.cfg, comp_slots, coeffs)
        planes = tidct.idct_stream_to_planes(coeffs, qt, sp.idct_geometry,
                                             sp.cfg.du_per_mcu, dcv)
        assert len(planes) == len(sp.comps)
        for c, plane in zip(sp.comps, planes):
            assert plane.dtype == torch.uint8 and plane.shape == (c[5], c[4])
            size_x, size_y = plan.signature.comp_sizes[c[0]]
            assert np.array_equal(plane[:size_y, :size_x].numpy(),
                                  expect_planes[c[0]])


def _scan_planes_of_group(test_image, batch, with_idct):
    """``batch`` images of one geometry, each its own content and quality
    (so its own quantisation tables), 4:2:0 with restart interval 7: at
    67x45 that is 5x3 MCUs in segments of 7, 7 and 1, so each image's last
    restart segment is short. Returns the scan's plan, per image golden's
    raw stream, its tables and its golden planes (``with_idct``)."""
    datas = [encode(np.roll(test_image, 9 * b, axis=1),
                    EncodeSpec(quality=50 + 10 * b, **LAYOUTS["420_rst7"]))
             for b in range(batch)]
    plan, ((_, sp, _),) = _golden_scans(datas[0])
    assert (sp.cfg.total_mcus, sp.cfg.mcus_per_seg) == (15, 7)
    raws, qts, expect = [], [], []
    for data in datas:
        p, ((_, other, raw),) = _golden_scans(data)
        assert other.idct_geometry == sp.idct_geometry
        raws.append(torch.from_numpy(raw.copy()))
        qts.append(torch.from_numpy(p.stream.qtables.astype(np.int32)))
        expect.append(golden.decode(data, with_idct=with_idct))
    return plan, sp, raws, qts, expect


@pytest.mark.parametrize("with_idct", [True, False])
@pytest.mark.parametrize("dc_from", ["stream", "side_vector"])
@pytest.mark.parametrize("batch", [1, 2, 5])
def test_group_tail_equals_per_image(test_image, batch, dc_from, with_idct):
    """pipeline.scan_planes over B images' streams one after another (a
    merged group's tail: one DC un-delta, then one K3 call or the
    non-fused de-interleave) == scan_planes image by image, bit for bit,
    and == golden's planes. Each image's last restart segment is short, so
    the un-delta restarts at every image boundary; the DC comes from slot 0
    of the stream or from a side vector as the records write path hands it
    over (longer than the group's data units; under K3 the stream's slot 0
    is zeroed, so that it cannot be read instead; the non-fused tail reads
    the stream)."""
    plan, sp, raws, qts, expect = _scan_planes_of_group(test_image, batch,
                                                         with_idct)
    tdu = sp.cfg.total_mcus * sp.cfg.du_per_mcu
    if dc_from == "stream":
        dcds = [None] * batch
        group_dcd = None
    else:
        dcds = [r.view(-1, 64)[:, 0].clone() for r in raws]
        group_dcd = torch.cat(dcds + [torch.full((5,), 999,
                                                 dtype=torch.int16)])
        if with_idct:
            raws = [r.clone() for r in raws]
            for r in raws:
                r.view(-1, 64)[:, 0] = 0
    group = pipeline.scan_planes(sp, torch.cat(raws), group_dcd,
                                 torch.stack(qts), with_idct)
    assert len(group) == len(sp.comps)
    for b in range(batch):
        own = pipeline.scan_planes(sp, raws[b], dcds[b], qts[b], with_idct)
        for c, g, o in zip(sp.comps, group, own):
            assert g.shape == (batch,) + tuple(o.shape) == (batch, c[5], c[4])
            assert g.dtype == o.dtype
            assert torch.equal(g[b], o)
            # golden's coefficient planes are padded to whole MCUs
            size_x, size_y = plan.signature.comp_sizes[c[0]]
            assert np.array_equal(o[:size_y, :size_x].numpy(),
                                  expect[b][c[0]][:size_y, :size_x])
    assert group_dcd is None or tdu * batch < group_dcd.numel()


@pytest.mark.parametrize("mcus_per_seg", [15, 7])
def test_dc_undelta_ops_do_not_depend_on_batch(mcus_per_seg):
    """The group's DC un-delta runs as many tensor ops for 5 images as for
    one, with whole restart segments and with a short last one."""
    from torch.profiler import ProfilerActivity, profile

    from jpeggpu_tpu_torch.ops.huffman import ScanConfig

    cfg = ScanConfig(lanes=256, num_segments=-(-15 // mcus_per_seg),
                     du_per_mcu=6, mcus_per_seg=mcus_per_seg, total_mcus=15,
                     comp_groups=((4, 0, 1), (5, 2, 3), (6, 2, 3)))
    counts = []
    for batch in (1, 5):
        coeffs = torch.zeros(batch * 15 * 6 * 64, dtype=torch.int16)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tdc.undelta_dc_values(cfg, ((0, 4), (4, 1), (5, 1)), coeffs,
                                  batch=batch)
        counts.append(sum(e.cpu_parent is None for e in prof.events()))
    assert counts[0] == counts[1] <= 30


# per layout: data units per MCU and (off, ssx, ssy, qidx) per component
_RUN_GEOMETRIES = {
    "420": (6, ((0, 2, 2, 0), (4, 1, 1, 1), (5, 1, 1, 1))),
    "422": (4, ((0, 2, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1))),
    "440": (4, ((0, 1, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1))),
    "411": (6, ((0, 4, 1, 0), (4, 1, 1, 1), (5, 1, 1, 1))),
    "444": (3, ((0, 1, 1, 0), (1, 1, 1, 1), (2, 1, 1, 2))),
    "gray_or_non_interleaved": (1, ((0, 1, 1, 1),)),
    "420_luma_alone": (6, ((0, 2, 2, 0),)),
    "420_chroma_alone": (6, ((5, 1, 1, 1),)),
    "four_components": (10, ((0, 2, 2, 0), (4, 2, 1, 1), (6, 1, 2, 2),
                             (8, 2, 1, 3))),
}


def _run_units(run, geometry, du_per_mcu):
    """The data units one K3 run transforms, thread by thread, with the
    kernel's arithmetic (``idct_stream.cu``: ``run_at``, ``unit_of``) over
    the host's division (``stream_runs``, ``comp_firsts``): per thread
    (component index, data unit in the stream, block row and block column
    in the component's plane)."""
    num_mcus_x, num_mcus_y, comps = geometry
    run_mcus, per_row, _ = tidct.stream_runs(num_mcus_x, num_mcus_y,
                                             du_per_mcu)
    my, rx = divmod(run, per_row)
    mx0 = rx * run_mcus
    n = min(run_mcus, num_mcus_x - mx0)
    first, units = tidct.comp_firsts(comps)
    out = []
    for tid in range(n * units):
        c = max(j for j in range(len(comps)) if tid >= n * first[j])
        off, ssx, ssy, _ = comps[c]
        sy, bx = divmod(tid - n * first[c], n * ssx)
        mx, sx = divmod(bx, ssx)
        du = mx * du_per_mcu + off + sy * ssx + sx
        out.append((c, (my * num_mcus_x + mx0) * du_per_mcu + du,
                    my * ssy + sy, mx0 * ssx + bx))
    return out


@pytest.mark.parametrize("layout", list(_RUN_GEOMETRIES))
def test_stream_runs_cover_each_unit_once(layout):
    """Every data unit of the listed components is taken by exactly one
    thread of one run, at its de-interleaved place, for MCU rows of 1, R-1,
    R and R+1 MCUs (R: the run length); runs fit one block of RUN_UNITS
    threads and never cross an MCU row."""
    du_per_mcu, comps = _RUN_GEOMETRIES[layout]
    run_mcus = tidct.stream_runs(1, 1, du_per_mcu)[0]
    assert run_mcus * du_per_mcu <= tidct.RUN_UNITS < 2 * run_mcus * du_per_mcu
    num_mcus_y = 3
    for num_mcus_x in (1, run_mcus - 1, run_mcus, run_mcus + 1):
        if num_mcus_x < 1:
            continue
        geometry = (num_mcus_x, num_mcus_y, comps)
        _, per_row, n_runs = tidct.stream_runs(num_mcus_x, num_mcus_y,
                                               du_per_mcu)
        assert n_runs == per_row * num_mcus_y
        seen = {}
        for run in range(n_runs):
            units = _run_units(run, geometry, du_per_mcu)
            assert len(units) <= tidct.RUN_UNITS
            rows = {r // comps[c][2] for c, _, r, _ in units}
            assert len(rows) == 1  # one MCU row
            for c, du, row, col in units:
                assert (c, du) not in seen
                seen[(c, du)] = (row, col)
        expect = {}
        for c, (off, ssx, ssy, _) in enumerate(comps):
            for my in range(num_mcus_y):
                for mx in range(num_mcus_x):
                    for sy in range(ssy):
                        for sx in range(ssx):
                            du = ((my * num_mcus_x + mx) * du_per_mcu + off
                                  + sy * ssx + sx)
                            expect[(c, du)] = (my * ssy + sy, mx * ssx + sx)
        assert seen == expect


def test_dc_wraps_like_int16():
    """The segmented cumsum wraps to int16 as the reference's int16 scan."""
    from jpeggpu_tpu_torch.ops.huffman import ScanConfig

    cfg = ScanConfig(lanes=256, num_segments=2, du_per_mcu=1, mcus_per_seg=3,
                     total_mcus=5, comp_groups=((1, 0, 1),))
    coeffs = torch.zeros(5 * 64, dtype=torch.int16)
    coeffs[::64] = torch.tensor([30000, 30000, 1, 7, -9], dtype=torch.int16)
    got = tdc.undelta_dc_values(cfg, ((0, 1),), coeffs).numpy()
    expect = np.array([30000, 60000 - 65536, 60001 - 65536, 7, -2], np.int16)
    assert np.array_equal(got, expect)


def test_signed_qtable_quirk():
    """Quantisation bytes >= 128 are read as signed int8, as the reference
    kernel reads them; the torch planar IDCT equals the numpy one."""
    from jpeggpu_tpu_torch.idct_int import dequant_idct_blocks

    rng = np.random.default_rng(11)
    plane = rng.integers(-1024, 1024, (16, 24)).astype(np.int16)
    q = rng.integers(1, 256, 64).astype(np.int32)
    q[:4] = (200, 255, 128, 127)
    blocks = plane.astype(np.int32).reshape(2, 8, 3, 8).transpose(0, 2, 1, 3)
    expect = dequant_idct_blocks(np, blocks, q).transpose(0, 2, 1, 3)
    got = tidct.dequant_idct_plane(torch.from_numpy(plane),
                                   torch.from_numpy(q))
    assert np.array_equal(got.numpy(), expect.reshape(16, 24))


# --- against the JAX package ------------------------------------------------

@pytest.fixture(scope="module")
def reference_stream(test_image):
    data = encode(test_image, EncodeSpec(**LAYOUTS["420_rst2"]))
    plan, scans = _golden_scans(data)
    scan, sp, raw = scans[0]
    cfg = sp.cfg
    comp_slots = tuple((c[1], c[2] * c[3]) for c in sp.comps)
    dcv = tdc.undelta_dc_values(cfg, comp_slots, torch.from_numpy(raw.copy()))
    return dict(data=data, plan=plan, sp=sp, raw=raw, dcv=dcv.numpy(),
                comp_slots=comp_slots)


def test_dc_values_match_jax(reference_stream):
    from jpeggpu_tpu.ops.dc import undelta_dc_values
    from jpeggpu_tpu.pipeline import build_plan
    from jpeggpu_tpu.reader import parse

    r = reference_stream
    jcfg = build_plan(parse(r["data"])).signature.scans[0].cfg
    cfg = r["sp"].cfg
    assert (jcfg.du_per_mcu, jcfg.mcus_per_seg, jcfg.total_mcus) == (
        cfg.du_per_mcu, cfg.mcus_per_seg, cfg.total_mcus)
    expect = undelta_dc_values(jcfg, r["comp_slots"], jnp.asarray(r["raw"]))
    assert np.array_equal(r["dcv"], np.asarray(expect))


@pytest.fixture(scope="module")
def jax_planes(reference_stream):
    """The JAX package's planes of the three components: the Pallas kernel
    itself (interpret mode) for luma, ``deinterleave`` +
    ``dequant_idct_plane`` for the chroma components."""
    from jpeggpu_tpu.ops.idct import dequant_idct_plane
    from jpeggpu_tpu.ops.idct_pallas import idct_stream_to_plane
    from jpeggpu_tpu.ops.transpose import deinterleave as jdeinterleave

    r = reference_stream
    sp = r["sp"]
    cfg = sp.cfg
    out = []
    for comp, c in enumerate(sp.comps):
        q = r["plan"].stream.qtables[c[6]].astype(np.int32)
        if comp == 0:
            expect = idct_stream_to_plane(
                jnp.asarray(r["raw"]), jnp.asarray(q), sp.num_mcus_x,
                sp.num_mcus_y, cfg.du_per_mcu, c[1], c[2], c[3],
                dc_override=jnp.asarray(r["dcv"]))
        else:
            spliced = r["raw"].copy()
            spliced[::64] = r["dcv"]

            class _Cfg:
                du_per_mcu = cfg.du_per_mcu

            plane, = jdeinterleave(_Cfg, jnp.asarray(spliced), sp.num_mcus_x,
                                   sp.num_mcus_y, [(c[1], c[2], c[3], 0)])
            expect = dequant_idct_plane(plane, jnp.asarray(q))
        out.append(np.asarray(expect))
    return out


@pytest.mark.parametrize("comp", [0, 1, 2])
def test_stream_to_plane_matches_jax(reference_stream, jax_planes, comp):
    r = reference_stream
    sp = r["sp"]
    cfg = sp.cfg
    c = sp.comps[comp]
    q = r["plan"].stream.qtables[c[6]].astype(np.int32)
    got = tidct.idct_stream_to_plane(
        torch.from_numpy(r["raw"].copy()), torch.from_numpy(q),
        sp.num_mcus_x, sp.num_mcus_y, cfg.du_per_mcu, c[1], c[2], c[3],
        torch.from_numpy(r["dcv"])).numpy()
    assert np.array_equal(got, jax_planes[comp])


def test_stream_to_planes_matches_jax(reference_stream, jax_planes):
    """All three components in one idct_stream_to_planes call (K3's one
    launch per scan on the card) == the JAX package's planes."""
    r = reference_stream
    sp = r["sp"]
    got = tidct.idct_stream_to_planes(
        torch.from_numpy(r["raw"].copy()),
        torch.from_numpy(r["plan"].stream.qtables.astype(np.int32)),
        sp.idct_geometry, sp.cfg.du_per_mcu, torch.from_numpy(r["dcv"]))
    assert len(got) == len(jax_planes) == 3
    for a, b in zip(got, jax_planes):
        assert np.array_equal(a.numpy(), b)


def test_deinterleave_matches_golden(reference_stream):
    r = reference_stream
    sp = r["sp"]
    stream = r["plan"].stream
    expect = golden.deinterleave(stream.scans[0], r["raw"], stream)
    got = deinterleave(torch.from_numpy(r["raw"].copy()), sp.cfg.du_per_mcu,
                       sp.num_mcus_x, sp.num_mcus_y,
                       [(c[1], c[2], c[3]) for c in sp.comps])
    for c, plane in zip(sp.comps, got):
        assert np.array_equal(plane.numpy(), expect[c[0]])
