"""PyTorch port, tail of the decode: DC un-delta and kernel K3
(idct_stream_to_plane) in its plain version on the CPU.

(a) Against the JAX package on one stream (420_rst2 of the shared test
image): the same coefficient stream, DC vector and quantisation table go
through ``jpeggpu_tpu.ops.idct_pallas.idct_stream_to_plane`` with
``dc_override`` (its Pallas kernel in interpret mode, as its own tests run
it on the CPU) for the luma component, and through ``deinterleave`` +
``dequant_idct_plane`` for the chroma components.
(b) Against the numpy golden decoder over a matrix of sampling layouts, from
golden's own coefficient stream, so that the tail is checked alone.

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


@pytest.mark.parametrize("comp", [0, 1, 2])
def test_stream_to_plane_matches_jax(reference_stream, comp):
    from jpeggpu_tpu.ops.idct import dequant_idct_plane
    from jpeggpu_tpu.ops.idct_pallas import idct_stream_to_plane
    from jpeggpu_tpu.ops.transpose import deinterleave as jdeinterleave

    r = reference_stream
    sp = r["sp"]
    cfg = sp.cfg
    c = sp.comps[comp]
    q = r["plan"].stream.qtables[c[6]].astype(np.int32)
    got = tidct.idct_stream_to_plane(
        torch.from_numpy(r["raw"].copy()), torch.from_numpy(q),
        sp.num_mcus_x, sp.num_mcus_y, cfg.du_per_mcu, c[1], c[2], c[3],
        torch.from_numpy(r["dcv"])).numpy()
    if comp == 0:
        # the Pallas kernel itself, in interpret mode
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
    assert np.array_equal(got, np.asarray(expect))


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
