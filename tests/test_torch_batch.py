"""PyTorch port, the batched decode (``parallel/batch.py``) on the CPU.

Against the JAX package: one merged batch of two small 4:2:0 images with
restarts, the port's ``BatchDecoder(merged=True)`` against
``jpeggpu_tpu.parallel.BatchDecoder(merged=True)`` on the same bytes (the
only JAX compile of this file, in a module-scoped fixture). Everything
else runs against the port's numpy ``golden``, as counterparts of the JAX
package's ``tests/test_api_batch.py``: groups of one geometry, of mixed
geometry, of mixed stream lengths padded into one plan, tables that
differ, ``merged=False``, restarts, a mesh of CPU devices with padding,
``with_idct=False``, the records write path at merged width in both tile
shapes (also on a padded plan whose tile floors were raised), the int32
limits of a merged decode and the plan floors of
``build_plan(pad_scans=)``. Which route a group took is read from
``BatchDecoder.routes``.

Tolerance: none, every comparison is ``np.array_equal``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import golden, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.ops import huffman as H
from jpeggpu_tpu_torch.parallel import (BatchDecoder, decode_batch,
                                        make_mesh)
from jpeggpu_tpu_torch.parallel import batch as B

import torch_cases

_S420 = [(2, 2), (1, 1), (1, 1)]
_CPU = torch.device("cpu")


def _small(seed, w=48, h=32):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (4, 6, 3)).astype(np.uint8)
    img = np.array(Image.fromarray(base).resize((w, h), Image.BILINEAR))
    return np.clip(img + rng.normal(0, 5, img.shape), 0,
                   255).astype(np.uint8)


def _pair():
    """Two distinct small 4:2:0 images with restarts, of one plan."""
    return [encode(_small(seed), EncodeSpec(sampling=_S420,
                                            restart_interval=2))
            for seed in (1, 2)]


def _assert_golden(datas, out, with_idct=True):
    assert len(out) == len(datas)
    for data, planes in zip(datas, out):
        expect = golden.decode(data, with_idct=with_idct)
        comps = T.parse(data).components
        assert len(planes) == len(expect)
        for a, b, comp in zip(planes, expect, comps):
            # golden's coefficient planes are padded to whole MCUs
            b = b[:comp.size_y, :comp.size_x]
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def pair_batch():
    datas = _pair()
    dec = BatchDecoder(merged=True, device="cpu")
    return datas, dec.decode(datas), dec.routes


def test_merged_batch_matches_reference(pair_batch):
    """The port's merged batch == the JAX package's merged batch on the
    same bytes, plane by plane."""
    from jpeggpu_tpu.parallel import BatchDecoder as JBatchDecoder

    datas, out, routes = pair_batch
    assert routes == [("merged", (0, 1))]
    jdec = JBatchDecoder(merged=True)
    expect = jdec.decode(datas)
    assert any("merged" in str(k) for k in jdec._exec_cache)
    for planes, ref in zip(out, expect):
        assert len(planes) == len(ref) == 3
        for a, b in zip(planes, ref):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def test_merged_batch_matches_golden(pair_batch):
    datas, out, _ = pair_batch
    _assert_golden(datas, out)


def test_batch_same_geometry(test_image):
    datas = [encode(np.roll(test_image, i, axis=0),
                    EncodeSpec(sampling=_S420)) for i in range(3)]
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert [r for r, _ in dec.routes] == ["merged"]
    _assert_golden(datas, out)


def test_batch_mixed_geometry(test_image):
    datas = [
        encode(test_image, EncodeSpec(sampling=_S420)),
        encode(test_image[..., 0]),
        encode(test_image, EncodeSpec(sampling=_S420, quality=40)),
    ]
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert len(out[1]) == 1  # grayscale
    assert sorted(dec.routes) == [("merged", (0, 2)), ("per_image", (1,))]
    _assert_golden(datas, out)


def test_mixed_stream_lengths_share_one_padded_plan():
    """Images of one pixel geometry whose streams differ in length pad up
    to the group's floors and decode as one merged group: each image's
    padded lanes sit inside the merged width, inert."""
    datas = torch_cases.mixed_lengths()
    prelim = [pipeline.build_plan(T.parse(d)).signature.scans[0].cfg
              for d in datas]
    assert len({c.lanes for c in prelim}) > 1  # genuinely different buckets
    assert len({c.super_g for c in prelim}) > 1
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert dec.routes == [("merged", (0, 1, 2))]
    _assert_golden(datas, out)


@pytest.mark.parametrize("tile_mode", ["super", "lane"])
def test_mixed_stream_lengths_records_path(tile_mode):
    """The padded plan of images whose streams differ in length decodes
    exactly through the records write path in both tile shapes: the tile
    floors (tile_d, super_g, super_w, group_du, super_d, tile_auto) are
    raised for some images, and the merged decode reads them."""
    datas = torch_cases.mixed_lengths()
    tuning = T.Tuning(write_mode="tiles", tile_mode=tile_mode)
    base = T.default_tuning()
    T.set_default_tuning(tuning)
    try:
        prelim = [pipeline.build_plan(T.parse(d)).signature.scans[0].cfg
                  for d in datas]
        group, = BatchDecoder(device="cpu")._groups(datas)
        padded = group.plan.signature.scans[0].cfg
        tile_fields = ("tile_d", "super_g", "super_w", "group_du", "super_d")
        assert any(getattr(c, f) != getattr(padded, f)
                   for c in prelim for f in tile_fields)
        dec = BatchDecoder(device="cpu")
        out = dec.decode(datas)
    finally:
        T.set_default_tuning(base)
    assert dec.routes == [("merged", (0, 1, 2))]
    _assert_golden(datas, out)


def test_mixed_size_batch_two_groups(test_image):
    """Two pixel geometries: one merged decode per geometry, whatever the
    images' stream lengths."""
    big = np.kron(test_image, np.ones((2, 2, 1))).astype(np.uint8)
    rng = np.random.default_rng(11)
    datas = [encode(test_image, EncodeSpec(quality=40)),
             encode(test_image, EncodeSpec(quality=95)),
             encode(big, EncodeSpec(quality=40)),
             encode(np.clip(big + rng.integers(-20, 20, big.shape), 0, 255)
                    .astype(np.uint8), EncodeSpec(quality=95))]
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert sorted(dec.routes) == [("merged", (0, 1)), ("merged", (2, 3))]
    _assert_golden(datas, out)


def test_tables_not_shared_decode_per_image():
    """Frequency-optimal Huffman tables of two different images differ: the
    group cannot merge and decodes image by image on its padded plan."""
    datas = [encode(_small(seed), EncodeSpec(sampling=_S420,
                                             optimize_huffman=True))
             for seed in (3, 4)]
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert dec.routes == [("per_image", (0,)), ("per_image", (1,))]
    _assert_golden(datas, out)


def test_merged_false_decodes_per_image():
    datas = _pair()
    dec = BatchDecoder(merged=False, device="cpu")
    out = dec.decode(datas)
    assert dec.routes == [("per_image", (0,)), ("per_image", (1,))]
    _assert_golden(datas, out)


def test_merged_batch_with_restarts(test_image):
    """The same stream three times (identical payloads), restart interval
    2: every segment of every image is one more independent segment of the
    merged decode."""
    data = encode(test_image, EncodeSpec(sampling=_S420, restart_interval=2))
    datas = [data] * 3
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert dec.routes == [("merged", (0, 1, 2))]
    _assert_golden(datas, out)


def test_mesh_batch_pads_and_keeps_order():
    """Three images over a mesh of two CPU devices: padded to four by
    repeating the last, one merged decode per device, planes in input
    order without the padding."""
    datas = _pair() + [encode(_small(5), EncodeSpec(sampling=_S420,
                                                    restart_interval=2))]
    dec = BatchDecoder(mesh=make_mesh(["cpu"] * 2))
    out = dec.decode(datas)
    assert dec.routes == [("mesh_merged", (0, 1)), ("mesh_merged", (2, 2))]
    _assert_golden(datas, out)


def test_with_idct_false_is_coefficient_planes(pair_batch):
    """decode_batch(with_idct=False): int16 coefficient planes with DC
    un-deltaed, == golden's, cropped to component size."""
    datas, _, _ = pair_batch
    out = decode_batch(datas, with_idct=False, device="cpu")
    assert all(p.dtype == np.int16 for planes in out for p in planes)
    _assert_golden(datas, out, with_idct=False)


@pytest.mark.parametrize("tile_mode", ["super", "lane"])
def test_merged_records_path_per_image(pair_batch, tile_mode):
    """The records write path over the whole merged width, in both tile
    shapes: each image's slice of the merged stream and of the DC side
    vector == that image's own single-image decode_scan, and the planes ==
    the default path's."""
    datas, default_planes, _ = pair_batch
    tuning = T.Tuning(write_mode="tiles", tile_mode=tile_mode)
    streams = [T.parse(d) for d in datas]
    pad = pipeline.group_pad([pipeline.build_plan(s, tuning=tuning)
                              for s in streams])
    plans = [pipeline.build_plan(s, tuning=tuning, pad_scans=pad)
             for s in streams]
    assert plans[0].signature == plans[1].signature
    sig = plans[0].signature
    sp, = sig.scans
    inputs = [pipeline.build_inputs(d, p) for d, p in zip(datas, plans)]
    assert B._tables_shared([i["scans"][0] for i in inputs])
    scans, qtables = B.stage_merged(sig, inputs, _CPU)
    coeffs, dc = B._merged_scan_coeffs(sp, scans[0], 2)
    T_ = sp.cfg.total_positions
    tdu = T_ // 64
    assert coeffs.shape == (2 * T_,)
    assert (dc is None) == (tile_mode == "lane")
    for b, inp in enumerate(inputs):
        arrs = pipeline.stage_inputs(inp, plans[b], _CPU)["scans"][0]
        ref, refdc = H.decode_scan(sp.cfg, arrs, return_dc=True)
        assert torch.equal(coeffs[b * T_:(b + 1) * T_], ref)
        if dc is not None:
            assert torch.equal(dc[b * tdu:(b + 1) * tdu], refdc[:tdu])
    # per component [B, size_y, size_x]: image b's planes are index b
    out = B.decode_merged(sig, scans, qtables)
    for b, ref in enumerate(default_planes):
        assert all(np.array_equal(a[b].numpy(), r) for a, r in zip(out, ref))


def test_merged_group_differs_in_quality():
    """Two images of one geometry at quality 50 and 90: the standard
    Huffman tables are shared, so they merge, but each has its own
    quantisation tables, which the group's one K3 call reads per image."""
    datas = [encode(_small(seed), EncodeSpec(sampling=_S420, quality=q))
             for seed, q in ((6, 50), (7, 90))]
    q0, q1 = (T.parse(d).qtables for d in datas)
    assert not np.array_equal(q0, q1)
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert dec.routes == [("merged", (0, 1))]
    _assert_golden(datas, out)


def test_merged_restarts_short_last_segment():
    """Three distinct images whose last restart segment is short (3x2
    MCUs, restart interval 4: segments of 4 and 2): the group's DC
    un-delta restarts at every segment of every image."""
    datas = [encode(_small(seed), EncodeSpec(sampling=_S420,
                                             restart_interval=4))
             for seed in (8, 9, 10)]
    cfg = pipeline.build_plan(T.parse(datas[0])).signature.scans[0].cfg
    assert cfg.total_mcus % cfg.mcus_per_seg
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert dec.routes == [("merged", (0, 1, 2))]
    _assert_golden(datas, out)


def test_batch_planes_c_contiguous():
    """Every plane BatchDecoder.decode returns, on the merged route (a
    slice of its group's copy) and the per-image one, is a C-contiguous
    array of the component's cropped shape."""
    datas = [encode(_small(seed, 44, 30), EncodeSpec(sampling=_S420))
             for seed in (11, 12)]
    datas.append(encode(_small(13, 44, 30)[..., 0]))
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert sorted(dec.routes) == [("merged", (0, 1)), ("per_image", (2,))]
    for data, planes in zip(datas, out):
        comps = T.parse(data).components
        assert len(planes) == len(comps)
        for plane, comp in zip(planes, comps):
            assert plane.dtype == np.uint8
            assert plane.shape == (comp.size_y, comp.size_x)
            assert plane.flags["C_CONTIGUOUS"]
    _assert_golden(datas, out)


def test_k3_covers_the_group_in_one_call(monkeypatch):
    """A merged group of three runs its tail in one K3 call per scan, and
    ``idct_stream_to_planes.images`` counts the three images it covered
    (on the CPU the call runs the plain version)."""
    from jpeggpu_tpu_torch.ops import idct as tidct

    calls = []
    k3 = pipeline.idct_stream_to_planes

    def counted(coeffs, qtables, *args):
        calls.append(tuple(qtables.shape))
        return k3(coeffs, qtables, *args)

    monkeypatch.setattr(pipeline, "idct_stream_to_planes", counted)
    monkeypatch.setattr(tidct.idct_stream_to_planes, "images", 0)
    datas = _pair() + [encode(_small(5), EncodeSpec(sampling=_S420,
                                                    restart_interval=2))]
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert dec.routes == [("merged", (0, 1, 2))]
    assert calls == [(3, 4, 64)]
    assert tidct.idct_stream_to_planes.images == 3
    _assert_golden(datas, out)


def test_merge_scan_inputs_refuses_int32_overflow():
    """A merged decode whose positions (B x T) or bit offsets (B x lanes x
    1024) would pass int32 raises ValueError instead of wrapping."""
    data = _pair()[0]
    plan = pipeline.build_plan(T.parse(data))
    sp, = plan.signature.scans
    per_image = [pipeline.build_inputs(data, plan)["scans"][0]] * 2
    merged = B.merge_region(sp, per_image).arrays()
    assert merged["pos_base"].dtype == merged["pos_bound"].dtype == np.int32
    unit = sp.cfg.du_per_mcu * 64
    big = dataclasses.replace(sp, cfg=dataclasses.replace(
        sp.cfg, total_mcus=-(-2 ** 30 // unit)))
    with pytest.raises(ValueError, match="position"):
        B.merge_region(big, per_image)
    # the bit offsets of the merged width: the decode's context refuses them
    arrs = B.stage_merged(plan.signature, [
        pipeline.build_inputs(data, plan)] * 2, _CPU)[0][0].arrs
    wide = dataclasses.replace(sp.cfg, lanes=2 ** 21)
    with pytest.raises(ValueError, match="bit offsets"):
        H.make_ctx(wide, arrs)


def test_merged_sub_batches(monkeypatch):
    """With the int32 limit lowered to two images' width, a group of three
    merges as two sub-batches; the planes are unchanged."""
    datas = _pair() + [_pair()[0]]
    cfg = pipeline.build_plan(T.parse(datas[0])).signature.scans[0].cfg
    widest = max(cfg.total_positions, cfg.lanes * 1024)
    monkeypatch.setattr(B.C, "I32_MAX", 2 * widest)
    dec = BatchDecoder(device="cpu")
    out = dec.decode(datas)
    assert dec.routes == [("merged", (0, 1)), ("merged", (2,))]
    _assert_golden(datas, out)


def test_build_plan_pad_scans_floors():
    """build_plan(pad_scans=): every floor is honoured (lanes, tile depth,
    window, expand group, supertile depth and raw scan buffer raised,
    supertile group lowered, the per-lane shape taken), a pad below the
    plan's own values changes nothing, and the padded plan decodes
    exactly, with the host destuff and the device destuff."""
    data = _pair()[0]
    stream = T.parse(data)
    own_sp = pipeline.build_plan(stream).signature.scans[0]
    own = own_sp.cfg
    low = pipeline.build_plan(stream, pad_scans=(pipeline.ScanPad(
        lanes=1, tile_d=1, super_g=64, super_w=1, tile_auto="super",
        group_du=1, super_d=1, scan_bytes=1),)).signature.scans[0]
    assert low.cfg == own and low.scan_bytes_padded == own_sp.scan_bytes_padded
    pad = pipeline.ScanPad(lanes=own.lanes + 512, tile_d=own.tile_d + 32,
                           super_g=2, super_w=own.super_w + 3,
                           tile_auto="lane", group_du=own.group_du + 128,
                           super_d=own.super_d + 64,
                           scan_bytes=own_sp.scan_bytes_padded + 4096)
    assert own.super_g > 2 and own.tile_auto == "super"
    plan = pipeline.build_plan(stream, pad_scans=(pad,))
    cfg = plan.signature.scans[0].cfg
    assert (cfg.lanes, cfg.tile_d, cfg.super_g, cfg.super_w, cfg.tile_auto,
            cfg.group_du, cfg.super_d,
            plan.signature.scans[0].scan_bytes_padded) == tuple(pad)
    assert dataclasses.replace(cfg, **{f: getattr(own, f) for f in (
        "lanes", "tile_d", "super_g", "super_w", "tile_auto", "group_du",
        "super_d")}) == own
    _assert_golden([data], [pipeline.decode_jpeg_device(
        data, device="cpu", plan=plan)])
    _assert_golden([data], [pipeline.decode_jpeg_device(
        data, device="cpu", plan=pipeline.build_plan(
            stream, host_destuff=False, pad_scans=(pad,)))])
    # the same floors under the records write path, in both tile shapes
    for tile_mode in ("super", "lane"):
        tiles = pipeline.build_plan(stream, tuning=T.Tuning(
            write_mode="tiles", tile_mode=tile_mode), pad_scans=(pad,))
        tcfg = tiles.signature.scans[0].cfg
        assert (tcfg.lanes, tcfg.tile_d, tcfg.super_g, tcfg.super_w,
                tcfg.tile_auto, tcfg.group_du, tcfg.super_d,
                tiles.signature.scans[0].scan_bytes_padded) == tuple(pad)
        _assert_golden([data], [pipeline.decode_jpeg_device(
            data, device="cpu", plan=tiles)])


def test_group_pad_takes_the_group_floors():
    """group_pad: the largest lane bucket, tile geometry and raw scan
    buffer, the smallest supertile group, "lane" if any image takes it."""
    plans = [pipeline.build_plan(T.parse(d))
             for d in torch_cases.mixed_lengths()]
    cfgs = [p.signature.scans[0].cfg for p in plans]
    raw = [p.signature.scans[0].scan_bytes_padded for p in plans]
    assert len(set(raw)) > 1
    pad, = pipeline.group_pad(plans)
    assert pad == pipeline.ScanPad(
        lanes=max(c.lanes for c in cfgs), tile_d=max(c.tile_d for c in cfgs),
        super_g=min(c.super_g for c in cfgs),
        super_w=max(c.super_w for c in cfgs),
        tile_auto=("lane" if any(c.tile_auto == "lane" for c in cfgs)
                   else "super"),
        group_du=max(c.group_du for c in cfgs),
        super_d=max(c.super_d for c in cfgs), scan_bytes=max(raw))
    lane = [pipeline.build_plan(T.parse(encode(
        np.full((80, 96, 3), 128, np.uint8), EncodeSpec(quality=30))))]
    assert lane[0].signature.scans[0].cfg.tile_auto == "lane"
    assert pipeline.group_pad(lane + lane)[0].tile_auto == "lane"


def test_geometry_key_erases_content_fields():
    plans = [pipeline.build_plan(T.parse(d))
             for d in torch_cases.mixed_lengths()]
    assert plans[0].signature != plans[1].signature
    assert (B._geometry_key(plans[0].signature)
            == B._geometry_key(plans[1].signature))


def test_batch_needs_cuda_without_a_device():
    """device=None means the card: where there is none the batch raises;
    a mesh and a device together are refused."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_batch(_pair())
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchDecoder()
    with pytest.raises(T.InvalidArgument):
        BatchDecoder(mesh=make_mesh(["cpu"]), device="cpu")
