"""PyTorch port, the host staging (``jpeggpu_tpu_torch/staging.py``) on the
CPU.

Each scan's arrays lie in one region of a host buffer and reach the device
in one copy, as views of it: those views equal, in dtype, shape,
contiguity and value, one copy per array of the same host arrays (the
staging before the region). The native pass (destuff, zero padding and
byte swap at once) equals the numpy destuffer word for word, whatever the
buffer held before. A decoder's buffer is allocated once and reused: its
counter ``staging.host_allocs`` moves only for a larger image, and
``staging.h2d_copies`` counts at most two copies a scan. Decoders reused
over images of several sizes, and ``decode_batch`` of mixed images, give
planes equal to the port's numpy ``golden``. No JAX. Tolerance: none.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import api, convert, golden, native, pipeline, staging
from jpeggpu_tpu_torch.parallel import BatchDecoder, decode_batch

_CPU = torch.device("cpu")
SAMPLINGS = {"420": 2, "422": 1, "444": 0, "gray": None}


def _pixels(seed, w, h, gray=False):
    """A smooth field with noise: every Huffman code length in play, few
    enough symbols for the plain decode."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (x * rng.integers(1, 5) + y * rng.integers(1, 5)) % 256
    img = np.stack([base, 255 - base, (base * 3) % 256], -1)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    return Image.fromarray(img[..., 0] if gray else img)


def pil_stream(sampling, rst, optimize, seed=0, w=72, h=40, quality=85):
    im = _pixels(seed, w, h, sampling == "gray")
    opts = dict(quality=quality, optimize=optimize)
    if SAMPLINGS[sampling] is not None:
        opts["subsampling"] = SAMPLINGS[sampling]
    if rst:
        opts["restart_marker_rows"] = 1
    out = io.BytesIO()
    im.save(out, "JPEG", **opts)
    return out.getvalue()


MATRIX = [(s, r, o) for s in SAMPLINGS for r in (False, True)
          for o in (False, True)]


def _ids(case):
    s, r, o = case
    return f"{s}-{'rst' if r else 'norst'}-{'opt' if o else 'std'}"


def _per_array(a):
    """One copy of one host array, as the staging did before regions."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a).to(_CPU)


def _assert_same(name, got, want):
    assert got.dtype == want.dtype, name
    assert got.shape == want.shape, name
    assert got.is_contiguous(), name
    assert torch.equal(got, want), name


@pytest.mark.parametrize("case", MATRIX, ids=_ids)
def test_region_views_equal_per_array_copies(case):
    data = pil_stream(*case)
    plan = pipeline.build_plan(T.parse(data))
    stg = staging.HostStaging(_CPU)
    stg.begin()
    inputs = pipeline.build_inputs(data, plan, stg)
    copies = staging.h2d_copies
    staged = pipeline.stage_inputs(inputs, plan, _CPU)
    assert staging.h2d_copies - copies == len(plan.signature.scans) + 1
    for s, sp, arrs in zip(inputs["scans"], plan.signature.scans,
                           staged["scans"]):
        for name, a in s.items():
            _assert_same(name, getattr(arrs, name), _per_array(a))
        symtab = convert.symbol_table(s["maxcode"], s["vsm"], s["huffval"],
                                      sp.cfg.fast_tables)
        _assert_same("symtab", arrs.symtab, torch.tensor(symtab))
        # the device tensors are views of one copy of the region
        base = arrs.words.untyped_storage().data_ptr()
        for name in ("seg_of_subseq", "maxcode", "huffval", "symtab"):
            assert getattr(arrs, name).untyped_storage().data_ptr() == base
    _assert_same("qtables", staged["qtables"], _per_array(inputs["qtables"]))
    # the same host arrays staged without a decoder's buffer
    alone = pipeline.stage_inputs(pipeline.build_inputs(data, plan), plan,
                                  _CPU)
    for a, b in zip(alone["scans"], staged["scans"]):
        for name in ("words", "seg_first_lane", "vsm", "symtab"):
            _assert_same(name, getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("case", MATRIX[::3], ids=_ids)
def test_device_destuff_scans_in_one_region(case):
    """Under ``host_destuff=False`` the raw body and the segment offsets go
    in the scan's region too, equal to one copy each."""
    data = pil_stream(*case)
    plan = pipeline.build_plan(T.parse(data), host_destuff=False)
    inputs = pipeline.build_inputs(data, plan)
    staged = pipeline.stage_inputs(inputs, plan, _CPU)
    for s, arrs in zip(inputs["scans"], staged["scans"]):
        assert arrs.words is None
        for name in ("raw", "seg_sub_offset", "seg_of_subseq", "huffval"):
            _assert_same(name, getattr(arrs, name), _per_array(s[name]))
    planes = api.Decoder(device="cpu", host_destuff=False)
    planes.parse_header(data)
    for a, b in zip(planes.decode(), golden.decode(data)):
        assert np.array_equal(a, b)


def _numpy_words(data, scan, lanes):
    body = golden.destuff_scan_host(np.frombuffer(data, np.uint8), scan)
    words = np.zeros(lanes * 32, np.uint32)
    be = np.frombuffer(body.tobytes(), ">u4")
    words[:len(be)] = be
    return words


def _big_rst_stream():
    """Over 256 KB of entropy-coded data in 32 restart segments."""
    im = _pixels(7, 1024, 512)
    noise = np.random.default_rng(7).integers(0, 256, (512, 1024, 3))
    im = Image.fromarray(((np.asarray(im) // 2) + noise // 2).astype(np.uint8))
    out = io.BytesIO()
    im.save(out, "JPEG", quality=95, subsampling=2, restart_marker_rows=1)
    return out.getvalue()


@pytest.mark.parametrize("fill", [0, 0xA5A5A5A5, 0xFFFFFFFF])
@pytest.mark.parametrize("case", [("420", True, False), ("444", False, True),
                                  ("gray", True, True), "big"],
                         ids=["420-rst", "444-opt", "gray-rst-opt", "big"])
def test_native_pass_equals_numpy_destuffer(case, fill):
    data = _big_rst_stream() if case == "big" else pil_stream(*case)
    assert native.get_lib() is not None
    buf = np.frombuffer(data, np.uint8)
    for scan, sp in zip(T.parse(data).scans,
                        pipeline.build_plan(T.parse(data)).signature.scans):
        lanes = sp.cfg.lanes
        if case == "big":
            assert scan.end - scan.begin > 2 << 17 and scan.num_segments > 8
        # a reused buffer holds anything: the pass writes all of it
        out = np.full(lanes * 32, fill, np.uint32)
        assert native.destuff_words(buf[scan.begin:scan.end],
                                    scan.segments[:, 0],
                                    scan.num_subsequences, scan.seg_raw, out)
        assert np.array_equal(out, _numpy_words(data, scan, lanes))


def test_native_pass_refuses_a_short_buffer():
    data = pil_stream("420", True, False)
    scan, = T.parse(data).scans
    with pytest.raises(ValueError, match="uint32"):
        native.destuff_words(np.frombuffer(data, np.uint8), scan.segments[:, 0],
                             scan.num_subsequences, scan.seg_raw,
                             np.zeros(scan.num_subsequences * 32 - 1,
                                      np.uint32))


def test_host_allocs_move_only_for_a_larger_image():
    small = pil_stream("420", True, False, seed=1, w=64, h=48)
    same = pil_stream("420", True, False, seed=2, w=64, h=48)
    smaller = pil_stream("420", False, False, seed=3, w=32, h=16)
    larger = pil_stream("420", True, False, seed=4, w=512, h=384,
                        quality=95)
    d = api.Decoder(device="cpu")
    moved = []
    for data in (small, same, small, smaller, larger, larger, small):
        allocs = staging.host_allocs
        d.parse_header(data)
        d.transfer()
        moved.append(staging.host_allocs - allocs)
    assert moved == [1, 0, 0, 0, 1, 0, 0]


@pytest.mark.parametrize("case", MATRIX[::2], ids=_ids)
def test_at_most_two_copies_a_scan(case):
    data = pil_stream(*case)
    d = api.Decoder(device="cpu")
    d.parse_header(data)
    copies = staging.h2d_copies
    d.transfer()
    scans = len(d._plan.signature.scans)
    assert staging.h2d_copies - copies <= 2 * scans
    # a merged group: one region a scan and one for the tables
    other = pil_stream(*case, seed=5)
    dec = BatchDecoder(device="cpu")
    copies = staging.h2d_copies
    out = dec.decode([data, other])
    assert dec.routes == [("merged", (0, 1))]
    assert staging.h2d_copies - copies <= 2 * scans
    for image, planes in zip((data, other), out):
        for a, b in zip(planes, golden.decode(image)):
            assert np.array_equal(a, b)


def test_decoder_reused_over_sizes_equals_golden():
    images = [pil_stream(s, r, o, seed=k, w=w, h=h)
              for k, (s, r, o, w, h) in enumerate([
                  ("420", True, False, 96, 64), ("422", False, True, 40, 24),
                  ("gray", True, False, 128, 80),
                  ("420", False, True, 96, 64), ("444", True, True, 40, 24),
                  ("gray", False, False, 128, 80)])]
    d = api.Decoder(device="cpu")
    for data in images:
        d.parse_header(data)
        d.transfer()
        for a, b in zip(d.decode(), golden.decode(data)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    d.cleanup()
    d.parse_header(images[0])
    for a, b in zip(d.decode(), golden.decode(images[0])):
        assert np.array_equal(a, b)


def test_decode_batch_of_mixed_images_equals_golden():
    datas = [pil_stream("420", True, False, seed=k) for k in range(3)]
    datas += [pil_stream("444", False, True, seed=3, w=40, h=24),
              pil_stream("gray", True, False, seed=4, w=56, h=32),
              pil_stream("422", True, True, seed=5, w=48, h=16)]
    out = decode_batch(datas, device="cpu")
    for data, planes in zip(datas, out):
        for a, b in zip(planes, golden.decode(data)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
