"""PyTorch port, the rest of the five-phase Decoder API on the CPU: the
device destuff (``Decoder(host_destuff=False)``), ``decode_into``,
``decode(donate=True)``, the debug cross-checks, ``profile_trace`` and the
decode tool.

Against the JAX package: ``ops.destuff.destuff_scan`` of both packages and
the port's host destuffer on every stream of the bit-exact matrix
(``torch_cases.matrix_streams``), from the same bytes and the same staged
state (the only JAX work of this file: one jit of the JAX destuff per
shape, no pipeline compile). Everything else runs against the port's numpy
``golden``, as counterparts of the JAX package's ``tests/test_api_batch.py``
and ``tests/test_robustness.py``.

Tolerance: none, every comparison is ``np.array_equal``.
"""

import contextlib
import gc
import io
import json
import struct
import weakref
import zlib

import numpy as np
import pytest
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import debug, decode_tool, golden, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.ops import destuff as destuff_mod
from jpeggpu_tpu_torch.ops import huffman as H
from jpeggpu_tpu_torch.parallel import BatchDecoder, make_mesh
from jpeggpu_tpu_torch.parallel import batch as B
from jpeggpu_tpu_torch.parallel import segments
from jpeggpu_tpu_torch.parallel.segments import decode_sharded
from jpeggpu_tpu_torch.utils.color import to_rgb

import torch_cases

_S420 = [(2, 2), (1, 1), (1, 1)]


@pytest.fixture(scope="module")
def streams(test_image, noise_image):
    out = dict(torch_cases.matrix_streams(test_image, noise_image))
    assert sorted(out) == sorted(torch_cases.MATRIX_NAMES)
    return out


@pytest.fixture(scope="module")
def jax_destuff():
    import jax
    from jpeggpu_tpu.ops.destuff import destuff_scan

    return jax.jit(destuff_scan, static_argnums=2)


@pytest.fixture(scope="module")
def data_420_rst2(test_image):
    return encode(test_image, EncodeSpec(sampling=_S420, restart_interval=2))


def _assert_golden(data, planes, with_idct=True):
    expect = golden.decode(data, with_idct=with_idct)
    comps = T.parse(data).components
    assert len(planes) == len(expect)
    for a, b, c in zip(planes, expect, comps):
        b = b[:c.size_y, :c.size_x]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


# --- the device destuff -----------------------------------------------------

@pytest.mark.parametrize("name", torch_cases.MATRIX_NAMES)
def test_destuff_scan_matches_jax_and_host(streams, jax_destuff, name):
    """ops.destuff.destuff_scan == the JAX destuff_scan == the host
    destuffer, word for word, on every scan of every matrix stream; the
    port stages the same raw buffer and segment offsets as the JAX
    package's build_inputs(host_destuff=False)."""
    from jpeggpu_tpu import pipeline as jpipeline

    data = streams[name]
    buf = np.frombuffer(data, np.uint8)
    plan = pipeline.build_plan(T.parse(data), host_destuff=False)
    inputs = pipeline.build_inputs(data, plan)
    jplan = jpipeline.build_plan(jpipeline.parse(data), host_destuff=False)
    jinputs = jpipeline.build_inputs(data, jplan)
    for si, (scan, sp) in enumerate(zip(plan.stream.scans,
                                        plan.signature.scans)):
        inp, jinp = inputs["scans"][si], jinputs["scans"][si]
        assert "words" not in inp
        assert (sp.scan_bytes_padded, sp.num_segments_padded, sp.cfg.lanes) \
            == (jplan.signature.scans[si].scan_bytes_padded,
                jplan.signature.scans[si].num_segments_padded,
                jplan.signature.scans[si].cfg.lanes)
        for key in ("raw", "seg_sub_offset"):
            assert np.array_equal(inp[key], jinp[key])
        got = destuff_mod.destuff_scan(
            torch.from_numpy(inp["raw"]),
            torch.from_numpy(inp["seg_sub_offset"]), sp.cfg.lanes)
        assert got.dtype == torch.int32
        got = got.numpy().view(np.uint32)
        ref = np.asarray(jax_destuff(jinp["raw"], jinp["seg_sub_offset"],
                                     sp.cfg.lanes))
        host = pipeline._destuff_host(buf, scan, sp.cfg.lanes)
        assert np.array_equal(got, ref)
        assert np.array_equal(got, host)


@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 70000])
def test_segment_base_is_the_running_maximum(n):
    """The destuff's two-level running maximum == torch.cummax of the
    marked byte counts, at lengths below, at and past its row of 1024."""
    rng = np.random.default_rng(n)
    is_rst = torch.from_numpy(rng.random(n) < 0.01)
    data_cum = torch.from_numpy(
        np.cumsum(rng.integers(0, 2, n)).astype(np.int32))
    assert torch.equal(destuff_mod._segment_base(data_cum, is_rst),
                       torch.cummax(data_cum * is_rst, 0).values)


@pytest.mark.parametrize("name", torch_cases.CASES)
def test_decoder_device_destuff_matches_golden(test_image, name):
    """Decoder(host_destuff=False) decodes every stream of the entropy
    tests' matrix exactly, pixels and coefficient planes."""
    data = torch_cases.case_data(name, test_image)
    with T.Decoder(device="cpu", host_destuff=False) as d:
        d.parse_header(data)
        assert not any(sp.host_destuff for sp in d._plan.signature.scans)
        d.transfer()
        staged = d._device_inputs["scans"]
        assert all(s.words is None and s.raw.dtype == torch.uint8
                   for s in staged)
        _assert_golden(data, d.decode())
        _assert_golden(data, d.decode(with_idct=False), with_idct=False)


def test_device_destuff_records_path(data_420_rst2):
    """A plan with host_destuff=False under Tuning(write_mode="tiles"): the
    records write path decodes the device-destuffed words exactly."""
    plan = pipeline.build_plan(T.parse(data_420_rst2),
                               tuning=T.Tuning(write_mode="tiles"),
                               host_destuff=False)
    _assert_golden(data_420_rst2, pipeline.decode_jpeg_device(
        data_420_rst2, device="cpu", plan=plan))


def test_buffer_size_counts_the_raw_scan(data_420_rst2):
    """get_buffer_size with the device destuff: the host destuff's size
    plus the raw buffer, the segment table and the destuff's temporaries
    (24 bytes per raw byte at its widest) and its one extra byte."""
    sizes = {}
    for host in (True, False):
        with T.Decoder(device="cpu", host_destuff=host) as d:
            d.parse_header(data_420_rst2)
            sizes[host] = d.get_buffer_size()
            sp, = d._plan.signature.scans
    assert sizes[False] - sizes[True] == (
        25 * sp.scan_bytes_padded + 4 * sp.num_segments_padded + 1)


def test_device_destuff_batch_grouping_unchanged():
    """Plans with host_destuff=False of images of one geometry whose
    streams differ in length: their raw buffers differ, the geometry key
    erases that, and group_pad's floor gives them one padded plan, as with
    the host destuff; the padded plan decodes exactly. The batch itself
    keeps its routes."""
    datas = torch_cases.mixed_lengths()
    for host in (True, False):
        plans = [pipeline.build_plan(T.parse(d), host_destuff=host)
                 for d in datas]
        assert len({p.signature.scans[0].scan_bytes_padded
                    for p in plans}) > 1
        assert len({B._geometry_key(p.signature) for p in plans}) == 1
        pad = pipeline.group_pad(plans)
        padded = {pipeline.build_plan(p.stream, host_destuff=host,
                                      pad_scans=pad).signature for p in plans}
        assert len(padded) == 1
    plan = pipeline.build_plan(T.parse(datas[0]), host_destuff=False,
                               pad_scans=pad)
    assert plan.signature.scans[0].scan_bytes_padded > len(datas[0])
    _assert_golden(datas[0], pipeline.decode_jpeg_device(
        datas[0], device="cpu", plan=plan))
    assert [g.indices for g in BatchDecoder(device="cpu")._groups(datas)] \
        == [[0, 1, 2]]


def test_merge_refuses_raw_scans(data_420_rst2):
    """The merged decode takes host-destuffed scans only, as in the JAX
    package."""
    plan = pipeline.build_plan(T.parse(data_420_rst2), host_destuff=False)
    inputs = pipeline.build_inputs(data_420_rst2, plan)
    with pytest.raises(ValueError, match="host_destuff"):
        B.merge_region(plan.signature.scans[0], [inputs["scans"][0]] * 2)


# --- decode_into ------------------------------------------------------------

@pytest.mark.parametrize("with_idct", [True, False], ids=["uint8", "int16"])
def test_decode_into_pitched_planes(test_image, data_420_rst2, with_idct):
    """decode_into writes each plane into the top-left corner of the
    caller's larger tensor and leaves every element past it as it was; it
    returns the caller's tensors (same storage) and takes the next image
    into the same memory."""
    dtype = torch.uint8 if with_idct else torch.int16
    sentinel = 77 if with_idct else -1234
    other = encode(test_image[::-1].copy(), EncodeSpec(sampling=_S420))
    with T.Decoder(device="cpu", host_destuff=False) as d:
        info = d.parse_header(data_420_rst2)
        outs = [torch.full((sy + 3, sx + 5), sentinel, dtype=dtype)
                for sx, sy in zip(info.sizes_x, info.sizes_y)]
        ptrs = [o.data_ptr() for o in outs]
        for data in (data_420_rst2, other):
            info = d.parse_header(data)
            got = d.decode_into(outs, with_idct=with_idct)
            assert [g.data_ptr() for g in got] == ptrs
            assert all(g is o for g, o in zip(got, outs))
            planes = []
            for g, sx, sy in zip(got, info.sizes_x, info.sizes_y):
                tail = torch.cat([g[:sy, sx:].reshape(-1),
                                  g[sy:, :].reshape(-1)])
                assert bool((tail == sentinel).all())
                planes.append(g[:sy, :sx].numpy())
            _assert_golden(data, planes, with_idct)


@pytest.mark.parametrize("case", ["count", "dtype", "device", "rank",
                                  "pitch", "rows", "not_a_tensor"])
def test_decode_into_refuses(data_420_rst2, case):
    """decode_into validates count, dtype, device, rank and extent (the
    pitch rule of decoder.cpp:336-353) before any work: InvalidArgument."""
    with T.Decoder(device="cpu") as d:
        info = d.parse_header(data_420_rst2)
        sizes = list(zip(info.sizes_y, info.sizes_x))
        outs = [torch.zeros(s, dtype=torch.uint8) for s in sizes]
        if case == "count":
            outs = outs[:2]
        elif case == "dtype":
            outs[1] = outs[1].to(torch.int16)
        elif case == "device":
            outs[0] = torch.zeros(sizes[0], dtype=torch.uint8, device="meta")
        elif case == "rank":
            outs[2] = outs[2].reshape(-1)
        elif case == "pitch":
            outs[0] = torch.zeros((sizes[0][0], sizes[0][1] - 1),
                                  dtype=torch.uint8)
        elif case == "rows":
            outs[1] = torch.zeros((sizes[1][0] - 1, sizes[1][1]),
                                  dtype=torch.uint8)
        else:
            outs[0] = np.zeros(sizes[0], np.uint8)
        with pytest.raises(T.InvalidArgument):
            d.decode_into(outs)
        assert d._device_inputs is None  # refused before staging


# --- donate -----------------------------------------------------------------

@pytest.mark.parametrize("host_destuff", [True, False],
                         ids=["host_destuff", "device_destuff"])
def test_donate_frees_the_staged_inputs(data_420_rst2, host_destuff):
    """decode(donate=True): the planes are right, the handle and the
    pipeline let go of the staged inputs (the words, or the raw bytes, are
    freed), and the next decode restages and is right."""
    with T.Decoder(device="cpu", host_destuff=host_destuff) as d:
        d.parse_header(data_420_rst2)
        d.transfer()
        s = d._device_inputs["scans"][0]
        held = weakref.ref(s.words if host_destuff else s.raw)
        del s
        _assert_golden(data_420_rst2, d.decode(donate=True))
        gc.collect()
        assert held() is None
        assert d._device_inputs is None
        _assert_golden(data_420_rst2, d.decode())
        assert d._device_inputs is not None
        _assert_golden(data_420_rst2, d.decode(donate=True, with_idct=False),
                       with_idct=False)


# --- debug mode -------------------------------------------------------------

@pytest.fixture
def debug_on():
    debug.set_debug(True)
    try:
        yield
    finally:
        debug.set_debug(False)


@pytest.mark.parametrize("name", ["420_rst2", "non_interleaved",
                                  "four_component", "saturated_table"])
def test_debug_mode_checks_pass(test_image, debug_on, name):
    """Debug mode on streams of at most 2 MP: the segment tables, the
    device destuff against the host's, golden and the sync-state
    invariants all hold, and the planes are right."""
    data = torch_cases.case_data(name, test_image)
    logged = []
    with T.Decoder(device="cpu", host_destuff=False) as d:
        d.set_logging(True)
        d._log = logged.append
        d.parse_header(data)
        _assert_golden(data, d.decode())
    assert "debug: segment tables consistent" in logged
    assert "debug: scan 0 device destuff matches host" in logged
    assert "debug: device output matches golden CPU decoder" in logged
    assert "debug: sync-state numeric invariants hold" in logged


def test_debug_destuff_cross_check_fires(data_420_rst2, debug_on,
                                         monkeypatch):
    """The debug device-vs-host destuff comparison raises InternalError,
    naming the destuff, the scan and the first word, when the device
    destuff is corrupted."""
    good = destuff_mod.destuff_scan

    def corrupted(raw, seg_sub_offset, lanes):
        words = good(raw, seg_sub_offset, lanes).clone()
        words[3] ^= 0xDEAD
        return words

    monkeypatch.setattr(destuff_mod, "destuff_scan", corrupted)
    with T.Decoder(device="cpu", host_destuff=False) as d:
        d.parse_header(data_420_rst2)
        with pytest.raises(T.InternalError,
                           match=r"destuff.*scan 0, first word 3"):
            d.decode()


def test_debug_sync_invariants_fire(data_420_rst2, monkeypatch):
    """The sync-state sanitizer passes on clean states and raises
    InternalError when they are corrupted (the zig-zag index pushed outside
    the data unit)."""
    real_sync = H.sync_states

    def corrupted(cfg, arrs, ctx, *a, **k):
        p, c, z, n = real_sync(cfg, arrs, ctx, *a, **k)
        return p, c, z + 64, n

    d = T.Decoder(device="cpu")
    d.parse_header(data_420_rst2)
    d._sync_invariant_checks()
    monkeypatch.setattr(H, "sync_states", corrupted)
    with pytest.raises(T.InternalError, match="zig-zag"):
        d._sync_invariant_checks()
    d.cleanup()


def test_debug_golden_compare_fires(data_420_rst2, debug_on, monkeypatch):
    """A plane that differs from golden raises InternalError in debug
    mode, and decodes silently with debug off."""
    real = pipeline.crop

    def off_by_one(signature, planes):
        out = real(signature, planes)
        return (out[0] + 1,) + out[1:]

    monkeypatch.setattr(pipeline, "crop", off_by_one)
    with T.Decoder(device="cpu") as d:
        d.parse_header(data_420_rst2)
        with pytest.raises(T.InternalError, match="golden"):
            d.decode()
        debug.set_debug(False)
        assert len(d.decode()) == 3


# --- profile_trace ----------------------------------------------------------

def test_profile_trace_names_the_stages(tmp_path, test_image):
    """profile_trace writes a Chrome trace into its directory holding the
    jpeggpu.* ranges of the decodes inside it, which stay exact: the
    device destuff, sync, write, DC and fused IDCT; the non-fused tail's
    de-interleave."""
    gray = encode(test_image[:16, :16, 0], EncodeSpec(restart_interval=1))
    with debug.profile_trace(str(tmp_path)):
        with T.Decoder(device="cpu", host_destuff=False) as d:
            d.parse_header(gray)
            _assert_golden(gray, d.decode())
            _assert_golden(gray, d.decode(with_idct=False), with_idct=False)
    trace, = tmp_path.glob("*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    for name in ("jpeggpu.destuff", "jpeggpu.sync", "jpeggpu.write.fused",
                 "jpeggpu.dc", "jpeggpu.idct_fused", "jpeggpu.deinterleave"):
        assert name in names


def test_sharded_tail_scopes(test_image, monkeypatch):
    """The sharded decode's tail runs inside jpeggpu.dc,
    jpeggpu.deinterleave and jpeggpu.idct ranges, and stays exact."""
    seen = []

    @contextlib.contextmanager
    def recording(name, device):
        seen.append(name)
        with debug.scope(name, device):
            yield

    monkeypatch.setattr(segments, "scope", recording)
    gray = encode(test_image[:16, :16, 0], EncodeSpec(restart_interval=1))
    _assert_golden(gray, decode_sharded(gray, make_mesh(["cpu"] * 2)))
    assert {"jpeggpu.dc", "jpeggpu.deinterleave", "jpeggpu.idct"} \
        <= set(seen)


# --- decode_tool ------------------------------------------------------------

def _png_image(path):
    """The pixels of an 8-bit PNG of one IDAT chunk, filter 0 per row."""
    blob = path.read_bytes()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, pos = {}, 8
    while pos < len(blob):
        (n,), kind = struct.unpack(">I", blob[pos:pos + 4]), blob[pos + 4:
                                                                 pos + 8]
        body = blob[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])[0] \
            == zlib.crc32(kind + body)
        chunks[kind] = body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and color == 2 and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def _run_tool(*argv):
    """decode_tool.main(argv): its exit code and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = decode_tool.main([str(a) for a in argv])
    return rc, out.getvalue()


def test_decode_tool_writes_the_png(tmp_path, data_420_rst2):
    """python -m jpeggpu_tpu_torch.decode_tool in.jpg out.png --device cpu:
    exit 0, and the PNG's pixels are to_rgb of golden's planes; --info
    stops after the header; --planes writes golden's planes as .npy."""
    src = tmp_path / "in.jpg"
    src.write_bytes(data_420_rst2)
    out = tmp_path / "out.png"
    rc, printed = _run_tool(src, out, "--device", "cpu", "--logging")
    assert rc == 0 and f"wrote {out}" in printed and "marker SOS" in printed
    info = T.parse(data_420_rst2)
    sampling = [(c.ss_x, c.ss_y) for c in info.components]
    expect = to_rgb(golden.decode(data_420_rst2), sampling)
    assert np.array_equal(_png_image(out), expect)

    rc, printed = _run_tool(src, "--info", "--device", "cpu")
    assert rc == 0 and "67x45, 3 component(s)" in printed
    assert "decoded" not in printed
    rc, _ = _run_tool(src, out, "--planes", "--device", "cpu")
    assert rc == 0
    for i, plane in enumerate(golden.decode(data_420_rst2)):
        assert np.array_equal(np.load(f"{out}.plane{i}.npy"), plane)
