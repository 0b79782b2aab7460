"""PyTorch port, the slice as a whole on the CPU: the public entry points
against the JAX package's one-image decode, the five-phase Decoder, the
state conversion, and what the package promises about its imports and its
device.

Tolerance: none (integer pipeline), every comparison is ``np.array_equal``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import convert, golden, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode

import torch_cases

_S420 = [(2, 2), (1, 1), (1, 1)]


@pytest.fixture(scope="module")
def data_420_rst2(test_image):
    return encode(test_image, EncodeSpec(sampling=_S420, restart_interval=2))


@pytest.fixture(scope="module")
def port_planes(data_420_rst2):
    return T.decode(data_420_rst2, device="cpu")


def test_decode_matches_jax_pipeline(test_image, data_420_rst2, port_planes):
    """jpeggpu_tpu_torch.decode == jpeggpu_tpu.pipeline.decode_jpeg_device,
    bit for bit, on the stream the JAX package's own bit-exactness test
    uses."""
    from jpeggpu_tpu.encoder import EncodeSpec as JSpec
    from jpeggpu_tpu.encoder import encode as jencode
    from jpeggpu_tpu.pipeline import decode_jpeg_device

    # both packages' encoders make the same bytes from the same image
    assert data_420_rst2 == jencode(
        test_image, JSpec(sampling=_S420, restart_interval=2))
    expect = decode_jpeg_device(data_420_rst2)
    assert len(expect) == len(port_planes) == 3
    for a, b in zip(expect, port_planes):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        assert np.array_equal(a, b)


_TILES = T.Tuning(write_mode="tiles", tile_mode="super")


def test_tiles_decode_matches_jax_pipeline(data_420_rst2, port_planes):
    """The records write path through the normal entry point, under a plan
    built with Tuning(write_mode="tiles"): equal to the JAX pipeline under
    the same tuning (its Pallas kernels in interpret mode), to the default
    path and to golden."""
    from jpeggpu_tpu.config import Tuning as JTuning
    from jpeggpu_tpu.pipeline import build_plan, decode_jpeg_device
    from jpeggpu_tpu.reader import parse

    plan = pipeline.build_plan(T.parse(data_420_rst2), tuning=_TILES)
    assert plan.signature.scans[0].cfg.tuning == _TILES
    got = pipeline.decode_jpeg_device(data_420_rst2, device="cpu", plan=plan)
    expect = decode_jpeg_device(data_420_rst2, plan=build_plan(
        parse(data_420_rst2),
        tuning=JTuning(write_mode="tiles", tile_mode="super")))
    assert len(got) == len(expect) == 3
    for a, b, c, d in zip(expect, got, port_planes,
                          golden.decode(data_420_rst2)):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        assert np.array_equal(a, b)
        assert np.array_equal(b, c) and np.array_equal(b, d)


def test_default_tuning_reaches_the_decoder(data_420_rst2, port_planes):
    """The process default travels in the plans that Decoder and decode
    build: api.decode takes no tuning argument, as in the JAX package."""
    base = T.default_tuning()
    assert base.write_mode == "fused"
    try:
        T.set_default_tuning(_TILES)
        with T.Decoder(device="cpu") as d:
            d.parse_header(data_420_rst2)
            assert d._plan.signature.scans[0].cfg.tuning == _TILES
            assert d.get_buffer_size() > 0
            planes = d.decode()
        one_shot = T.decode(data_420_rst2, device="cpu")
    finally:
        T.set_default_tuning(base)
    for a, b, c in zip(planes, one_shot, port_planes):
        assert np.array_equal(a, c) and np.array_equal(b, c)
    plan = pipeline.build_plan(T.parse(data_420_rst2))
    assert plan.signature.scans[0].cfg.tuning == base
    tiles = pipeline.build_plan(T.parse(data_420_rst2), tuning=_TILES)
    assert pipeline.plan_buffer_size(tiles) > pipeline.plan_buffer_size(plan)


def test_per_lane_tile_shape_builds_and_decodes(data_420_rst2, port_planes):
    """tile_mode="lane", and an "auto" that resolves to it on a sparse
    scan, build a plan and decode to golden. The default write mode is
    untouched by tile_mode."""
    lane = T.Tuning(write_mode="tiles", tile_mode="lane")
    plan = pipeline.build_plan(T.parse(data_420_rst2), tuning=lane)
    cfg = plan.signature.scans[0].cfg
    assert (cfg.tuning, cfg.tile_auto, cfg.tile_d) == (lane, "super", 64)
    got = pipeline.decode_jpeg_device(data_420_rst2, device="cpu", plan=plan)
    assert all(np.array_equal(a, b) for a, b in zip(got, port_planes))
    flat = encode(np.full((128, 136), 130, np.uint8), EncodeSpec(quality=50))
    stream = T.parse(flat)
    auto = pipeline.build_plan(stream, tuning=T.Tuning(write_mode="tiles"))
    assert auto.signature.scans[0].cfg.tile_auto == "lane"
    got = pipeline.decode_jpeg_device(flat, device="cpu", plan=auto)
    assert all(np.array_equal(a, b)
               for a, b in zip(got, golden.decode(flat)))
    plan = pipeline.build_plan(stream, tuning=T.Tuning(tile_mode="lane"))
    assert plan.signature.scans[0].cfg.tile_auto == "lane"
    got = pipeline.decode_jpeg_device(flat, device="cpu", plan=plan)
    assert all(np.array_equal(a, b)
               for a, b in zip(got, golden.decode(flat)))


@pytest.mark.parametrize("mode", ["auto", "super", "lane"])
@pytest.mark.parametrize("auto_choice", ["super", "lane"])
def test_resolve_tile_mode_matches_reference(mode, auto_choice):
    from jpeggpu_tpu.ops import write_pallas as WP
    from jpeggpu_tpu_torch.ops import write as TW

    got = TW.resolve_tile_mode(mode, auto_choice)
    assert got == WP.resolve_tile_mode(mode, auto_choice)
    assert got == (auto_choice if mode == "auto" else mode)
    if auto_choice == "super":  # the default of both
        assert TW.resolve_tile_mode(mode) == WP.resolve_tile_mode(mode)


def test_decode_matches_golden(data_420_rst2, port_planes):
    for a, b in zip(golden.decode(data_420_rst2), port_planes):
        assert np.array_equal(a, b)


def test_decode_jpeg_device_matches_decode(data_420_rst2, port_planes):
    out = pipeline.decode_jpeg_device(data_420_rst2, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(out, port_planes))


def test_decoder_phases(data_420_rst2, port_planes):
    """parse_header / get_buffer_size / transfer / decode, on one handle,
    twice (the handle is reusable)."""
    with T.Decoder(device="cpu") as d:
        for _ in range(2):
            info = d.parse_header(data_420_rst2)
            assert info.num_components == 3
            assert info.sizes_x == [67, 34, 34] and info.sizes_y == [45, 23, 23]
            assert info.subsampling == [(2, 2), (1, 1), (1, 1)]
            assert not T.is_css_444(info.subsampling, info.num_components)
            size = d.get_buffer_size()
            d.transfer()
            planes = d.decode(device=True)
            assert all(isinstance(p, torch.Tensor) for p in planes)
            assert all(np.array_equal(a.numpy(), b)
                       for a, b in zip(planes, port_planes))
            # the plan's accounting covers what the decode really holds
            held = sum(t.numel() * t.element_size() for s in
                       d._device_inputs["scans"] for t in vars(s).values()
                       if isinstance(t, torch.Tensor))
            cfg = d._plan.signature.scans[0].cfg
            assert size >= held + 2 * cfg.total_positions
    with pytest.raises(T.InvalidArgument):
        T.Decoder(device="cpu").decode()


def test_decoder_device_true_returns_tensors_on_its_device(data_420_rst2,
                                                          port_planes):
    """decode(device=True), the JAX package's keyword: the planes stay
    tensors on the decoder's device, the same planes as the numpy ones."""
    with T.Decoder(device="cpu") as d:
        d.parse_header(data_420_rst2)
        planes = d.decode(device=True)
        host = d.decode()
    assert all(isinstance(p, torch.Tensor) and p.device == torch.device("cpu")
               and p.dtype == torch.uint8 for p in planes)
    assert all(isinstance(p, np.ndarray) for p in host)
    assert all(np.array_equal(a.numpy(), b) and np.array_equal(c, b)
               for a, c, b in zip(planes, host, port_planes))


@pytest.mark.parametrize("name", torch_cases.CASES)
def test_with_idct_false_matches_golden(test_image, name):
    """Decoder.decode(with_idct=False) and decode_jpeg_device(with_idct=
    False): int16 coefficient planes (DC un-deltaed, the reference's
    non-fused tail) == golden's, cropped to component size, on every stream
    of the entropy tests' matrix."""
    data = torch_cases.case_data(name, test_image)
    comps = T.parse(data).components
    expect = [g[:c.size_y, :c.size_x]
              for g, c in zip(golden.decode(data, with_idct=False), comps)]
    with T.Decoder(device="cpu") as d:
        d.parse_header(data)
        got = d.decode(with_idct=False)
    for out in (got, pipeline.decode_jpeg_device(data, device="cpu",
                                                 with_idct=False)):
        assert len(out) == len(expect)
        for a, b in zip(out, expect):
            assert a.dtype == b.dtype == np.int16 and a.shape == b.shape
            assert np.array_equal(a, b)


def test_decoder_keep_on_device_is_gone(data_420_rst2):
    """The port's old keep_on_device keyword is not the JAX package's, and
    is refused like any other unknown keyword."""
    with T.Decoder(device="cpu") as d:
        d.parse_header(data_420_rst2)
        with pytest.raises(TypeError):
            d.decode(keep_on_device=True)


def test_decode_rgb(test_image, data_420_rst2):
    rgb = T.decode_rgb(data_420_rst2, device="cpu")
    assert rgb.shape == test_image.shape and rgb.dtype == np.uint8
    err = np.abs(rgb.astype(np.int32) - test_image.astype(np.int32))
    assert err.mean() < 8  # lossy codec at quality 85 with 4:2:0 chroma


def test_no_device_argument_needs_cuda(data_420_rst2):
    """device=None means the card: where there is none the entry points
    raise, they do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for call in (lambda: T.decode(data_420_rst2),
                 lambda: T.decode_rgb(data_420_rst2),
                 lambda: T.Decoder(),
                 lambda: pipeline.decode_jpeg_device(data_420_rst2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_import_without_jax_triton_or_nvcc():
    """The package and every module of it import with jax, the JAX package
    and triton blocked, and without building anything."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'jpeggpu_tpu', 'triton'):\n"
        "    sys.modules[m] = None\n"
        "import jpeggpu_tpu_torch as T\n"
        "import jpeggpu_tpu_torch.api, jpeggpu_tpu_torch.pipeline\n"
        "import jpeggpu_tpu_torch.convert, jpeggpu_tpu_torch.kernels\n"
        "import jpeggpu_tpu_torch.ops.huffman, jpeggpu_tpu_torch.ops.idct\n"
        "import jpeggpu_tpu_torch.ops.dc, jpeggpu_tpu_torch.ops.transpose\n"
        "import jpeggpu_tpu_torch.golden, jpeggpu_tpu_torch.encoder\n"
        "import jpeggpu_tpu_torch.native, jpeggpu_tpu_torch.utils.color\n"
        "import jpeggpu_tpu_torch.config, jpeggpu_tpu_torch.ops.write\n"
        "import jpeggpu_tpu_torch.parallel, jpeggpu_tpu_torch.parallel.segments\n"
        "import jpeggpu_tpu_torch.parallel.collectives\n"
        "import jpeggpu_tpu_torch.parallel.batch\n"
        "import jpeggpu_tpu_torch.parallel.multihost\n"
        "import jpeggpu_tpu_torch.parallel.weakscale\n"
        "import jpeggpu_tpu_torch.ops.destuff, jpeggpu_tpu_torch.debug\n"
        "import jpeggpu_tpu_torch.decode_tool\n"
        "assert not jpeggpu_tpu_torch.kernels._functions\n"
        "assert sorted(T.__all__) == sorted(set(T.__all__))\n"
        "assert all(hasattr(T, n) for n in T.__all__)\n"
        "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"


def test_convert_round_trip(data_420_rst2):
    """from_reference_inputs keeps every value: geometry in, ScanConfig
    out; numpy arrays in, the same numbers on the device out (the uint32
    word stream as its int32 bit patterns)."""
    plan = pipeline.build_plan(T.parse(data_420_rst2))
    inputs = pipeline.build_inputs(data_420_rst2, plan)
    sp = plan.signature.scans[0]
    geometry = {k: getattr(sp.cfg, k) for k in convert.GEOMETRY_FIELDS}
    cfg, arrs, q = convert.from_reference_inputs(
        geometry, inputs["scans"][0], inputs["qtables"], "cpu")
    assert cfg == sp.cfg
    for name, src in inputs["scans"][0].items():
        got = getattr(arrs, name)
        assert got.dtype == torch.int32
        back = got.numpy().reshape(src.shape)
        if src.dtype == np.uint32:
            back = back.view(np.uint32)
        assert np.array_equal(back, src), name
    assert np.array_equal(q.numpy(), inputs["qtables"])
    with pytest.raises(ValueError):
        convert.from_reference_inputs(
            dict(geometry, lanes=cfg.lanes * 2), inputs["scans"][0],
            inputs["qtables"], "cpu")


def test_staged_state_matches_jax_staging(data_420_rst2):
    """The port's host staging (plan geometry, destuffed words, segment
    tables, packed Huffman tables) equals the JAX package's, field by
    field, so that either can feed from_reference_inputs."""
    from jpeggpu_tpu.pipeline import build_inputs, build_plan
    from jpeggpu_tpu.reader import parse

    jplan = build_plan(parse(data_420_rst2))
    jin = build_inputs(data_420_rst2, jplan)
    plan = pipeline.build_plan(T.parse(data_420_rst2))
    tin = pipeline.build_inputs(data_420_rst2, plan)
    assert plan.signature.comp_sizes == jplan.signature.comp_sizes
    for jsp, sp, js, ts in zip(jplan.signature.scans, plan.signature.scans,
                               jin["scans"], tin["scans"]):
        for k in convert.GEOMETRY_FIELDS:
            assert getattr(jsp.cfg, k) == getattr(sp.cfg, k), k
        assert (jsp.num_mcus_x, jsp.num_mcus_y, jsp.comps) == (
            sp.num_mcus_x, sp.num_mcus_y, sp.comps)
        assert sorted(js) == sorted(ts)
        for k in ts:
            assert np.array_equal(js[k], ts[k]), k
    assert np.array_equal(jin["qtables"], tin["qtables"])


def test_wrappers_refuse_other_devices(data_420_rst2):
    """A wrapper takes its plain version for CPU tensors only; any other
    device that is not CUDA is refused, never routed to the plain version."""
    from jpeggpu_tpu_torch.ops import huffman as TH
    from jpeggpu_tpu_torch.ops import idct as tidct

    plan = pipeline.build_plan(T.parse(data_420_rst2))
    staged = pipeline.stage_inputs(
        pipeline.build_inputs(data_420_rst2, plan), plan, torch.device("cpu"))
    cfg = plan.signature.scans[0].cfg
    arrs = staged["scans"][0]
    ctx = TH.make_ctx(cfg, arrs)
    meta = torch.zeros(cfg.lanes, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TH.subseq_pass(cfg, arrs, ctx, meta, meta, meta, ctx.lane_valid)
    with pytest.raises(ValueError, match="unsupported device"):
        tidct.idct_stream_to_plane(
            torch.zeros(64, dtype=torch.int16, device="meta"),
            staged["qtables"][0], 1, 1, 1, 0, 1, 1,
            torch.zeros(1, dtype=torch.int16))
    with pytest.raises(ValueError, match="unsupported device"):
        TH.decode_write_emit(cfg, arrs, ctx, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tidct.dequant_idct_plane(
            torch.zeros((8, 8), dtype=torch.int16, device="meta"),
            staged["qtables"][0])
    with pytest.raises(ValueError, match="unsupported device"):
        tidct.idct_stream_to_planes(
            torch.zeros(64, dtype=torch.int16, device="meta"),
            staged["qtables"], (1, 1, ((0, 1, 1, 0),)), 1,
            torch.zeros(1, dtype=torch.int16))
    with pytest.raises(ValueError, match="unsupported device"):
        tidct.dequant_idct_planes(
            [torch.zeros((8, 16), dtype=torch.int16, device="meta")] * 2,
            [staged["qtables"][0]] * 2)
    assert TH.subseq_pass.launches == 0 and TH.decode_write.launches == 0
    assert TH.decode_write_emit.launches == 0
    # the one-component and one-plane calls launch through these two
    assert tidct.idct_stream_to_planes.launches == 0
    assert tidct.dequant_idct_planes.launches == 0


@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py as a module (it runs only on a CUDA device; its image
    and symbol-count helpers are plain numpy / torch)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_repeat_strip(chip_smoke):
    """A strip whose restart interval is one MCU row, repeated to a taller
    image: a valid JPEG whose planes are the strip's rows in turn."""
    img = chip_smoke.synthetic_image(32, 48, seed=7)
    strip = encode(img, EncodeSpec(sampling=_S420, restart_interval=3,
                                   quality=90))
    tall = chip_smoke.repeat_strip(strip, 160)  # 10 MCU rows from 2
    assert T.parse(tall).size_y == 160
    rows = T.decode(strip, device="cpu")
    planes = T.decode(tall, device="cpu")
    for a, b in zip(golden.decode(tall), planes):
        assert np.array_equal(a, b)
    for r, p in zip(rows, planes):
        assert np.array_equal(np.tile(r, (5, 1)), p)


def test_chip_smoke_count_symbols(chip_smoke):
    """Hand-made data units: DC + EOB; a lone coefficient at zigzag 63
    (three ZRL, no EOB); coefficients at zigzag 1 and 18 (one ZRL, EOB)."""
    from jpeggpu_tpu_torch import constants as C

    blocks = torch.zeros(3, 64, dtype=torch.int16)
    blocks[0, 0] = 5
    blocks[1, C.ORDER_NATURAL[63]] = -1
    blocks[2, C.ORDER_NATURAL[1]] = 2
    blocks[2, C.ORDER_NATURAL[18]] = 3
    assert chip_smoke.count_symbols(blocks[:1].reshape(-1)) == 2
    assert chip_smoke.count_symbols(blocks[1:2].reshape(-1)) == 5
    assert chip_smoke.count_symbols(blocks[2:].reshape(-1)) == 5
    assert chip_smoke.count_symbols(blocks.reshape(-1)) == 12
