"""PyTorch port, entropy decode: kernels K1 (subseq_pass, through
sync_states) and K2 (decode_write) in their plain versions on the CPU, and
the records write path (K4-K6 and, in its per-lane shape, K7-K8;
``Tuning(write_mode="tiles")``) over the same matrix of streams.

(a) Against the JAX package: the same staged inputs, handed over through
``convert.from_reference_inputs``, give the same converged states and the
same coefficient stream. The JAX side runs its plain XLA reference (what
its own tests run on the CPU), compiled once per module.
(b) Against the numpy golden decoder, over a matrix of stream shapes:
states, coefficients, DC values and planes.

Tolerance: none. The pipeline is integer end to end, so every comparison is
``np.array_equal``.
"""

import jax
import numpy as np
import pytest
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import convert, golden, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.ops import dc as tdc
from jpeggpu_tpu_torch.ops import huffman as TH

import torch_cases

_S420 = torch_cases.S420
_case_data = torch_cases.case_data
CASES = torch_cases.CASES


@pytest.fixture(scope="module")
def decoded(test_image):
    """Decode each case once on the CPU, keeping every intermediate."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        data = _case_data(name, test_image)
        plan = pipeline.build_plan(T.parse(data))
        staged = pipeline.stage_inputs(pipeline.build_inputs(data, plan),
                                       plan, torch.device("cpu"))
        scans = []
        for sp, arrs in zip(plan.signature.scans, staged["scans"]):
            cfg = sp.cfg
            ctx = TH.make_ctx(cfg, arrs)
            p, c, z, n = TH.sync_states(cfg, arrs, ctx)
            n_off = TH.symbol_offsets(cfg, arrs, n)
            coeffs = TH.decode_write(cfg, arrs, ctx, p, c, z, n_off)
            comp_slots = tuple((k[1], k[2] * k[3]) for k in sp.comps)
            scans.append(dict(
                states=torch.stack([p, c, z, n], dim=1).numpy(),
                coeffs=coeffs.numpy(),
                dcv=tdc.undelta_dc_values(cfg, comp_slots, coeffs).numpy()))
        planes = pipeline.decode_pipeline(plan.signature, staged["scans"],
                                          staged["qtables"])
        cache[name] = dict(data=data, plan=plan, scans=scans,
                           planes=[x.numpy() for x in planes])
        return cache[name]

    return get


@pytest.mark.parametrize("name", CASES)
def test_states_match_sequential(decoded, name):
    """sync_states (every round is K1's plain version) converges to the
    states of a sequential decode at every subsequence boundary."""
    d = decoded(name)
    buf = np.frombuffer(d["data"], np.uint8)
    stream = d["plan"].stream
    if name == "saturated_table":
        assert not d["plan"].signature.scans[0].cfg.fast_tables
    for scan, got in zip(stream.scans, d["scans"]):
        expect = golden.sequential_boundary_states(stream, scan, buf)
        assert np.array_equal(got["states"][:scan.num_subsequences], expect)


@pytest.mark.parametrize("name", CASES)
def test_coefficients_match_golden(decoded, name):
    """decode_write (K2's plain version) fills the coefficient stream the
    golden decoder fills."""
    d = decoded(name)
    buf = np.frombuffer(d["data"], np.uint8)
    stream = d["plan"].stream
    for scan, got in zip(stream.scans, d["scans"]):
        expect = golden.decode_scan_coefficients(stream, scan, buf)
        assert got["coeffs"].dtype == np.int16
        assert np.array_equal(got["coeffs"], expect)


@pytest.mark.parametrize("name", CASES)
def test_dc_values_match_golden(decoded, name):
    d = decoded(name)
    buf = np.frombuffer(d["data"], np.uint8)
    stream = d["plan"].stream
    for scan, got in zip(stream.scans, d["scans"]):
        expect = golden.decode_scan_coefficients(stream, scan, buf)
        golden.undelta_dc(stream, scan, expect)
        assert np.array_equal(got["dcv"], expect[::64])


@pytest.mark.parametrize("name", CASES)
def test_planes_match_golden(decoded, name):
    d = decoded(name)
    expect = golden.decode(d["data"])
    assert len(expect) == len(d["planes"])
    for a, b in zip(expect, d["planes"]):
        assert b.dtype == np.uint8 and a.shape == b.shape
        assert np.array_equal(a, b)


# --- the records write path over the matrix ----------------------------------

_TILES = T.Tuning(write_mode="tiles", tile_mode="super")
_LANE = T.Tuning(write_mode="tiles", tile_mode="lane")


def _garbage_body(image):
    """A valid header in front of a random scan body (no 0xFF bytes)."""
    data = encode(image[..., 0], EncodeSpec(restart_interval=3))
    scan = T.parse(data).scans[0]
    rng = np.random.default_rng(23)
    body = rng.integers(0, 255, scan.end - scan.begin, dtype=np.uint8)
    body[body == 0xFF] = 0x7F
    return data[:scan.begin] + body.tobytes() + data[scan.end:]


# name -> (stream, tuning); the first and the last must send lanes through
# the leftover scatter, the garbage body may
_LEFTOVER_CASES = {
    # flat gray: ~3 bits per data unit, subsequences span more data units
    # than a supertile holds
    "flat_gray_q50": (lambda image: encode(np.full((128, 136), 130, np.uint8),
                                           EncodeSpec(quality=50)), _TILES),
    "garbage_body": (_garbage_body, _TILES),
    # a record-slot trim below the lanes' record counts
    "trim128": (lambda image: encode(image, EncodeSpec(quality=95)),
                T.Tuning(write_mode="tiles", tile_mode="super", s_trim=128)),
}


# the same streams under the per-lane tile shape (the trim is not its own)
_LANE_CASES = ["lane-" + name for name in CASES + ["flat_gray_q50",
                                                   "garbage_body"]]


@pytest.mark.parametrize("name",
                         CASES + list(_LEFTOVER_CASES) + _LANE_CASES)
def test_records_path_matches_golden(decoded, test_image, name):
    """decode_jpeg_device under a plan built with write_mode="tiles": the
    planes equal golden's, and every scan's coefficients and DC side vector
    equal the direct write's, over the matrix, over two streams that send
    lanes through the leftover scatter and over a garbage scan body; in the
    supertile shape and ("lane-" cases) in the per-lane shape, which has no
    side vector."""
    from jpeggpu_tpu_torch.ops import write as TW

    tuning = _TILES
    if name.startswith("lane-"):
        name, tuning = name[len("lane-"):], _LANE
    if name in _LEFTOVER_CASES:
        make, trim_tuning = _LEFTOVER_CASES[name]
        data = make(test_image)
        if tuning is _TILES:
            tuning = trim_tuning
    else:
        data = decoded(name)["data"]
    plan = pipeline.build_plan(T.parse(data), tuning=tuning)
    staged = pipeline.stage_inputs(pipeline.build_inputs(data, plan), plan,
                                   torch.device("cpu"))
    fused_plan = pipeline.build_plan(T.parse(data))
    for sp, fsp, arrs in zip(plan.signature.scans, fused_plan.signature.scans,
                             staged["scans"]):
        assert sp.cfg.tuning.write_mode == "tiles"
        coeffs, dc = TH.decode_scan(sp.cfg, arrs, return_dc=True)
        if name in ("flat_gray_q50", "trim128"):
            assert TW.scatter_leftover.lanes > 0
        expect, none = TH.decode_scan(fsp.cfg, arrs, return_dc=True)
        assert none is None and coeffs.dtype == torch.int16
        assert np.array_equal(coeffs.numpy(), expect.numpy())
        if tuning is _LANE:
            assert dc is None
        else:
            assert np.array_equal(dc.numpy()[:expect.numel() // 64],
                                  expect.numpy()[::64])
    planes = pipeline.decode_jpeg_device(data, device="cpu", plan=plan)
    expect = golden.decode(data)
    assert len(planes) == len(expect)
    for a, b in zip(expect, planes):
        assert b.dtype == np.uint8 and np.array_equal(a, b)


# --- against the JAX package ------------------------------------------------

@pytest.fixture(scope="module")
def jax_reference(test_image):
    """States and coefficients of the JAX package for 420_rst2, through its
    plain XLA reference: full-width Jacobi sync (the mode the port runs)
    and the scatter write. One executable, compiled once."""
    from jpeggpu_tpu.encoder import EncodeSpec as JSpec
    from jpeggpu_tpu.encoder import encode as jencode
    from jpeggpu_tpu.ops import huffman as JH
    from jpeggpu_tpu.pipeline import build_inputs, build_plan
    from jpeggpu_tpu.reader import parse

    data = jencode(test_image, JSpec(sampling=_S420, restart_interval=2))
    plan = build_plan(parse(data))
    inputs = build_inputs(data, plan)
    cfg = plan.signature.scans[0].cfg
    inp = inputs["scans"][0]

    def f(inp):
        arrs = JH.ScanArrays(
            words=inp["words"], seg_of_subseq=inp["seg_of_subseq"],
            seg_first_lane=inp["seg_first_lane"],
            seg_num_subseq=inp["seg_num_subseq"], maxcode=inp["maxcode"],
            vsm=inp["vsm"], huffval=inp["huffval"])
        ctx = JH.make_ctx(cfg, arrs)
        p, c, z, n = JH.sync_states(cfg, arrs, ctx, frontier_width=0)
        n_off = JH.symbol_offsets(cfg, arrs, n)
        coeffs = JH.decode_write(cfg, arrs, ctx, p, c, z, n_off)
        return p, c, z, n, n_off, coeffs

    out = [np.asarray(x) for x in jax.jit(f).lower(inp).compile()(inp)]
    geometry = {k: getattr(cfg, k) for k in convert.GEOMETRY_FIELDS}
    return dict(data=data, geometry=geometry, inp=inp,
                qtables=inputs["qtables"], out=out)


@pytest.fixture(scope="module")
def port_on_reference_inputs(jax_reference):
    r = jax_reference
    cfg, arrs, _ = convert.from_reference_inputs(
        r["geometry"], r["inp"], r["qtables"], "cpu")
    ctx = TH.make_ctx(cfg, arrs)
    p, c, z, n = TH.sync_states(cfg, arrs, ctx)
    n_off = TH.symbol_offsets(cfg, arrs, n)
    coeffs = TH.decode_write(cfg, arrs, ctx, p, c, z, n_off)
    return [x.numpy() for x in (p, c, z, n, n_off, coeffs)]


@pytest.mark.parametrize("idx,what", list(enumerate("pczn")))
def test_sync_states_match_jax(jax_reference, port_on_reference_inputs, idx,
                               what):
    got, expect = port_on_reference_inputs[idx], jax_reference["out"][idx]
    assert got.dtype == expect.dtype == np.int32
    assert np.array_equal(got, expect), what


def test_symbol_offsets_match_jax(jax_reference, port_on_reference_inputs):
    assert np.array_equal(port_on_reference_inputs[4],
                          jax_reference["out"][4])


def test_decode_scan_matches_jax(jax_reference, port_on_reference_inputs):
    got, expect = port_on_reference_inputs[5], jax_reference["out"][5]
    assert got.dtype == expect.dtype == np.int16
    assert np.array_equal(got, expect)
    # and decode_scan, the composition the pipeline calls
    r = jax_reference
    cfg, arrs, _ = convert.from_reference_inputs(
        r["geometry"], r["inp"], r["qtables"], "cpu")
    assert np.array_equal(TH.decode_scan(cfg, arrs).numpy(), expect)
