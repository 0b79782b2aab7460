"""PyTorch port, the sharded decode of one image (``parallel/segments.py``,
segment and subsequence granularity) and kernel K9 (``dequant_idct_planes``,
one launch per shard on the card, and its one-plane call
``dequant_idct_plane``) in its plain version on the CPU.

Against the JAX package: K9's plain version against its Pallas kernel in
interpret mode; the shard plans and the staged shard inputs, field by field
and array by array; the writing decode of one shard of each granularity with
the shard keywords (the JAX functions called outside ``shard_map``, on the
same converted inputs and the same synced states); and one whole
``decode_sharded`` (the gray restart-37 image over four shards, the only
JAX sharded compile, in a module-scoped fixture). Everything else runs
against the port's numpy ``golden``: the sharded decode over a matrix of
streams and meshes, the converged boundary states of subsequence shards,
and the DC un-delta over row chunks. Meshes are lists of CPU devices.

Tolerance: none, every comparison is ``np.array_equal``.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import constants as C
from jpeggpu_tpu_torch import convert, golden, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.errors import NotSupported
from jpeggpu_tpu_torch.idct_int import dequant_idct_blocks
from jpeggpu_tpu_torch.ops import dc as tdc
from jpeggpu_tpu_torch.ops import huffman as TH
from jpeggpu_tpu_torch.ops import idct as tidct
from jpeggpu_tpu_torch.parallel import make_mesh
from jpeggpu_tpu_torch.parallel import segments as S

_S420 = [(2, 2), (1, 1), (1, 1)]


def _big_image(seed=0, w=256, h=160):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (8, 12, 3)).astype(np.uint8)
    return np.array(Image.fromarray(base).resize((w, h), Image.BILINEAR))


def _two_segments():
    img = _big_image(seed=11, w=320, h=160)[..., 0]
    ri = -(-T.parse(encode(img)).scans[0].num_mcus // 2)
    return encode(img, EncodeSpec(restart_interval=ri))


def _four_scans():
    planes = [_big_image(seed=17 + i, w=96, h=64)[..., 0] for i in range(4)]
    return encode(planes, EncodeSpec(sampling=[(1, 1)] * 4,
                                     interleaved=False))


_STREAMS = {
    "420_rst4": lambda: encode(_big_image(), EncodeSpec(
        sampling=_S420, restart_interval=4)),
    "gray_rst37": lambda: encode(_big_image(seed=3)[..., 0], EncodeSpec(
        restart_interval=37)),
    "420_no_restart": lambda: encode(_big_image(seed=7),
                                     EncodeSpec(sampling=_S420)),
    "two_segments": _two_segments,
    "four_scans": _four_scans,
}


@pytest.fixture(scope="module")
def streams():
    return {name: make() for name, make in _STREAMS.items()}


def _cpu_mesh(D):
    return make_mesh(["cpu"] * D)


# --- K9 ---------------------------------------------------------------------

def _k9_planes():
    """The K9 cases: int16 planes and one qtable with bytes at and above 128
    (read as signed int8). "random": 70 blocks; "extreme": 600 blocks of
    +-32767, -32768 and small values."""
    rng = np.random.default_rng(41)
    q = rng.integers(0, 256, 64).astype(np.int32)
    q[:8] = [128, 129, 200, 255, 1, 0, 127, 254]
    return q, {
        "random": rng.integers(-1200, 1200, (56, 80)).astype(np.int16),
        "extreme": rng.choice(np.array([-32768, -32767, -1, 0, 1, 32767],
                                       np.int16), (160, 240)),
    }


def _to_blocks(plane):
    h, w = plane.shape
    return plane.astype(np.int32).reshape(h // 8, 8, w // 8, 8).transpose(
        0, 2, 1, 3).reshape(-1, 8, 8)


def _from_blocks(pix, h, w):
    return pix.reshape(h // 8, w // 8, 8, 8).transpose(0, 2, 1, 3).reshape(
        h, w)


@pytest.fixture(scope="module")
def k9_reference():
    """The JAX package's ``dequant_idct_blocks_pallas`` (its Pallas kernel in
    interpret mode) on the blocks of both K9 cases, in one call: 670 blocks,
    padded by the kernel to two grid steps of 512, the second partial."""
    from jax.experimental import pallas as pl
    import jpeggpu_tpu.ops.idct_pallas as ip

    q, planes = _k9_planes()
    blocks = [_to_blocks(p) for p in planes.values()]
    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call",
                           lambda *a, **k: orig(*a, interpret=True, **k)):
        pix = np.asarray(ip.dequant_idct_blocks_pallas(
            jnp.asarray(np.concatenate(blocks)), jnp.asarray(q)))
    out, i = {}, 0
    for (case, plane), b in zip(planes.items(), blocks):
        out[case] = _from_blocks(pix[i:i + len(b)], *plane.shape)
        i += len(b)
    return out


@pytest.mark.parametrize("case", ["random", "extreme"])
def test_dequant_idct_plane_matches_pallas_kernel(case, k9_reference):
    """K9's plain version == the JAX package's ``dequant_idct_blocks_pallas``
    (its Pallas kernel in interpret mode) on the same blocks: qtable bytes
    at and above 128 (read as signed int8), coefficients at +-32767 and
    -32768, block counts that are not multiples of the kernel's 512."""
    q, planes = _k9_planes()
    plane = planes[case]
    h, w = plane.shape
    expect = k9_reference[case].astype(np.uint8)
    got = tidct.dequant_idct_plane(torch.from_numpy(plane),
                                   torch.from_numpy(q))
    assert got.dtype == torch.uint8 and got.shape == (h, w)
    assert np.array_equal(got.numpy(), expect)
    assert np.array_equal(expect, _from_blocks(
        dequant_idct_blocks(np, _to_blocks(plane), q), h, w))
    assert tidct.dequant_idct_planes.launches == 0


def test_dequant_idct_planes_matches_pallas_kernel(k9_reference):
    """Both K9 cases, of different shapes, in one ``dequant_idct_planes``
    call (K9's one launch per shard on the card) == the JAX package's
    Pallas kernel in interpret mode; a third plane in the same call, with
    its own table, == the numpy transform."""
    q, planes = _k9_planes()
    q2 = np.random.default_rng(43).integers(0, 256, 64).astype(np.int32)
    extra = planes["random"][:24, :40]
    got = tidct.dequant_idct_planes(
        [torch.from_numpy(p) for p in (*planes.values(), extra)],
        [torch.from_numpy(q)] * len(planes) + [torch.from_numpy(q2)])
    assert len(got) == 3
    for case, out in zip(planes, got):
        assert out.dtype == torch.uint8
        assert np.array_equal(out.numpy(), k9_reference[case].astype(np.uint8))
    assert np.array_equal(got[2].numpy(), _from_blocks(
        dequant_idct_blocks(np, _to_blocks(extra), q2), 24, 40).astype(
            np.uint8))
    assert tidct.dequant_idct_planes.launches == 0


def test_plane_blocks_cover_each_block_once():
    """K9's flat list of blocks (``plane_blocks``, the host's numbering,
    read back with the kernel's arithmetic) covers every block of every
    plane exactly once, an empty plane among them."""
    shapes = [(768, 4032), (384, 2016), (0, 16), (56, 80), (8, 8)]
    first, total = tidct.plane_blocks(shapes)
    assert total == sum((h // 8) * (w // 8) for h, w in shapes)
    seen = set()
    for i in range(total):
        p = max(j for j in range(len(shapes)) if i >= first[j])
        h, w = shapes[p]
        by, bx = divmod(i - first[p], w // 8)
        assert 0 <= by < h // 8 and 0 <= bx < w // 8
        assert (p, by, bx) not in seen
        seen.add((p, by, bx))
    assert len(seen) == total


# --- plans and staged shard inputs ------------------------------------------

def _plans(data):
    from jpeggpu_tpu.pipeline import build_plan
    from jpeggpu_tpu.reader import parse

    return (pipeline.build_plan(T.parse(data)), build_plan(parse(data)))


def _same_cfg(cfg, jcfg):
    for k in convert.GEOMETRY_FIELDS:
        assert getattr(cfg, k) == getattr(jcfg, k), k


def _same_inputs(tin, jin):
    assert sorted(tin) == sorted(jin)
    for k in tin:
        assert tin[k].dtype == jin[k].dtype, k
        assert np.array_equal(tin[k], jin[k]), k


@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_plans_match_reference(streams, D):
    """plan_shards / build_shard_inputs (420 restart 4) and
    plan_subseq_shards / build_subseq_shard_inputs (no restart) equal the
    JAX package's, field by field and array by array."""
    import jpeggpu_tpu.parallel.segments as JS

    data = streams["420_rst4"]
    plan, jplan = _plans(data)
    shp, jshp = S.plan_shards(plan, D), JS.plan_shards(jplan, D)
    _same_cfg(shp.cfg, jshp.cfg)
    assert shp.cfg.tuning == T.Tuning()
    for k in ("shard_positions", "num_segments_padded", "real_positions",
              "num_shards", "bounds"):
        assert getattr(shp, k) == getattr(jshp, k), k
    assert sum(shp.real_positions) == plan.signature.scans[0].cfg.total_positions
    _same_inputs(S.build_shard_inputs(data, plan, shp),
                 JS.build_shard_inputs(data, jplan, jshp))

    data = streams["420_no_restart"]
    plan, jplan = _plans(data)
    shp, jshp = S.plan_subseq_shards(plan, D), JS.plan_subseq_shards(jplan, D)
    _same_cfg(shp.cfg, jshp.cfg)
    assert (shp.num_shards, shp.bounds) == (jshp.num_shards, jshp.bounds)
    _same_inputs(S.build_subseq_shard_inputs(data, plan, shp),
                 JS.build_subseq_shard_inputs(data, jplan, jshp))


def test_plan_shards_requires_enough_segments(test_image):
    data = encode(test_image)  # no restart markers: one segment
    plan = pipeline.build_plan(T.parse(data))
    with pytest.raises(NotSupported):
        S.plan_shards(plan, 8)
    with pytest.raises(NotSupported):
        S.plan_subseq_shards(plan, plan.stream.scans[0].num_subsequences + 1)


# --- one shard of each granularity against the JAX write stage --------------

def _jax_write(jcfg, inputs, d, states, pos_base, bound, total_out,
               entry=None):
    """The JAX package's writing decode of shard ``d`` from the given synced
    states, with the shard keywords, outside shard_map (one jit)."""
    from jpeggpu_tpu.ops import huffman as JH

    def run(words, seg_of, seg_first, seg_nsub, maxcode, vsm, huffval,
            nsub, prev_word, p, c, z, n_off, pos_base, bound, entry):
        arrs = JH.ScanArrays(words=words, seg_of_subseq=seg_of,
                             seg_first_lane=seg_first, seg_num_subseq=seg_nsub,
                             maxcode=maxcode, vsm=vsm, huffval=huffval)
        ctx = JH.make_ctx(jcfg, arrs, num_subseq=nsub)
        if prev_word is not None:  # the reference's window patch
            ctx = dataclasses.replace(
                ctx, window=ctx.window.at[0, 0].set(prev_word))
        return JH.decode_scan_from_states(
            jcfg, arrs, ctx, p, c, z, n_off, pos_base=pos_base, bound=bound,
            total_out=total_out, entry=entry)

    prev = inputs["prev_word"][d, 0] if "prev_word" in inputs else None
    out = jax.jit(run)(
        inputs["words"][d], inputs["seg_of"][d], inputs["seg_first"][d],
        inputs["seg_nsub"][d], inputs["maxcode"], inputs["vsm"],
        inputs["huffval"], inputs["n_subseq"][d, 0], prev,
        *[s.numpy() for s in states], pos_base, bound,
        None if entry is None else tuple(np.int32(e) for e in entry))
    return np.asarray(out)


def _golden_states(data):
    stream = T.parse(data)
    return golden.sequential_boundary_states(
        stream, stream.scans[0], np.frombuffer(data, np.uint8))


def test_segment_shard_matches_reference(streams):
    """Shard 2 of four, segment granularity (gray restart 37): the port's
    decode_scan with num_subseq / pos_base / bound / total_out; its states
    == golden's sequential states, its stream == the JAX writing decode with
    the same keywords from the same states."""
    from jpeggpu_tpu.parallel import segments as JS

    data, D, d = streams["gray_rst37"], 4, 2
    plan, jplan = _plans(data)
    shp, jshp = S.plan_shards(plan, D), JS.plan_shards(jplan, D)
    inputs = JS.build_shard_inputs(data, jplan, jshp)
    arrs = convert.shard_arrays(inputs, d, "cpu", shp.cfg.fast_tables)
    nsub = int(inputs["n_subseq"][d, 0])
    pos_base = torch.from_numpy(inputs["pos_base"][d])
    bound = torch.from_numpy(inputs["pos_bound"][d])
    coeffs = TH.decode_scan(shp.cfg, arrs, num_subseq=nsub, pos_base=pos_base,
                            bound=bound, total_out=shp.shard_positions)
    assert coeffs.shape == (shp.shard_positions,)

    ctx = TH.make_ctx(shp.cfg, arrs, num_subseq=nsub)
    assert int(ctx.lane_valid.sum()) == nsub
    p, c, z, n = TH.sync_states(shp.cfg, arrs, ctx)
    first = int(plan.stream.scans[0].segments[shp.bounds[d], 0])
    want = _golden_states(data)[first:first + nsub]
    got = torch.stack([p, c, z, n], 1)[:nsub].numpy()
    assert np.array_equal(got, want)
    n_off = TH.symbol_offsets(shp.cfg, arrs, n)
    expect = _jax_write(jshp.cfg, inputs, d, (p, c, z, n_off),
                        inputs["pos_base"][d], inputs["pos_bound"][d],
                        jshp.shard_positions)
    assert np.array_equal(coeffs.numpy(), expect)


def _subseq_shard(data, D, d, tuning=None):
    """Shard ``d`` of subsequence granularity, synced from golden's boundary
    state: (plan, shp, inputs, arrs, ctx, states, keywords)."""
    plan = pipeline.build_plan(T.parse(data), tuning=tuning)
    shp = S.plan_subseq_shards(plan, D)
    inputs = S.build_subseq_shard_inputs(data, plan, shp)
    arrs = convert.shard_arrays(inputs, d, "cpu", shp.cfg.fast_tables)
    nsub = int(inputs["n_subseq"][d, 0])
    ctx = TH.make_ctx(shp.cfg, arrs, num_subseq=nsub)
    gs = _golden_states(data)
    lo = shp.bounds[d]
    entry = tuple(int(v) for v in gs[lo - 1, :3])
    p, c, z, n = TH.sync_states(shp.cfg, arrs, ctx, entry=entry)
    n_off = TH.symbol_offsets(shp.cfg, arrs, n)
    # global positions, from golden alone: the head segment's symbol counts
    # before the shard, then each segment's base
    scan = plan.stream.scans[0]
    gseg = inputs["seg_global"][d].astype(np.int64)
    seg_lo = int(scan.segments[gseg[0], 0])
    prefix = int(gs[seg_lo:lo, 3].sum())
    pps = shp.cfg.positions_per_seg
    pos_base = (gseg * pps + np.where(gseg == gseg[0], prefix, 0)).astype(
        np.int32)
    bound = np.minimum((gseg + 1) * pps, shp.cfg.total_positions).astype(
        np.int32)
    sp = plan.signature.scans[0]
    total_out = (D * S._chunk_rows(sp.num_mcus_y, D) * sp.num_mcus_x
                 * sp.cfg.du_per_mcu * C.DATA_UNIT_SIZE)
    got = torch.stack([p, c, z, n], 1)[:nsub].numpy()
    assert np.array_equal(got, gs[lo:lo + nsub])
    keywords = dict(pos_base=torch.from_numpy(pos_base),
                    bound=torch.from_numpy(bound), total_out=total_out,
                    entry=entry)
    return plan, shp, inputs, arrs, ctx, (p, c, z, n_off), keywords


def test_subseq_shard_matches_reference(streams):
    """Shard 5 of eight, subsequence granularity (no restart: lane 0 starts
    mid-segment, inside its predecessor's last symbol): the port's sync
    from golden's boundary state == golden's sequential states, and its
    writing decode with pos_base / bound / total_out / entry == the JAX
    writing decode (its window patched with the word before the shard) from
    the same states."""
    data = streams["420_no_restart"]
    plan, shp, inputs, arrs, ctx, states, kw = _subseq_shard(data, 8, 5)
    assert arrs.lead_words == 1 and arrs.words.storage_offset() == 1
    coeffs = TH.decode_scan_from_states(shp.cfg, arrs, ctx, *states, **kw)
    assert coeffs.shape == (kw["total_out"],)
    from jpeggpu_tpu.pipeline import build_plan
    from jpeggpu_tpu.reader import parse
    from jpeggpu_tpu.parallel import segments as JS

    jshp = JS.plan_subseq_shards(build_plan(parse(data)), 8)
    expect = _jax_write(jshp.cfg, inputs, 5, states, kw["pos_base"].numpy(),
                        kw["bound"].numpy(), kw["total_out"], kw["entry"])
    assert np.array_equal(coeffs.numpy(), expect)
    assert coeffs.abs().sum() > 0


@pytest.mark.parametrize("tile_mode", ["super", "lane"])
def test_records_path_shard_keywords(streams, tile_mode):
    """The records write path of a subsequence shard with pos_base / bound /
    total_out / entry == the direct write (K2's plain version) with the same
    keywords."""
    data = streams["420_no_restart"]
    tuning = T.Tuning(write_mode="tiles", tile_mode=tile_mode)
    plan, shp, inputs, arrs, ctx, states, kw = _subseq_shard(data, 4, 3,
                                                             tuning)
    assert shp.cfg.tuning == tuning
    got, _ = TH.decode_scan_from_states(shp.cfg, arrs, ctx, *states,
                                        return_dc=True, **kw)
    expect = TH.decode_write(shp.cfg, arrs, ctx, *states, **kw)
    assert got.shape == expect.shape == (kw["total_out"],)
    assert np.array_equal(got.numpy(), expect.numpy())


# --- boundary fixed point and DC over chunks --------------------------------

@pytest.mark.parametrize("name,D", [("420_no_restart", 8),
                                    ("two_segments", 8)])
def test_subseq_entries_match_sequential_states(streams, name, D):
    """Every shard's converged entry == golden's sequential state after
    subsequence lo - 1 (the zero state for shard 0), in at most D rounds;
    read from the fixed point that the whole sharded decode of the same
    stream over the same mesh ran."""
    data = streams[name]
    plan, _, syncs = _run_sharded(streams, f"{name}_D{D}")
    (states, entries, rounds), = syncs
    assert 1 <= rounds <= D
    bounds = S.plan_subseq_shards(plan, D).bounds
    gs = _golden_states(data)
    for d, (entry, (p, c, z, n)) in enumerate(zip(entries, states)):
        lo, hi = bounds[d], bounds[d + 1]
        want = gs[lo - 1, :3] if lo else np.zeros(3, np.int32)
        assert np.array_equal(entry.numpy(), want), d
        got = torch.stack([p, c, z, n], 1)[:hi - lo].numpy()
        assert np.array_equal(got, gs[lo:hi]), d


@pytest.mark.parametrize("name,D", [("420_rst4", 8), ("two_segments", 8),
                                    ("gray_rst37", 4)])
def test_undelta_dc_chunks_matches_unsharded(streams, name, D):
    """DC un-delta over the D row chunks == the unsharded undelta_dc of the
    whole (row-padded) stream, cut into the same chunks; two segments over
    eight chunks make each segment span four."""
    data = streams[name]
    plan = pipeline.build_plan(T.parse(data))
    scan, sp = plan.stream.scans[0], plan.signature.scans[0]
    raw = golden.decode_scan_coefficients(plan.stream, scan,
                                          np.frombuffer(data, np.uint8))
    rows = S._chunk_rows(sp.num_mcus_y, D)
    padded = D * rows * sp.num_mcus_x * sp.cfg.du_per_mcu * C.DATA_UNIT_SIZE
    stream = np.zeros(padded, np.int16)
    stream[:raw.size] = raw
    cfg = sp.cfg
    pcfg = dataclasses.replace(
        cfg, total_mcus=padded // C.DATA_UNIT_SIZE // cfg.du_per_mcu)
    comp_slots = tuple((c[1], c[2] * c[3]) for c in sp.comps)
    whole = tdc.undelta_dc(pcfg, comp_slots, torch.from_numpy(stream))
    chunks = list(torch.from_numpy(stream).chunk(D))
    got = S._undelta_dc_chunks(cfg, comp_slots, chunks)
    assert np.array_equal(torch.cat(got).numpy(), whole.numpy())
    seg_du = cfg.mcus_per_seg * cfg.du_per_mcu
    if name == "two_segments":
        assert seg_du >= 3 * (padded // C.DATA_UNIT_SIZE // D)


# --- the sharded decode as a whole ------------------------------------------

_CASES = {
    "420_rst4_D8": ("420_rst4", 8, {}),
    "gray_rst37_D4": ("gray_rst37", 4, {}),
    "420_no_restart_D8": ("420_no_restart", 8, {}),
    "two_segments_D8": ("two_segments", 8, {}),
    "four_scans_D2": ("four_scans", 2, {}),
    "420_rst4_D1": ("420_rst4", 1, {}),
    "gray_rst37_D4_coefficients": ("gray_rst37", 4, {"with_idct": False}),
    "420_no_restart_D4_tiles": ("420_no_restart", 4, {
        "tuning": T.Tuning(write_mode="tiles")}),
}


_RUNS = {}


def _run_sharded(streams, case):
    """``decode_sharded`` of one case of ``_CASES``, run once per module:
    its plan, its planes and what the boundary fixed point of each
    subsequence-granular scan returned (states, entries, rounds)."""
    if case not in _RUNS:
        name, D, opts = _CASES[case]
        data = streams[name]
        plan = pipeline.build_plan(T.parse(data), tuning=opts.get("tuning"))
        syncs, sync = [], S._subseq_sync

        def recorded(*args):
            syncs.append(sync(*args))
            return syncs[-1]

        with mock.patch.object(S, "_subseq_sync", recorded):
            out = S.decode_sharded(data, _cpu_mesh(D), plan=plan,
                                   with_idct=opts.get("with_idct", True))
        _RUNS[case] = plan, out, syncs
    return _RUNS[case]


@pytest.mark.parametrize("case", list(_CASES))
def test_decode_sharded_matches_golden(streams, case):
    name, D, opts = _CASES[case]
    data = streams[name]
    with_idct = opts.get("with_idct", True)
    plan, out, _ = _run_sharded(streams, case)
    expect = golden.decode(data, with_idct=with_idct)
    assert len(out) == len(expect)
    for a, b, comp in zip(out, expect, plan.stream.components):
        # golden's coefficient planes are padded to whole MCUs
        b = b[:comp.size_y, :comp.size_x]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    assert tidct.dequant_idct_planes.launches == 0


@pytest.fixture(scope="module")
def jax_gray_rst37(streams):
    from jpeggpu_tpu.parallel import make_mesh as jmesh
    from jpeggpu_tpu.parallel.segments import decode_sharded

    return decode_sharded(streams["gray_rst37"],
                          jmesh(jax.devices()[:4], axis_name="seg"))


def test_decode_sharded_matches_reference(streams, jax_gray_rst37):
    """The gray restart-37 image over four shards: == the JAX package's
    decode_sharded over four devices."""
    _, out, _ = _run_sharded(streams, "gray_rst37_D4")
    assert len(out) == len(jax_gray_rst37) == 1
    assert np.array_equal(out[0], jax_gray_rst37[0])


def test_subseq_granularity_on_segmented_scan(streams):
    """Subsequence granularity forced on a scan with restart segments (the
    seams fall mid-segment and at segment starts): == golden."""
    data = streams["420_rst4"]
    plan = pipeline.build_plan(T.parse(data))
    st = S._stage(data, plan, 0, _cpu_mesh(4), "subsequences")
    blocks = S.decode_scan_staged(st)
    out = S.assemble(plan, dict(enumerate(blocks)))
    for a, b in zip(out, golden.decode(data)):
        assert np.array_equal(a, b)
    assert 1 <= st.outer_rounds <= 4


def test_make_mesh_needs_cuda():
    """make_mesh() and decode_sharded with no mesh take the CUDA devices and
    raise where there is none; named devices may repeat."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        S.decode_sharded(b"")
    mesh = make_mesh(["cpu"] * 3)
    assert mesh.size == 3
    assert all(d == torch.device("cpu") for d in mesh.devices)
