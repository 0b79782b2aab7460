"""PyTorch port, the compacted sync tiers of ``ops.huffman.sync_states``
and K1's gathered mode (``subseq_pass_at``) in their plain versions on the
CPU.

(a) Under the JAX tests' own tier tunings (``tests/test_ops.py``), the
port's converged states equal the sequential boundary states of the port's
golden decoder, and each case shows, by the rounds by tier that
``sync_states(..., record=)`` reports, that the tier it is meant for ran.
(b) Against the JAX package: the same staged inputs
(``convert.from_reference_inputs``) under one classic and one ladder
tuning give the same states, ``n`` and round counts ``(it0, it)`` of
``sync_states(..., diag=True)``; a subsequence shard synced from an
``entry`` state under the ladder too. Two JAX executables, each compiled
once per module, with the JAX symbol loop unrolled once (``unroll=1``:
the same states, a smaller program to compile).
(c) The gathered pass against ``decode_pass_plain`` over every lane, and
the default tuning, which keeps the full-width Jacobi rounds.

Tolerance: none; every comparison is ``np.array_equal``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import convert, golden, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.ops import huffman as TH
from jpeggpu_tpu_torch.parallel import segments as S

import torch_cases

CPU = torch.device("cpu")
S420 = torch_cases.S420
# the JAX tests' tier tunings (tests/test_ops.py), their streams' specs, and
# the tier each one must reach
CLASSIC_CASES = {
    "head_width": (dict(chain_follow=3, frontier_width=8, head_width=8),
                   dict(restart_interval=5), "narrow"),
    "chain_follow": (dict(chain_follow=3, frontier_width=6), {}, "wide"),
    "wide_follow_2_4": (dict(chain_follow=2, frontier_width=8, head_width=4,
                             wide_follow=2), {},
                        "wide"),
    "wide_follow_3_2": (dict(chain_follow=2, frontier_width=8, head_width=2,
                             wide_follow=3), {},
                        "wide"),
    "wide_follow_1_3": (dict(chain_follow=2, frontier_width=8, head_width=3,
                             wide_follow=1), {},
                        "wide"),
    "tail": (dict(frontier_width=16, head_width=8, tail_width=4,
                  tail_follow=2), {}, "tail"),
    "ladder": (dict(sync_tiers="ladder", frontier_width=32), {}, "ladder 32"),
}
CLASSIC = dict(chain_follow=2, frontier_width=8, head_width=3, wide_follow=1)
LADDER = dict(sync_tiers="ladder", frontier_width=32)
# ladder widths 640, 320, 160, 80 on the wide deep stream: the take of live
# heads between tiers, and wide_follow above 512 heads
WIDE_LADDER = dict(sync_tiers="ladder", frontier_width=640, chain_follow=2,
                   wide_follow=3)


def _made_up_scan(seed, kind, shard):
    """``made_up_scan`` of chip_smoke.py (random words in 512 lanes, seven
    restart segments, made-up tables) on CPU tensors."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.made_up_scan(CPU, seed, kind, shard)


def deep_image(width=256, height=64):
    """A smooth 256x64 RGB image whose quality-95 stream needs seven
    full-width rounds after round 1 (58 subsequences): deep enough that
    compacted rounds happen under every tuning above. The JAX tests'
    67x45 image needs two to three. At 1024x256 (797 subsequences) the
    frontier after round 1 holds 349 lanes, more than half of
    ``WIDE_LADDER``'s top tier."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, (6, 8, 3)).astype(np.uint8)
    img = np.array(Image.fromarray(base).resize((width, height),
                                                Image.BILINEAR))
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def _deep_stream(**spec):
    return encode(deep_image(), EncodeSpec(sampling=S420, quality=95, **spec))


def _sync(data, tuning, diag=True):
    """The port's sync of scan 0 of ``data`` on CPU tensors under a plan
    built with ``tuning``; returns (states [n_sub, 4], sync outputs,
    rounds by tier)."""
    plan = pipeline.build_plan(T.parse(data), tuning=tuning)
    staged = pipeline.stage_inputs(pipeline.build_inputs(data, plan), plan,
                                   CPU)
    cfg, arrs = plan.signature.scans[0].cfg, staged["scans"][0]
    record = {}
    out = TH.sync_states(cfg, arrs, TH.make_ctx(cfg, arrs), diag=diag,
                         record=record)
    n_sub = plan.stream.scans[0].num_subsequences
    return torch.stack(out[:4], 1).numpy()[:n_sub], out, record["rounds"]


def _sequential(data):
    stream = T.parse(data)
    return golden.sequential_boundary_states(
        stream, stream.scans[0], np.frombuffer(data, np.uint8))


@pytest.mark.parametrize("case", list(CLASSIC_CASES))
def test_tiers_match_sequential(case):
    """Every tier tuning converges to the sequential boundary states, and
    the tier it is meant for ran at least one round."""
    fields, spec, tier = CLASSIC_CASES[case]
    data = _deep_stream(**spec)
    got, out, rounds = _sync(data, T.Tuning(**fields))
    assert np.array_equal(got, _sequential(data))
    assert rounds.get(tier, 0) >= 1, rounds
    it0, it = out[4:]
    assert it > 0 and it0 <= it


def _jax_inputs(data, tuning_fields):
    from jpeggpu_tpu.config import Tuning as JTuning
    from jpeggpu_tpu.pipeline import build_inputs, build_plan
    from jpeggpu_tpu.reader import parse

    plan = build_plan(parse(data))
    inputs = build_inputs(data, plan)
    cfg = dataclasses.replace(plan.signature.scans[0].cfg,
                              tuning=JTuning(unroll=1, **tuning_fields))
    return cfg, inputs


def _jax_arrs(JH, inp, words=None):
    return JH.ScanArrays(
        words=inp["words"] if words is None else words,
        seg_of_subseq=inp["seg_of_subseq"],
        seg_first_lane=inp["seg_first_lane"],
        seg_num_subseq=inp["seg_num_subseq"], maxcode=inp["maxcode"],
        vsm=inp["vsm"], huffval=inp["huffval"])


@pytest.fixture(scope="module")
def jax_classic():
    """The JAX package's sync_states(diag=True) of the deep stream under
    the classic tuning: one executable."""
    from jpeggpu_tpu.encoder import EncodeSpec as JSpec
    from jpeggpu_tpu.encoder import encode as jencode
    from jpeggpu_tpu.ops import huffman as JH

    data = jencode(deep_image(), JSpec(sampling=S420, quality=95))
    cfg, inputs = _jax_inputs(data, CLASSIC)
    inp = inputs["scans"][0]

    def f(inp):
        arrs = _jax_arrs(JH, inp)
        return JH.sync_states(cfg, arrs, JH.make_ctx(cfg, arrs), diag=True)

    out = [np.asarray(x) for x in jax.jit(f)(inp)]
    geometry = {k: getattr(cfg, k) for k in convert.GEOMETRY_FIELDS}
    geometry["tuning"] = cfg.tuning
    return dict(geometry=geometry, inp=inp, qtables=inputs["qtables"],
                out=out)


def _subseq_shard(data, D, d, tuning):
    """Shard ``d`` of D at subsequence granularity with golden's boundary
    state as ``entry``: (jax cfg, shard inputs, port cfg, arrs, entry)."""
    from jpeggpu_tpu.config import Tuning as JTuning
    from jpeggpu_tpu.parallel import segments as JS
    from jpeggpu_tpu.pipeline import build_plan
    from jpeggpu_tpu.reader import parse

    plan = pipeline.build_plan(T.parse(data), tuning=T.Tuning(**tuning))
    shp = S.plan_subseq_shards(plan, D)
    inputs = S.build_subseq_shard_inputs(data, plan, shp)
    arrs = convert.shard_arrays(inputs, d, CPU, shp.cfg.fast_tables)
    jshp = JS.plan_subseq_shards(build_plan(parse(data)), D)
    jcfg = dataclasses.replace(jshp.cfg, tuning=JTuning(unroll=1, **tuning))
    entry = tuple(int(v) for v in _sequential(data)[shp.bounds[d] - 1, :3])
    return jcfg, inputs, shp.cfg, arrs, entry


@pytest.fixture(scope="module")
def jax_ladder():
    """The JAX package's sync_states(diag=True) under the ladder tuning of
    the deep stream, under ``WIDE_LADDER`` of the wide deep stream, and of
    shard 5 of eight of the deep stream without restarts (subsequence
    granularity, synced from golden's boundary state, its window patched
    with the word before the shard as the JAX package's sharded decode
    does): one executable for the three."""
    from jpeggpu_tpu.encoder import EncodeSpec as JSpec
    from jpeggpu_tpu.encoder import encode as jencode
    from jpeggpu_tpu.ops import huffman as JH

    data = jencode(deep_image(), JSpec(sampling=S420, quality=95))
    cfg, inputs = _jax_inputs(data, LADDER)
    inp = inputs["scans"][0]
    wcfg, winputs = _jax_inputs(
        jencode(deep_image(1024, 256), JSpec(sampling=S420, quality=95)),
        WIDE_LADDER)
    winp = winputs["scans"][0]
    jcfg, sh, pcfg, parrs, entry = _subseq_shard(data, 8, 5, LADDER)
    d = 5

    def f(inp, winp, words, seg_of, seg_first, seg_nsub, nsub, prev_word):
        arrs = _jax_arrs(JH, inp)
        whole = JH.sync_states(cfg, arrs, JH.make_ctx(cfg, arrs), diag=True)
        warrs = _jax_arrs(JH, winp)
        wide = JH.sync_states(wcfg, warrs, JH.make_ctx(wcfg, warrs),
                              diag=True)
        sarrs = JH.ScanArrays(
            words=words, seg_of_subseq=seg_of, seg_first_lane=seg_first,
            seg_num_subseq=seg_nsub, maxcode=inp["maxcode"], vsm=inp["vsm"],
            huffval=inp["huffval"])
        ctx = JH.make_ctx(jcfg, sarrs, num_subseq=nsub)
        ctx = dataclasses.replace(
            ctx, window=ctx.window.at[0, 0].set(prev_word))
        shard = JH.sync_states(jcfg, sarrs, ctx, diag=True,
                               entry=tuple(np.int32(e) for e in entry))
        return whole, wide, shard

    whole, wide, shard = jax.jit(f)(
        inp, winp, sh["words"][d], sh["seg_of"][d], sh["seg_first"][d],
        sh["seg_nsub"][d], sh["n_subseq"][d, 0], sh["prev_word"][d, 0])

    def ref(cfg, inp, qtables, out):
        geometry = {k: getattr(cfg, k) for k in convert.GEOMETRY_FIELDS}
        geometry["tuning"] = cfg.tuning
        return dict(geometry=geometry, inp=inp, qtables=qtables,
                    out=[np.asarray(x) for x in out])

    return dict(ref(cfg, inp, inputs["qtables"], whole),
                wide=ref(wcfg, winp, winputs["qtables"], wide),
                shard_out=[np.asarray(x) for x in shard],
                shard=(pcfg, parrs, entry, int(sh["n_subseq"][d, 0])))


def _port_diag(ref):
    cfg, arrs, _ = convert.from_reference_inputs(
        ref["geometry"], ref["inp"], ref["qtables"], CPU)
    record = {}
    out = TH.sync_states(cfg, arrs, TH.make_ctx(cfg, arrs), diag=True,
                         record=record)
    return cfg, out, record["rounds"]


@pytest.mark.parametrize("which", ["classic", "ladder", "ladder_wide"])
def test_tiers_match_jax(jax_classic, jax_ladder, which):
    """The JAX Tuning crosses over through convert.tuning with its sync
    fields; states, n and (it0, it) equal the JAX package's. Under
    ``WIDE_LADDER`` three tiers run, the top one (640 heads) with
    wide_follow."""
    ref = {"classic": jax_classic, "ladder": jax_ladder,
           "ladder_wide": jax_ladder["wide"]}[which]
    cfg, out, rounds = _port_diag(ref)
    assert cfg.tuning.names_sync_tiers
    assert cfg.tuning.sync_tiers == ref["geometry"]["tuning"].sync_tiers
    for got, expect in zip(out[:4], ref["out"][:4]):
        assert np.array_equal(got.numpy(), expect)
    assert (out[4], out[5]) == tuple(int(x) for x in ref["out"][4:])
    # the compacted tiers ran (these are not the Jacobi's counts)
    assert sum(v for k, v in rounds.items() if k != "full") >= 1, rounds
    if which == "ladder_wide":
        assert cfg.lanes > 640 and rounds["ladder 640"] >= 1, rounds
        assert sum(1 for k, v in rounds.items()
                   if k.startswith("ladder") and v) >= 3, rounds


def test_entry_shard_matches_jax(jax_ladder):
    """A subsequence shard under the ladder, lane 0 entered from golden's
    boundary state: states, n and (it0, it) == the JAX package's, and the
    states == golden's sequential ones."""
    cfg, arrs, entry, nsub = jax_ladder["shard"]
    ctx = TH.make_ctx(cfg, arrs, num_subseq=nsub)
    record = {}
    out = TH.sync_states(cfg, arrs, ctx, diag=True, entry=entry,
                         record=record)
    ref = jax_ladder["shard_out"]
    for got, expect in zip(out[:4], ref[:4]):
        assert np.array_equal(got.numpy(), expect)
    assert (out[4], out[5]) == tuple(int(x) for x in ref[4:])
    assert record["rounds"].get("ladder 32", 0) >= 1


@pytest.mark.parametrize("kind", ["saturated", "garbage"])
def test_gathered_pass_matches_full_width_pass(kind):
    """subseq_pass_at_plain on sorted distinct heads (lane 0, the last
    lane, segment firsts and their neighbours, inactive columns) from
    random starts (from 31 bits before the lane's subsequence, never
    before its segment, to past its end) == decode_pass_plain over every
    lane with the same starts at those lanes, gathered at them."""
    for shard in (False, True):
        cfg, arrs, ctx = _made_up_scan(11, kind, shard)
        rng = np.random.default_rng(12)
        firsts = np.flatnonzero(ctx.first_of_seg.numpy())
        pick = set(rng.choice(cfg.lanes, 40, replace=False).tolist())
        pick |= {0, cfg.lanes - 1} | set(firsts.tolist())
        pick |= {f - 1 for f in firsts if f} | {f + 1 for f in firsts}
        idx = np.array(sorted(v for v in pick if 0 <= v < cfg.lanes),
                       np.int32)
        rel = ctx.rel.numpy()[idx].astype(np.int64)
        sp = np.maximum(rel * 1024 + rng.integers(-31, 1064, idx.size),
                        0).astype(np.int32)
        sc = rng.integers(0, cfg.du_per_mcu, idx.size).astype(np.int32)
        sz = rng.integers(0, 64, idx.size).astype(np.int32)
        active = rng.random(idx.size) < 0.8
        active[:2] = True
        got = TH.subseq_pass_at(cfg, arrs, ctx, *(
            torch.from_numpy(a) for a in (idx, sp, sc, sz, active)))

        full = [np.zeros(cfg.lanes, np.int32) for _ in range(3)]
        for f, a in zip(full, (sp, sc, sz)):
            f[idx] = a
        on = np.zeros(cfg.lanes, bool)
        on[idx] = active
        ref = TH.decode_pass_plain(cfg, arrs, ctx, *(
            torch.from_numpy(a) for a in (*full, on)))
        for g, r in zip(got, ref):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), r.numpy()[idx])
        # an inactive column keeps its start with n = 0
        off = ~active
        assert np.array_equal(got[0].numpy()[off], sp[off])
        assert not got[3].numpy()[off].any()
        assert got[3].numpy()[active].any()


def test_default_tuning_keeps_the_jacobi(monkeypatch):
    """A default Tuning names no sync field: sync_states runs full-width
    rounds only (K1's whole round each, never the gathered pass), as many
    as the rounds (it0 == it) plus the blind round and round 1; an
    explicit frontier_width=0 is the Jacobi under a tier tuning too."""
    calls = {"round": 0, "gathered": 0}
    whole, gathered = TH.subseq_pass_plain, TH.subseq_pass_at_plain

    def count_round(*a, **k):
        calls["round"] += 1
        return whole(*a, **k)

    def count_gathered(*a, **k):
        calls["gathered"] += 1
        return gathered(*a, **k)

    monkeypatch.setattr(TH, "subseq_pass_plain", count_round)
    monkeypatch.setattr(TH, "subseq_pass_at_plain", count_gathered)
    data = _deep_stream()
    assert not T.Tuning().names_sync_tiers
    got, out, rounds = _sync(data, T.Tuning())
    assert np.array_equal(got, _sequential(data))
    assert out[4] == out[5] == 7
    assert calls == {"round": 9, "gathered": 0}
    assert rounds == {"full": 7}

    calls.update(round=0, gathered=0)
    plan = pipeline.build_plan(T.parse(data), tuning=T.Tuning(**CLASSIC))
    staged = pipeline.stage_inputs(pipeline.build_inputs(data, plan), plan,
                                   CPU)
    cfg, arrs = plan.signature.scans[0].cfg, staged["scans"][0]
    out = TH.sync_states(cfg, arrs, TH.make_ctx(cfg, arrs), frontier_width=0,
                         diag=True)
    assert calls == {"round": 9, "gathered": 0} and out[4:] == (7, 7)

    calls.update(round=0, gathered=0)
    _sync(data, T.Tuning(**CLASSIC))
    assert calls["gathered"] > 0


def test_tier_resolution():
    """The rule of config.Tuning: auto values -> the Jacobi; a named field
    -> the JAX package's resolution for the kind of device."""
    cfg = TH.ScanConfig(lanes=24576, num_segments=1, du_per_mcu=6,
                        mcus_per_seg=1, total_mcus=1,
                        comp_groups=((4, 0, 1), (6, 2, 3)))
    cuda = torch.device("cuda", 0)

    def with_(**kw):
        return dataclasses.replace(cfg, tuning=T.Tuning(**kw))

    assert TH._resolve_sync_tiers(cfg, CPU) is None
    assert TH._resolve_frontier_width(cfg, cuda) == 0
    assert TH._resolve_sync_tiers(with_(chain_follow=2), CPU) == "classic"
    assert TH._resolve_sync_tiers(with_(chain_follow=2), cuda) == "ladder"
    assert TH._resolve_frontier_width(with_(sync_tiers="ladder"), CPU) == 6144
    assert TH._resolve_frontier_width(
        with_(sync_tiers="classic"), cuda) == 2048
    assert TH._resolve_frontier_width(
        dataclasses.replace(with_(sync_tiers="classic"), lanes=8 * 24576),
        cuda) == 16384
    assert TH._resolve_frontier_width(with_(frontier_width=77), cuda) == 77
    for bad in (dict(tail_follow=-1), dict(sync_tiers="wide")):
        with pytest.raises(ValueError):
            T.Tuning(**bad)


MATRIX = ("noise_q98", "rand_420_rst2", "opt_huff_q97",
          "four_component_non_interleaved", "gray_rst3")


@pytest.mark.parametrize("tiers", ["classic", "ladder"])
def test_decode_under_tiers_matches_golden(test_image, noise_image, tiers):
    """decode under a plan with the tiers at tiny widths == golden on a few
    matrix streams, and on the deep stream under the records write path."""
    tuning = (T.Tuning(sync_tiers="classic", frontier_width=4, head_width=2,
                       tail_width=1)
              if tiers == "classic"
              else T.Tuning(sync_tiers="ladder", frontier_width=32))
    streams = dict(torch_cases.matrix_streams(test_image, noise_image))
    cases = [(streams[name], tuning) for name in MATRIX]
    cases.append((_deep_stream(restart_interval=4),
                  dataclasses.replace(tuning, write_mode="tiles")))
    for data, tun in cases:
        plan = pipeline.build_plan(T.parse(data), tuning=tun)
        planes = pipeline.decode_jpeg_device(data, device="cpu", plan=plan)
        expect = golden.decode(data)
        assert len(planes) == len(expect)
        for a, b in zip(planes, expect):
            assert np.array_equal(np.asarray(a), b)


def test_callers_take_the_tiers(monkeypatch):
    """A plan built under a tier tuning takes the tiers in every caller of
    sync_states: the subsequence shards of decode_sharded (with their
    entry states), the merged batch, and the debug mode's invariant checks
    of a Decoder under the process default tuning; each == golden."""
    from jpeggpu_tpu_torch import debug
    from jpeggpu_tpu_torch.parallel import BatchDecoder, make_mesh

    calls = []
    gathered = TH.subseq_pass_at_plain

    def count_gathered(*a, **k):
        calls.append(a[3].numel())
        return gathered(*a, **k)

    monkeypatch.setattr(TH, "subseq_pass_at_plain", count_gathered)
    tuning = T.Tuning(sync_tiers="classic", frontier_width=8)
    data = _deep_stream()
    expect = golden.decode(data)

    def check(planes):
        assert len(planes) == len(expect)
        for a, b in zip(planes, expect):
            assert np.array_equal(np.asarray(a), b)

    plan = pipeline.build_plan(T.parse(data), tuning=tuning)
    st = S._stage(data, plan, 0, make_mesh(["cpu"] * 2), "subsequences")
    blocks = S.decode_scan_staged(st)
    check(S.assemble(plan, {c[0]: b for c, b in zip(st.sp.comps, blocks)}))
    assert calls, "the sharded decode took no compacted round"

    base = T.default_tuning()
    T.set_default_tuning(tuning)
    try:
        del calls[:]
        dec = BatchDecoder(device="cpu")
        out = dec.decode([data, data])
        assert dec.routes == [("merged", (0, 1))]
        for planes in out:
            check(planes)
        assert calls, "the merged batch took no compacted round"
        rounds = []
        for on in (False, True):
            del calls[:]
            debug.set_debug(on)
            with T.Decoder(device="cpu") as d:
                d.parse_header(data)
                d.transfer()
                check(d.decode())
            rounds.append(len(calls))
        # the invariant checks sync once more, through the tiers
        assert 0 < rounds[0] < rounds[1], rounds
    finally:
        debug.set_debug(False)
        T.set_default_tuning(base)
