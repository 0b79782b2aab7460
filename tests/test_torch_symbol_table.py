"""PyTorch port, the one-lookup symbol table of kernels K1 and K2 and K1's
whole sync round, on the CPU. Imports no JAX.

(a) The table (``ops.huffman.build_symbol_table``) and the tensor model of
the kernels' table decode (``_decode_symbol_table``: one lookup keyed by the
next SYMTAB_BITS bits in the data unit's slot for z, the escape to the full
search) give what ``_decode_symbol`` gives (length, category, run, value)
for every Huffman table of the 11 streams of ``torch_cases.CASES``, for
every SYMTAB_BITS-bit prefix with random 32-bit tails, and on made-up
tables: a saturated one, DC categories above 15 (the 32-bit symbols that
take the reader's seek), codes up to 16 bits, and random 32-bit words.
(b) The plain sync round (``subseq_pass_plain``, K1's plain version, the
semantics of the kernel's one launch per round) equals the composition
``sync_states`` ran before K1 took the round over: ``torch.roll``, the pass,
the freeze of padded lanes and ``roll(delta, 1) & frontier_ok``, round by
round, flags and round count included, with and without a shard's entry
state.

Tolerance: none, every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import constants as C
from jpeggpu_tpu_torch import convert, golden, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.ops import huffman as TH
from jpeggpu_tpu_torch.parallel import segments as S

import torch_cases

_NB = TH.SYMTAB_BITS
_TAILS = 4  # random tails per prefix


def _reference(cfg, t, data, c, z):
    """(length, category, run, value) of ``_decode_symbol``, the category
    as length minus the code length that ``_code`` finds."""
    length, value, run = TH._decode_symbol(cfg, t, data, c, z)
    pair = t.slots.index_select(0, c)
    tbl = torch.where(z == 0, pair[:, 0], pair[:, 1])
    cat = length - TH._code(cfg.fast_tables, t, data, tbl)[0]
    return length, cat, run, value


def _check_model(cfg, t, symtab, data, c, z):
    """The model against the reference on one batch of symbols; returns
    the share of escaped symbols."""
    symtab = torch.from_numpy(np.asarray(symtab)).to(torch.int64)
    got = TH._decode_symbol_table(cfg, t, symtab, data, c, z)
    expect = _reference(cfg, t, data, c, z)
    for what, a, b in zip(("length", "category", "run", "value"), got,
                          expect):
        assert torch.equal(a, b), what
    pair = t.slots.index_select(0, c)
    off = torch.where(z == 0, pair[:, 0], pair[:, 1]) << _NB
    f = symtab[off + (data >> (32 - _NB))]
    return float(((f & TH.SYMTAB_ESC) != 0).double().mean())


def _every_prefix(rng, du_per_mcu):
    """Every (data unit, class, prefix) with _TAILS random tails each:
    z = 0 for DC, a random z in [1, 64) for AC."""
    n = 1 << _NB
    c = np.repeat(np.arange(du_per_mcu), 2 * n * _TAILS)
    is_ac = np.tile(np.repeat([0, 1], n * _TAILS), du_per_mcu)
    z = np.where(is_ac == 1, rng.integers(1, 64, c.size), 0)
    prefix = np.tile(np.repeat(np.arange(n), _TAILS), 2 * du_per_mcu)
    tail = rng.integers(0, 1 << (32 - _NB), c.size)
    data = (prefix.astype(np.int64) << (32 - _NB)) | tail
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in (data, c, z))


@pytest.mark.parametrize("name", torch_cases.CASES)
def test_table_model_matches_decode_symbol(test_image, name):
    """Every Huffman table a scan of the stream names, every prefix, random
    tails: the table decode == _decode_symbol, under the scan's
    fast_tables (the saturated case runs the maxcode walk)."""
    data = torch_cases.case_data(name, test_image)
    plan = pipeline.build_plan(T.parse(data))
    inputs = pipeline.build_inputs(data, plan)
    staged = pipeline.stage_inputs(inputs, plan, torch.device("cpu"))
    rng = np.random.default_rng(5)
    escaped = []
    for sp, arrs, scan in zip(plan.signature.scans, staged["scans"],
                              inputs["scans"]):
        cfg = sp.cfg
        # the staged table (convert.symbol_table, built once per set of
        # tables) is the builder's under the plan's fast_tables
        symtab = TH.build_symbol_table(scan["maxcode"], scan["vsm"],
                                       scan["huffval"], cfg.fast_tables)
        assert np.array_equal(arrs.symtab.numpy(), symtab)
        t = TH._plain_operands(arrs, TH.make_ctx(cfg, arrs))
        escaped.append(_check_model(cfg, t, symtab,
                                    *_every_prefix(rng, cfg.du_per_mcu)))
    if name == "saturated_table":
        assert not plan.signature.scans[0].cfg.fast_tables
    # codes of more than SYMTAB_BITS bits escape; most prefixes do not
    assert max(escaped) < 0.5


# (tables of ops.huffman.MADE_UP_TABLES, the (DC, AC) slots to read)
_MADE_UP = {"saturated": ("saturated", (0, 1)),
            "dc_categories_above_15": ("garbage", (0, 3)),
            "long_codes": ("garbage", (2, 1))}


@pytest.mark.parametrize("kind", ["saturated", "dc_categories_above_15",
                                  "long_codes"])
def test_table_model_on_made_up_tables(kind):
    """Made-up tables, every prefix with random tails and random 32-bit
    words: the table decode == _decode_symbol, escapes and seeks included."""
    tables, (dc, ac) = _MADE_UP[kind]
    maxcode, vsm, huffval, fast = TH.made_up_tables(tables)
    assert fast == (kind != "saturated")
    cfg = TH.ScanConfig(lanes=1, num_segments=1, du_per_mcu=2, mcus_per_seg=1,
                        total_mcus=1, comp_groups=((2, dc, ac),),
                        fast_tables=fast)
    symtab = TH.build_symbol_table(maxcode, vsm, huffval, fast)
    i64 = torch.int64
    mc = torch.from_numpy(maxcode)
    t = TH._Plain(words=None, lead=0, word_end=None, seg_base_bits=None,
                  end_subseq=None,
                  slots=torch.tensor([[dc, ac], [dc, ac]], dtype=i64),
                  limits=TH._limits(mc).to(i64) & TH._M32,
                  maxcode=mc.to(i64), vsm=torch.from_numpy(vsm).to(i64),
                  huffval=torch.from_numpy(huffval).to(i64))
    rng = np.random.default_rng(17)
    data, c, z = _every_prefix(rng, 2)
    share = _check_model(cfg, t, symtab, data, c, z)
    words = torch.from_numpy(rng.integers(0, 1 << 32, data.numel()))
    _check_model(cfg, t, symtab, words, c, z)
    length = TH._decode_symbol(cfg, t, words, c, z)[0]
    if kind == "dc_categories_above_15":
        assert bool((length >= 32).any())  # the reader's seek
    if kind == "long_codes":
        assert share > 0.4  # the long codes escape
    assert 0 < share < 1


# --- the plain round against the composition it replaced --------------------

def _composition(cfg, arrs, ctx, entry=None):
    """sync_states as it was composed around K1 before K1 ran the round:
    yields the (p, c, z, n) of every round and, for each shifted round, its
    convergence test."""
    lanes = cfg.lanes
    blind_p = ctx.rel * C.SUBSEQ_SIZE_BITS
    zeros = torch.zeros_like(blind_p)
    first = ctx.first_of_seg
    valid = ctx.lane_valid
    frontier_ok = ~first & valid
    if entry is not None:
        frontier_ok = frontier_ok & (
            torch.arange(lanes, device=valid.device) > 0)
    p, c, z, n = TH.decode_pass_plain(cfg, arrs, ctx, blind_p, zeros, zeros,
                                      valid)
    yield (p, c, z, n), None
    for _ in range(lanes + 1):
        sp = torch.where(first, blind_p, torch.roll(p, 1))
        sc = torch.where(first, zeros, torch.roll(c, 1))
        sz = torch.where(first, zeros, torch.roll(z, 1))
        sp, sc, sz = TH._enter(ctx, (sp, sc, sz), entry)
        p2, c2, z2, n2 = TH.decode_pass_plain(cfg, arrs, ctx, sp, sc, sz,
                                              valid)
        p2 = torch.where(valid, p2, blind_p)
        c2 = torch.where(valid, c2, zeros)
        z2 = torch.where(valid, z2, zeros)
        n2 = torch.where(valid, n2, zeros)
        delta = (p2 != p) | (c2 != c) | (z2 != z)
        p, c, z, n = p2, c2, z2, n2
        more = bool((torch.roll(delta, 1) & frontier_ok).any())
        yield (p, c, z, n), more
        if not more:
            break


def _rounds(cfg, arrs, ctx, entry=None):
    """The same rounds through subseq_pass (its plain version on the CPU),
    as sync_states drives it."""
    valid = ctx.lane_valid
    flags = torch.zeros(cfg.lanes + 1, dtype=torch.int32)
    p, c, z, n = TH.subseq_pass(cfg, arrs, ctx, None, None, None, valid)
    yield (p, c, z, n), None
    for r in range(cfg.lanes + 1):
        p, c, z, n = TH.subseq_pass(cfg, arrs, ctx, p, c, z, valid,
                                    entry=entry, flag=flags[r:r + 1])
        yield (p, c, z, n), bool(flags[r])
        if not flags[r]:
            break


def _stream(seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (6, 8, 3)).astype(np.uint8)
    img = np.repeat(np.repeat(base, 24, 0), 24, 1)[:128, :160]
    img = np.clip(img + rng.normal(0, 9, img.shape), 0, 255).astype(np.uint8)
    return encode(img, EncodeSpec(sampling=torch_cases.S420))


@pytest.mark.parametrize("entry_kind", [None, "golden", "shifted"])
def test_plain_round_matches_composition(entry_kind):
    """Round by round: the same states, the same convergence flags and the
    same round count. Without entry: the whole scan of a stream with no
    restart markers. With entry: shard 1 of two subsequence shards, entered
    from golden's boundary state or from that state one bit on (a wrong
    entry, which the rounds must carry as the composition did)."""
    data = _stream()
    plan = pipeline.build_plan(T.parse(data))
    entry = None
    if entry_kind is None:
        cfg = plan.signature.scans[0].cfg
        arrs = pipeline.stage_inputs(pipeline.build_inputs(data, plan), plan,
                                     torch.device("cpu"))["scans"][0]
        ctx = TH.make_ctx(cfg, arrs)
    else:
        shp = S.plan_subseq_shards(plan, 2)
        inputs = S.build_subseq_shard_inputs(data, plan, shp)
        cfg = shp.cfg
        arrs = convert.shard_arrays(inputs, 1, "cpu", cfg.fast_tables)
        ctx = TH.make_ctx(cfg, arrs, num_subseq=int(inputs["n_subseq"][1, 0]))
        stream = plan.stream
        states = golden.sequential_boundary_states(
            stream, stream.scans[0], np.frombuffer(data, np.uint8))
        entry = [int(v) for v in states[shp.bounds[1] - 1, :3]]
        if entry_kind == "shifted":
            entry[0] += 1
        entry = tuple(entry)
    old = list(_composition(cfg, arrs, ctx, entry))
    new = list(_rounds(cfg, arrs, ctx, entry))
    assert len(new) == len(old) >= 3
    for (got, flag), (expect, more) in zip(new, old):
        assert flag == more
        for a, b in zip(got, expect):
            assert a.dtype == torch.int32 and torch.equal(a, b)
    # and sync_states returns the last round's states
    final = TH.sync_states(cfg, arrs, ctx, entry=entry)
    for a, b in zip(final, old[-1][0]):
        assert torch.equal(a, b)
