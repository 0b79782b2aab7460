"""PyTorch port, the tracing ranges (``debug.scope``) on the CPU.

In a CPU ``torch.profiler`` window: a ``BatchDecoder.decode`` of a small
batch (one merged group of two images, one image on the per-image route)
opens every ``jpeggpu.*`` range of the host path, nested as
``debug``'s docstring states; a ``Decoder`` run through its phases opens
its own; a symbol-table build opens one ``jpeggpu.symtab`` a cache miss.
Outside a profiler ``scope`` opens no ``record_function`` at all.

A range's parent is found as the profiler records it: the innermost other
range that encloses it on the same host thread. No JAX: the planes are held
against the port's numpy ``golden``. Tolerance: none.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import api, convert, debug, golden, pipeline
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.parallel import BatchDecoder

_CPU = torch.device("cpu")
_S420 = [(2, 2), (1, 1), (1, 1)]
BATCH_SPANS = {
    "jpeggpu.batch", "jpeggpu.parse", "jpeggpu.plan", "jpeggpu.group",
    "jpeggpu.inputs", "jpeggpu.destuff.host", "jpeggpu.merge",
    "jpeggpu.copy_in", "jpeggpu.copy_in.wait", "jpeggpu.symtab",
    "jpeggpu.sync", "jpeggpu.sync.read", "jpeggpu.write.fused",
    "jpeggpu.tail", "jpeggpu.dc", "jpeggpu.idct_fused", "jpeggpu.to_host",
}
DECODER_SPANS = {
    "jpeggpu.parse", "jpeggpu.plan", "jpeggpu.inputs", "jpeggpu.copy_in",
    "jpeggpu.copy_in.wait", "jpeggpu.destuff.host",
    "jpeggpu.sync", "jpeggpu.tail", "jpeggpu.to_host",
}


def _image(seed, w, h):
    """A smooth RGB image: few symbols, so the plain decode stays short."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (x * rng.integers(1, 4) + y * rng.integers(1, 4)) % 256
    return np.stack([base, 255 - base, np.full_like(base, 128)],
                    -1).astype(np.uint8)


def _batch():
    """Two 32x16 images with the standard tables (one merged group) and a
    16x16 one with tables of its own (a group of one: the per-image
    route)."""
    pair = [encode(_image(seed, 32, 16),
                   EncodeSpec(quality=50, sampling=_S420, restart_interval=1))
            for seed in (1, 2)]
    return pair + [encode(_image(3, 16, 16),
                          EncodeSpec(quality=50, sampling=_S420,
                                     optimize_huffman=True))]


def _spans(prof):
    """The window's ``jpeggpu.*`` ranges: (name, start ns, end ns,
    thread)."""
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("jpeggpu.")]


def _parent(span, spans):
    """The innermost other range that encloses ``span`` on its thread."""
    _, a, b, tid = span
    around = [s for s in spans if s is not span and s[3] == tid
              and s[1] <= a and b <= s[2]]
    return min(around, key=lambda s: s[2] - s[1]) if around else None


def _ancestors(span, spans):
    out = []
    while (span := _parent(span, spans)) is not None:
        out.append(span[0])
    return out


def _assert_golden(datas, out):
    for data, planes in zip(datas, out):
        expect = golden.decode(data)
        assert len(planes) == len(expect)
        for a, b in zip(planes, expect):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def one_thread():
    """The plain decodes on one intra-op thread, beside the test run's
    other busy workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced_batch(one_thread):
    """Two profiled decodes of one batch, the first after the symbol-table
    cache was cleared: the batch, the routes and per decode (planes,
    ranges)."""
    datas = _batch()
    dec = BatchDecoder(device="cpu")
    convert._symbol_table.cache_clear()
    windows = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = dec.decode(datas)
        windows.append((out, _spans(prof)))
    return datas, dec.routes, windows


def test_batch_opens_every_span(traced_batch):
    _, routes, windows = traced_batch
    assert routes == [("merged", (0, 1)), ("per_image", (2,))]
    names = {s[0] for s in windows[0][1]}
    assert names >= BATCH_SPANS, BATCH_SPANS - names


def test_batch_spans_nest(traced_batch):
    _, _, windows = traced_batch
    spans = windows[0][1]
    roots = [s for s in spans if s[0] == "jpeggpu.batch"]
    assert len(roots) == 1 and _parent(roots[0], spans) is None
    for s in spans:
        if s is not roots[0]:
            assert _ancestors(s, spans)[-1] == "jpeggpu.batch", s
    reads = [s for s in spans if s[0] == "jpeggpu.sync.read"]
    assert reads and all(_ancestors(s, spans) == ["jpeggpu.sync",
                                                  "jpeggpu.batch"]
                         for s in reads)
    dcs = [s for s in spans if s[0] == "jpeggpu.dc"]
    assert dcs and all(_parent(s, spans)[0] == "jpeggpu.tail" for s in dcs)
    copies = [s for s in spans if s[0] == "jpeggpu.copy_in"]
    assert copies and all(_ancestors(s, spans) == ["jpeggpu.batch"]
                          for s in copies)
    # one wait for the last call's copies, before the batch writes over
    # its staging buffer; one host destuff an image, inside its staging
    waits = [s for s in spans if s[0] == "jpeggpu.copy_in.wait"]
    assert len(waits) == 1 and _ancestors(waits[0], spans) == [
        "jpeggpu.batch"]
    destuffs = [s for s in spans if s[0] == "jpeggpu.destuff.host"]
    assert len(destuffs) == 3 and all(
        _ancestors(s, spans) == ["jpeggpu.inputs", "jpeggpu.batch"]
        for s in destuffs)
    # one tail a scan of the merged group (its two images at once) and one
    # of the image on its own; one merge a scan of the merged group
    assert sum(s[0] == "jpeggpu.tail" for s in spans) == 2
    assert sum(s[0] == "jpeggpu.merge" for s in spans) == 1


def test_batch_planes_equal_golden(traced_batch):
    datas, _, windows = traced_batch
    for out, _ in windows:
        _assert_golden(datas, out)


def test_symbol_table_span_per_cache_miss(traced_batch):
    """After ``cache_clear()`` the first decode builds one table per
    distinct set of Huffman tables, each in one ``jpeggpu.symtab``; the
    second builds none."""
    datas, _, windows = traced_batch
    sets = set()
    for data in datas:
        plan = pipeline.build_plan(T.parse(data))
        for s, sp in zip(pipeline.build_inputs(data, plan)["scans"],
                         plan.signature.scans):
            sets.add((s["maxcode"].tobytes(), s["vsm"].tobytes(),
                      s["huffval"].tobytes(), sp.cfg.fast_tables))
    assert len(sets) == 2
    builds = [sum(s[0] == "jpeggpu.symtab" for s in spans)
              for _, spans in windows]
    assert builds == [len(sets), 0]


def test_decoder_phases_open_their_spans(one_thread):
    data = _batch()[0]
    d = api.Decoder(device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        d.parse_header(data)
        d.transfer()
        planes = d.decode()
    spans = _spans(prof)
    names = {s[0] for s in spans}
    assert names >= DECODER_SPANS, DECODER_SPANS - names
    # the host destuff and the copy-in are apart, each at the top, and so
    # is the wait for the last copy before the staging buffer is rewritten
    for name in ("jpeggpu.inputs", "jpeggpu.copy_in", "jpeggpu.parse",
                 "jpeggpu.plan", "jpeggpu.to_host", "jpeggpu.copy_in.wait"):
        assert all(_parent(s, spans) is None for s in spans if s[0] == name)
    destuffs = [s for s in spans if s[0] == "jpeggpu.destuff.host"]
    assert len(destuffs) == 1
    assert _parent(destuffs[0], spans)[0] == "jpeggpu.inputs"
    _assert_golden([data], [planes])


def test_scope_opens_no_record_function_outside_a_profiler(monkeypatch,
                                                           one_thread):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    data = _batch()[0]
    _assert_golden([data], [T.decode(data, device="cpu")])
    with debug.scope("jpeggpu.probe", _CPU):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with debug.scope("jpeggpu.probe", _CPU):
            pass
    assert opened == ["jpeggpu.probe"]
