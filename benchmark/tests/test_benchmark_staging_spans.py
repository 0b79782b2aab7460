"""The readers of the port's host-staging ranges (``host_destuff_ms``,
``copy_in_ms``) on hand-made profiler windows: what each counts, the
division by traced images, and None where the program has no such range
(the parent of the change that added them) or no trace."""

import pytest

from benchmark.profiler import Window
from benchmark.records import Records, load_reader

READERS = ["host_destuff_ms", "copy_in_ms"]


def record(ranges, images=1):
    rec = Records()
    rec.trace = Window(device=[], ranges=list(ranges), wall_s=1.0, lost=0)
    rec.traced_inputs = [b""] * images
    return rec


def read(name, rec):
    return load_reader("layers", name)(rec)


# two Decoder.transfer calls: the wait, then the host staging with its
# destuff and a symbol-table build, then the copy
DECODER = [("bench.transfer", 0.0, 5_000.0),
           ("jpeggpu.copy_in.wait", 100.0, 400.0),
           ("jpeggpu.inputs", 400.0, 3_000.0),
           ("jpeggpu.destuff.host", 500.0, 2_500.0),
           ("jpeggpu.symtab", 2_600.0, 2_800.0),
           ("jpeggpu.copy_in", 3_000.0, 4_000.0),
           ("bench.transfer", 10_000.0, 14_000.0),
           ("jpeggpu.copy_in.wait", 10_100.0, 10_150.0),
           ("jpeggpu.inputs", 10_150.0, 12_000.0),
           ("jpeggpu.destuff.host", 10_200.0, 11_700.0),
           ("jpeggpu.copy_in", 12_000.0, 12_500.0)]


def test_host_destuff_per_traced_image():
    # 2000 + 1500 us over two images
    assert read("host_destuff_ms", record(DECODER, 2)) == pytest.approx(1.75)
    assert read("host_destuff_ms", record(DECODER, 1)) == pytest.approx(3.5)


def test_copy_in_with_its_wait():
    # copy_in 1000 + 500, waits 300 + 50
    assert read("copy_in_ms", record(DECODER, 2)) == pytest.approx(
        1.85 / 2)


def test_copy_in_leaves_out_a_symbol_table_inside_it():
    """A batch: the wait under the root, a merged scan's copy holding a
    symbol-table build (arrays staged without a region)."""
    ranges = [("jpeggpu.batch", 0.0, 10_000.0),
              ("jpeggpu.copy_in.wait", 10.0, 110.0),
              ("jpeggpu.copy_in", 5_000.0, 6_000.0),
              ("jpeggpu.symtab", 5_200.0, 5_700.0)]
    assert read("copy_in_ms", record(ranges, 4)) == pytest.approx(0.6 / 4)
    assert read("host_destuff_ms", record(ranges, 4)) is None


@pytest.mark.parametrize("name", READERS)
def test_no_trace_reads_none(name):
    assert read(name, Records()) is None


@pytest.mark.parametrize("name", READERS)
def test_absent_as_on_the_parent(name):
    """The parent's transfer has ``jpeggpu.inputs`` and ``jpeggpu.copy_in``
    but neither new range: ``host_destuff_ms`` reads None; ``copy_in_ms``
    reads the copy's self time alone, as the parent has no wait."""
    ranges = [r for r in DECODER if r[0] not in (
        "jpeggpu.copy_in.wait", "jpeggpu.destuff.host")]
    value = read(name, record(ranges, 2))
    if name == "host_destuff_ms":
        assert value is None
    else:
        assert value == pytest.approx(1.5 / 2)
    assert read(name, record([("bench.transfer", 0.0, 10.0)])) is None
