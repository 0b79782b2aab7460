"""The readers of the program's ranges (``benchmark/spans.py`` and the
per-layer metrics that read it) on hand-made profiler windows: self time,
the division by traced images, None where the program has no such range,
and the share of idle time that a range of the program names."""

import pytest

from benchmark.profiler import Window
from benchmark.records import Records, load_reader
from benchmark.spans import self_us, union_us

SPAN_METRICS = ["plan_self_ms", "staging_self_ms", "sync_read_ms", "tail_ms",
                "to_host_ms"]


def record(ranges, device=(), images=1):
    rec = Records()
    rec.trace = Window(device=list(device), ranges=list(ranges), wall_s=1.0,
                       lost=0)
    rec.traced_inputs = [b""] * images
    return rec


def read(name, rec):
    return load_reader("layers", name)(rec)


def test_union_merges_overlaps():
    assert union_us([(0, 10), (5, 20), (30, 40), (40, 41)]) == 31
    assert union_us([]) == 0


def test_self_time_with_nested_children():
    parent = ("jpeggpu.plan", 0.0, 100.0)
    ranges = [("jpeggpu.batch", -5.0, 200.0), parent,
              ("jpeggpu.parse", 10.0, 20.0), ("jpeggpu.group", 15.0, 30.0),
              ("jpeggpu.inputs", 50.0, 60.0),
              ("jpeggpu.symtab", 52.0, 55.0)]  # a grandchild
    # children cover [10, 30] and [50, 60]
    assert self_us(parent, ranges) == 70.0
    assert self_us(ranges[0], ranges) == 205.0 - 100.0


def test_self_time_with_a_child_over_the_parents_edge():
    parent = ("jpeggpu.copy_in", 10.0, 50.0)
    ranges = [parent, ("jpeggpu.symtab", 0.0, 20.0),
              ("jpeggpu.symtab", 45.0, 70.0)]
    # clipped to the parent: [10, 20] and [45, 50]
    assert self_us(parent, ranges) == 25.0


def test_span_metrics_per_traced_image():
    ranges = [("bench.batch", 0.0, 10_000.0),
              ("jpeggpu.batch", 100.0, 9_900.0),
              ("jpeggpu.parse", 200.0, 400.0),
              ("jpeggpu.plan", 400.0, 1_000.0),
              ("jpeggpu.group", 1_000.0, 1_100.0),
              ("jpeggpu.inputs", 1_100.0, 2_100.0),
              ("jpeggpu.merge", 2_100.0, 2_300.0),
              ("jpeggpu.copy_in", 2_300.0, 3_300.0),
              ("jpeggpu.symtab", 2_500.0, 2_900.0),
              ("jpeggpu.sync", 3_300.0, 5_300.0),
              ("jpeggpu.sync.read", 3_500.0, 3_900.0),
              ("jpeggpu.sync.read", 4_000.0, 4_400.0),
              ("jpeggpu.tail", 5_300.0, 7_300.0),
              ("jpeggpu.dc", 5_400.0, 6_000.0),
              ("jpeggpu.to_host", 7_300.0, 9_300.0)]
    rec = record(ranges, images=4)
    # 200 + 600 + 100 us over 4 images
    assert read("plan_self_ms", rec) == pytest.approx(0.9 / 4)
    # inputs 1000, merge 200, copy_in 1000 - 400 + symtab 400
    assert read("staging_self_ms", rec) == pytest.approx(2.2 / 4)
    assert read("sync_read_ms", rec) == pytest.approx(0.8 / 4)
    # the sync's 2000 us less its two reads
    assert read("sync_host_ms", rec) == pytest.approx(1.2 / 4)
    assert read("tail_ms", rec) == pytest.approx(2.0 / 4)
    assert read("to_host_ms", rec) == pytest.approx(2.0 / 4)
    assert read("tail_ms", record(ranges, images=1)) == pytest.approx(2.0)


@pytest.mark.parametrize("name", SPAN_METRICS + ["sync_host_ms",
                                                  "idle_named_share"])
def test_no_trace_reads_none(name):
    assert read(name, Records()) is None


def test_sync_host_ms_without_a_sync_range_is_none():
    ranges = [("bench.batch", 0.0, 1_000.0),
              ("jpeggpu.sync.read", 10.0, 20.0),
              ("jpeggpu.write.fused", 50.0, 60.0)]
    assert read("sync_host_ms", record(ranges)) is None


def test_sync_host_ms_reads_the_decode_stages_sync():
    """A program without the spans of its host path still has the sync's
    range, a decode stage's: its self time is the sync's host work."""
    ranges = [("jpeggpu.sync", 10.0, 50.0),
              ("jpeggpu.sync.read", 20.0, 25.0),
              ("jpeggpu.sync.read", 40.0, 60.0),  # over the sync's end
              ("jpeggpu.write.fused", 50.0, 60.0)]
    assert read("sync_host_ms", record(ranges, images=2)) == pytest.approx(
        (40.0 - 5.0 - 10.0) / 1e3 / 2)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_absent_as_on_the_parent(name):
    """The ranges a program without the spans of its host path has: the
    benchmark's own and the decode stages'."""
    ranges = [("bench.batch", 0.0, 1_000.0), ("jpeggpu.sync", 10.0, 50.0),
              ("jpeggpu.write.fused", 50.0, 60.0),
              ("jpeggpu.dc", 60.0, 70.0),
              ("jpeggpu.idct_fused", 70.0, 80.0)]
    device = [("k1", 0.0, 5.0), ("k2", 200.0, 205.0)]  # idle in bench.batch
    rec = record(ranges, device)
    assert read(name, rec) is None
    assert read("idle_named_share", rec) == pytest.approx(0.0)


def _gaps_record(ranges):
    # device work leaves three gaps of 10 us, centred at 15, 35 and 55
    device = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 40.0, 50.0),
              ("k", 60.0, 70.0)]
    return record(ranges, device)


def test_idle_named_share_in_bench_batch_only():
    rec = _gaps_record([("bench.batch", 0.0, 100.0)])
    assert read("idle_named_share", rec) == 0.0


def test_idle_named_share_in_the_root_only():
    rec = _gaps_record([("bench.batch", 0.0, 100.0),
                        ("jpeggpu.batch", 1.0, 99.0)])
    assert read("idle_named_share", rec) == 0.0


def test_idle_named_share_in_child_spans():
    ranges = [("bench.batch", 0.0, 100.0), ("jpeggpu.batch", 1.0, 99.0),
              ("jpeggpu.sync", 12.0, 38.0),
              ("jpeggpu.sync.read", 33.0, 37.0)]
    rec = _gaps_record(ranges)
    # the gaps at 15 (sync) and 35 (sync.read) are named; 55 (the root) not
    assert read("idle_named_share", rec) == pytest.approx(200.0 / 3)
    rec = _gaps_record(ranges + [("jpeggpu.to_host", 51.0, 59.0)])
    assert read("idle_named_share", rec) == pytest.approx(100.0)


def test_idle_named_share_without_idle_is_none():
    rec = record([("jpeggpu.batch", 0.0, 10.0)], [("k", 0.0, 10.0)])
    assert read("idle_named_share", rec) is None
