"""The frozen reference against the port's plain path on the host, and the
row permutation against the reference's permuted planes."""

import numpy as np
import pytest
import torch

from benchmark.inputs import make_pool
from benchmark.reference import golden
from benchmark.reference.parallel import decode_all, strips
from benchmark.reference.rows import Rows
from benchmark.traffic import Stream, row_cuts

from small import CELLS, small_params

CPU = torch.device("cpu")


def port_decode(data):
    from jpeggpu_tpu_torch.api import Decoder

    d = Decoder(device="cpu")
    d.parse_header(data)
    d.transfer()
    return d.decode()


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_port_plain_path(cell):
    params = small_params(cell)
    pool = make_pool(params, 2**31 + 5, CPU)
    rows = row_cuts(pool, params)
    stream = Stream(pool, params, 2**31 + 5, sub=0, rows=rows)
    req = stream.next()
    for data, (i, perm) in zip(req.datas, req.keys):
        want = golden.decode(data)
        got = port_decode(data)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if perm is not None:  # the reference moves its own rows alike
            moved = rows[i].permute_planes(golden.decode(pool[i].data), perm)
            for g, w in zip(got, moved):
                np.testing.assert_array_equal(g, w)


def test_permutation_moves_whole_rows():
    params = small_params("photo12mp.rst")
    data = make_pool(params, 9, CPU)[0].data
    rows = Rows(data)
    assert rows.rows == 6
    perm = (5, 0, 3, 1, 4, 2)
    base = golden.decode(data)
    got = golden.decode(rows.permuted(perm))
    for g, b, k in zip(got, base, rows.comp_rows):
        for r, p in enumerate(perm):
            np.testing.assert_array_equal(g[r * k:(r + 1) * k],
                                          b[p * k:(p + 1) * k])


@pytest.mark.parametrize("n", [1, 2, 4, 6])
def test_strips_stack_to_the_whole(n):
    params = small_params("photo12mp.rst")
    data = make_pool(params, 11, CPU)[0].data
    parts = strips(data, n)
    assert len(parts) == -(-6 // -(-6 // n))  # strips of whole rows, <= n
    whole = golden.decode(data)
    for got, want in zip(decode_all([data], n), [whole]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_no_restart_stream_is_one_segment():
    params = small_params("photo12mp.norst")
    data = make_pool(params, 13, CPU)[0].data
    from benchmark.reference.reader import parse

    stream = parse(data)
    assert stream.restart_interval == 0
    assert stream.scans[0].num_segments == 1
    assert strips(data, 4) == [data]


def test_imagenet_pool_mix():
    from benchmark.inputs import geometries
    from benchmark.run import load_cell

    _, params = load_cell("imagenet_loader.b32")
    sizes = geometries(params, params["pool"])
    assert len(sizes) == 64
    assert sizes.count((500, 375)) == 32
    assert sizes.count((375, 500)) + sizes.count((500, 333)) >= 19
    odd = sizes[-13:]
    assert all(300 <= w <= 500 and 300 <= h <= 500 for w, h in odd)
    assert geometries(params, 64) == sizes  # the same set for every seed
