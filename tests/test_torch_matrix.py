"""PyTorch port, the whole bit-exact matrix as one mixed batch on the CPU.

Every stream of the JAX package's bit-exact matrix
(``tests/test_device_bitexact.py``) and the four robustness streams of
``tests/test_robustness.py`` that decode (``torch_cases.matrix_streams``,
made with the port's encoder from the same images) go through one
``decode_batch(datas, device="cpu")`` call, grouped as the batch groups
them, and a subset once more through the records write path in both tile
shapes. Each image == the port's numpy ``golden``. No JAX.

Tolerance: none, every comparison is ``np.array_equal``.
"""

import numpy as np
import pytest

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import golden
from jpeggpu_tpu_torch.parallel import BatchDecoder

import torch_cases

NAMES = torch_cases.MATRIX_NAMES
# the records write path's subset, within the file's time: 4:2:0 with
# restarts, optimal tables, a dense noise stream, a flat one whose lanes
# drain through the leftover scatter, an empty last restart segment. The
# whole matrix runs through both tile shapes in chip_smoke.py
TILES_NAMES = ["420_rst7", "opt_huff_rst", "noise_q98", "flat",
               "dangling_rst"]


@pytest.fixture(scope="module")
def streams(test_image, noise_image):
    out = dict(torch_cases.matrix_streams(test_image, noise_image))
    assert sorted(out) == sorted(NAMES)
    return out


def _batch(datas, tuning=None):
    base = T.default_tuning()
    if tuning is not None:
        T.set_default_tuning(tuning)
    try:
        dec = BatchDecoder(device="cpu")
        return dec.decode(datas), dec.routes
    finally:
        T.set_default_tuning(base)


@pytest.fixture(scope="module")
def matrix_batch(streams):
    out, routes = _batch([streams[n] for n in NAMES])
    return dict(zip(NAMES, out)), routes


@pytest.fixture(scope="module")
def tiles_batches(streams):
    return {mode: dict(zip(TILES_NAMES, _batch(
        [streams[n] for n in TILES_NAMES],
        T.Tuning(write_mode="tiles", tile_mode=mode))[0]))
        for mode in ("super", "lane")}


def _assert_golden(data, planes):
    expect = golden.decode(data)
    assert len(planes) == len(expect)
    for a, b in zip(planes, expect):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_matrix_batch_matches_golden(streams, matrix_batch, name):
    _assert_golden(streams[name], matrix_batch[0][name])


def test_matrix_batch_groups(matrix_batch):
    """The batch decoded every image exactly once. A group merges only
    where all its images share their Huffman tables, as in the reference:
    gray with the gray garbage body, and the two noise streams. The 4:2:0
    images of the test image share one geometry but not their tables (the
    frequency-optimal ones differ) and decode one by one."""
    _, routes = matrix_batch
    done = sorted(i for _, images in routes for i in images)
    assert done == list(range(len(NAMES)))
    merged = sorted(tuple(NAMES[i] for i in images)
                    for route, images in routes if route == "merged")
    assert merged == [("gray", "garbage_body"), ("noise_q98", "noise_q100")]
    assert all(route in ("merged", "per_image") for route, _ in routes)


@pytest.mark.parametrize("mode", ["super", "lane"])
@pytest.mark.parametrize("name", TILES_NAMES)
def test_matrix_tiles_batch_matches_golden(streams, tiles_batches, mode,
                                           name):
    _assert_golden(streams[name], tiles_batches[mode][name])
