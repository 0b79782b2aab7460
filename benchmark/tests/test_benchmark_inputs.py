"""The generator's images: the small pools of the cells pinned byte for
byte, so that a change to the generator which changes a cell's inputs
fails here."""

import hashlib

import pytest
import torch

from benchmark.inputs import make_pool

from small import small_params

CPU = torch.device("cpu")
SEEDS = (1, 2**31 + 77)
# sha256 of the small pools' bytes, image after image
POOL_SHA256 = {
    ("imagenet_loader.b32", SEEDS[0]):
        "d87902da1484057704eaa0188f1a267bd6c761943df28e80b2fc1ddec7ae0fdb",
    ("imagenet_loader.b32", SEEDS[1]):
        "85d0a3a467da0bc4b11926ecb4f96173e3033b611cdb8539af8f3ffb94dc38c0",
    # the configuration fixes the frames (`content_seed`): one digest
    ("photo12mp.rst", SEEDS[0]):
        "d39777a6011f38bfed7c256123a557bf7f73441314b548e799ab0d9992a73f32",
    ("photo12mp.rst", SEEDS[1]):
        "d39777a6011f38bfed7c256123a557bf7f73441314b548e799ab0d9992a73f32",
}


def pool_sha256(params, seed):
    h = hashlib.sha256()
    for im in make_pool(params, seed, CPU):
        h.update(im.data)
    return h.hexdigest()


@pytest.mark.parametrize("cell,seed", sorted(POOL_SHA256))
def test_pools_are_pinned(cell, seed):
    assert pool_sha256(small_params(cell), seed) == POOL_SHA256[cell, seed]
