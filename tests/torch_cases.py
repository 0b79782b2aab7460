"""The matrix of streams of the port's entropy-decode tests
(``test_torch_huffman.py``, ``test_torch_symbol_table.py``): eleven small
streams made with the port's numpy encoder, each a shape of stream the
decoder has to get right. Imports no JAX."""

import numpy as np

from jpeggpu_tpu_torch.encoder import EncodeSpec, encode

S420 = [(2, 2), (1, 1), (1, 1)]


def saturated_stream():
    counts1 = np.zeros(16, np.uint8)
    counts1[0] = 2  # two 1-bit codes: the code space saturates at length 1
    overrides = {
        (0, 0): (counts1, np.array([0, 1], np.uint8)),
        (1, 0): (counts1, np.array([0x00, 0x11], np.uint8)),
    }
    img = np.full((24, 32), 127, np.uint8)
    return encode(img, EncodeSpec(huff_overrides=overrides, quality=50))


def case_data(name, image):
    """Stream `name` of CASES, made with the port's encoder from `image`
    (the `test_image` fixture)."""
    small = image[:24, :40]
    four = [small[..., 0], small[..., 1], small[..., 2], 255 - small[..., 0]]
    makers = {
        "420_rst2": lambda: encode(small, EncodeSpec(
            sampling=S420, restart_interval=2)),
        "420_rst7": lambda: encode(small, EncodeSpec(
            sampling=S420, restart_interval=7)),
        "444": lambda: encode(small, EncodeSpec(sampling=[(1, 1)] * 3)),
        "422": lambda: encode(small, EncodeSpec(
            sampling=[(2, 1), (1, 1), (1, 1)])),
        "gray": lambda: encode(small[..., 0]),
        "non_interleaved": lambda: encode(small, EncodeSpec(
            sampling=S420, interleaved=False)),
        "four_component": lambda: encode(four, EncodeSpec(
            sampling=[(1, 1)] * 4)),
        "tiny": lambda: encode(np.full((1, 1), 128, np.uint8)),
        "saturated_table": saturated_stream,
        "flat": lambda: encode(np.full((64, 96, 3), 200, np.uint8),
                               EncodeSpec(sampling=S420)),
        "per_scan_dht": lambda: encode(small, EncodeSpec(
            sampling=[(1, 1)] * 3, interleaved=False,
            table_ids=[(0, 0)] * 3, dht_per_scan=True)),
    }
    return makers[name]()


CASES = ["420_rst2", "420_rst7", "444", "422", "gray", "non_interleaved",
         "four_component", "tiny", "saturated_table", "flat", "per_scan_dht"]
