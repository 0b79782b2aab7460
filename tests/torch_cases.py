"""The matrices of streams of the port's tests, made with the port's numpy
encoder. Imports no JAX.

- ``CASES`` / :func:`case_data`: eleven small streams of the entropy-decode
  tests (``test_torch_huffman.py``, ``test_torch_symbol_table.py``,
  ``test_torch_pipeline.py``), each a shape of stream the decoder has to
  get right.
- :func:`matrix_streams`: every stream of the JAX package's bit-exact
  matrix (``tests/test_device_bitexact.py``: ``SPECS`` and the tests below
  it) and the four robustness streams of ``tests/test_robustness.py``
  that decode, made the same way from the images given
  (``test_torch_matrix.py``, ``test_torch_api.py``; ``chip_smoke.py``
  makes them from its own images); their names are ``MATRIX_NAMES``.
- :func:`mixed_lengths`: three streams of one pixel geometry whose lengths
  differ (``test_torch_batch.py``, ``test_torch_api.py``).
"""

import numpy as np

import jpeggpu_tpu_torch as T
from jpeggpu_tpu_torch import constants as C
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


# tests/test_device_bitexact.py SPECS
MATRIX_SPECS = [
    ("444", dict(sampling=[(1, 1), (1, 1), (1, 1)])),
    ("422", dict(sampling=[(2, 1), (1, 1), (1, 1)])),
    ("420", dict(sampling=S420)),
    ("440", dict(sampling=[(1, 2), (1, 1), (1, 1)])),
    ("411", dict(sampling=[(4, 1), (1, 1), (1, 1)])),
    ("mixed_ss", dict(sampling=[(2, 2), (2, 1), (1, 1)])),
    ("nondivisor_ss", dict(sampling=[(3, 1), (2, 1), (1, 1)],
                           restart_interval=3)),
    ("ss_41_14", dict(sampling=[(4, 1), (1, 4), (1, 1)])),
    ("420_rst2", dict(sampling=S420, restart_interval=2)),
    ("420_rst7", dict(sampling=S420, restart_interval=7)),
    ("444_rst1", dict(sampling=[(1, 1)] * 3, restart_interval=1)),
    ("non_interleaved", dict(sampling=S420, interleaved=False)),
    ("non_il_rst2", dict(sampling=S420, interleaved=False,
                         restart_interval=2)),
    ("q10", dict(quality=10)),
    ("q99", dict(quality=99)),
    ("four_tables", dict(sampling=S420, table_ids=[(0, 0), (1, 1), (2, 2)])),
    ("opt_huff", dict(sampling=S420, optimize_huffman=True)),
    ("opt_huff_rst", dict(sampling=S420, optimize_huffman=True,
                          restart_interval=3)),
    ("opt_huff_q99", dict(quality=99, optimize_huffman=True)),
]


def _robustness_streams(image):
    """The four streams of tests/test_robustness.py that decode: a scan cut
    at 70% (EOI kept), a random scan body behind a valid header, a DNL
    segment before EOI, and a dangling RST after the last segment (an empty
    final restart segment)."""
    data = encode(image, EncodeSpec(sampling=S420))
    scan = T.parse(data).scans[0]
    raw = bytearray(data[:scan.begin + (scan.end - scan.begin) * 7 // 10])
    if raw[-1] == 0xFF:
        raw.pop()
    truncated = bytes(raw) + bytes([0xFF, C.MARKER_EOI])

    gray = encode(image[..., 0])
    scan = T.parse(gray).scans[0]
    body = np.random.default_rng(2).integers(0, 255, scan.end - scan.begin,
                                             dtype=np.uint8)
    body[body == 0xFF] = 0x7F  # no markers
    garbled = gray[:scan.begin] + body.tobytes() + gray[scan.end:]

    dnl = bytes([0xFF, C.MARKER_DNL, 0, 4]) + image.shape[0].to_bytes(2, "big")
    with_dnl = data[:-2] + dnl + data[-2:]

    rst = encode(image, EncodeSpec(sampling=S420, restart_interval=2))
    scan = T.parse(rst).scans[0]
    dangling = (rst[:scan.end] + bytes([0xFF, C.MARKER_RST0])
                + rst[scan.end:])
    return [("truncated_scan", truncated), ("garbage_body", garbled),
            ("dnl_segment", with_dnl), ("dangling_rst", dangling)]


# the names of matrix_streams, in its order
MATRIX_NAMES = ([n for n, _ in MATRIX_SPECS]
                + ["opt_huff_q97", "rand_420_rst2", "gray", "gray_rst3",
                   "noise_q98", "noise_q100", "four_component",
                   "four_component_non_interleaved", "tiny", "exact_mcu",
                   "saturated_table", "default", "flat", "per_scan_dht",
                   "per_scan_dht_rst5", "truncated_scan", "garbage_body",
                   "dnl_segment", "dangling_rst"])


def matrix_streams(image, noise):
    """(name, bytes) of every stream of the bit-exact matrix and the
    robustness streams that decode, from ``image`` (RGB, the JAX tests'
    ``test_image``: 67x45) and ``noise`` (RGB noise, their
    ``noise_image``: 64x48)."""
    four = [image[..., 0], image[..., 1], image[..., 2], 255 - image[..., 0]]
    rand = np.random.default_rng(7).integers(0, 255, (24, 16, 3)).astype(
        np.uint8)
    streams = [(name, encode(image, EncodeSpec(**kw)))
               for name, kw in MATRIX_SPECS]
    streams += [
        ("opt_huff_q97", encode(image, EncodeSpec(optimize_huffman=True,
                                                  quality=97))),
        ("rand_420_rst2", encode(rand, EncodeSpec(sampling=S420,
                                                  restart_interval=2))),
        ("gray", encode(image[..., 0])),
        ("gray_rst3", encode(image[..., 0], EncodeSpec(restart_interval=3))),
        ("noise_q98", encode(noise, EncodeSpec(quality=98))),
        ("noise_q100", encode(noise, EncodeSpec(quality=100))),
        ("four_component", encode(four, EncodeSpec(sampling=[(1, 1)] * 4))),
        ("four_component_non_interleaved", encode(four, EncodeSpec(
            sampling=[(1, 1)] * 4, interleaved=False))),
        ("tiny", encode(np.full((1, 1), 128, np.uint8))),
        ("exact_mcu", encode(np.arange(64, dtype=np.uint8).reshape(8, 8))),
        ("saturated_table", saturated_stream()),
        ("default", encode(image)),
        ("flat", encode(np.full((64, 96, 3), 200, np.uint8),
                        EncodeSpec(sampling=S420))),
        ("per_scan_dht", encode(image, EncodeSpec(
            sampling=[(1, 1)] * 3, interleaved=False,
            table_ids=[(0, 0)] * 3, dht_per_scan=True))),
        ("per_scan_dht_rst5", encode(image, EncodeSpec(
            sampling=[(1, 1)] * 3, interleaved=False,
            table_ids=[(0, 0)] * 3, dht_per_scan=True, restart_interval=5))),
    ]
    return streams + _robustness_streams(image)


def mixed_lengths():
    """Three gray 256x256 images, restart interval 8 (one geometry), whose
    streams differ in length: 1.3 KB, 66 KB, 29 KB. Their lane buckets
    (256 / 768 / 256), tile geometry and raw scan buffers differ."""
    flat = np.full((256, 256), 128, np.uint8)
    noise = np.random.default_rng(5).integers(0, 255, (256, 256)).astype(
        np.uint8)
    return [encode(img, EncodeSpec(quality=q, restart_interval=8))
            for img, q in ((flat, 30), (noise, 95), (noise, 50))]
