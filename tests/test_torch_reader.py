"""PyTorch port, the parser's segment walk (``reader.parse``) on the CPU.

The native walk (``native.segment_walk``, one memchr pass) equals the
numpy walk (``reader._numpy_walk``) on every body: the scan's end, each
segment's stuffed span and its count of stuffed pairs, or the same error.
A whole parse by either path gives the same ``Scan`` fields as the JAX
package's ``reader.parse`` on the same bytes, or the same error. A body
with more restart segments than its header allows takes the numpy walk.
``reader.walks`` counts the scans each walk took. Streams from the port's
encoder, some of them edited. Tolerance: none.
"""

import numpy as np
import pytest

from jpeggpu_tpu import reader as jax_reader
from jpeggpu_tpu.errors import JpegError as JaxJpegError
from jpeggpu_tpu_torch import constants as C
from jpeggpu_tpu_torch import native, reader
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.errors import JpegError

S420 = [(2, 2), (1, 1), (1, 1)]
SCAN_FIELDS = ("begin", "end", "seg_raw", "segments", "num_segments",
               "num_subsequences")


def _first_rst(data: bytes) -> int:
    """Offset of the first RST marker's 0xFF after the first SOS."""
    body = data.index(bytes([0xFF, C.MARKER_SOS]))
    return next(i for i in range(body, len(data) - 1)
                if data[i] == 0xFF and C.MARKER_RST0 <= data[i + 1] <= C.MARKER_RST7)


def _set_dri(data: bytes, interval: int) -> bytes:
    at = data.index(bytes([0xFF, C.MARKER_DRI])) + 4
    return data[:at] + interval.to_bytes(2, "big") + data[at + 2:]


def _stream(name: str, image: np.ndarray) -> bytes:
    # 48x45 at 4:2:0: 3 x 3 MCUs, so one a segment reaches RST7
    small = image[:, :48]
    if name == "no_dri":
        return encode(small, EncodeSpec(sampling=S420))
    if name == "rst_every_row":
        return encode(small, EncodeSpec(sampling=S420, restart_interval=3))
    if name == "rst_every_mcu":
        return encode(small, EncodeSpec(sampling=S420, restart_interval=1))
    if name == "stuffed_before_rst":
        data = _stream("rst_every_mcu", image)
        at = _first_rst(data)
        return data[:at] + b"\xff\x00" + data[at:]
    if name == "fill_before_eoi":
        data = _stream("rst_every_row", image)
        assert data.endswith(b"\xff\xd9")
        return data[:-2] + b"\xff\xff\xff\xd9"
    if name == "lone_ff_last":
        return _stream("rst_every_row", image)[:-1]
    if name == "no_terminator":
        return _stream("rst_every_row", image)[:-2]
    if name == "more_rst_than_dri":
        # nine segments under a DRI that allows one
        return _set_dri(_stream("rst_every_mcu", image), 9)
    raise KeyError(name)


CASES = ("no_dri", "rst_every_row", "rst_every_mcu", "stuffed_before_rst",
         "fill_before_eoi", "lone_ff_last", "no_terminator",
         "more_rst_than_dri")


def _outcome(parse, data):
    """The first scan's fields, or the error's class name and message."""
    try:
        scan = parse(data).scans[0]
    except (JpegError, JaxJpegError) as e:
        return ("error", type(e).__name__, str(e))
    return tuple(np.asarray(getattr(scan, f)).tolist() for f in SCAN_FIELDS)


def _walk(walk):
    try:
        end, raw, stuffed = walk()
    except JpegError as e:
        return ("error", type(e).__name__, str(e))
    return end, raw.tolist(), stuffed.tolist()


@pytest.mark.parametrize("name", CASES)
def test_native_walk_equals_numpy_walk_and_jax_parse(name, test_image, monkeypatch):
    assert native.get_lib() is not None
    data = _stream(name, test_image)
    buf = np.frombuffer(data, np.uint8)
    # the body follows the SOS segment, whose length counts itself
    sos = data.index(bytes([0xFF, C.MARKER_SOS]))
    body = buf[sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big"):]
    # room for every segment the body could hold
    cap = len(body) // 2 + 1
    assert (_walk(lambda: native.segment_walk(body, cap))
            == _walk(lambda: reader._numpy_walk(body)))
    if name == "more_rst_than_dri":
        assert native.segment_walk(body, 1) is None

    before = dict(reader.walks)
    got_native = _outcome(reader.parse, data)
    took = {k: reader.walks[k] - before[k] for k in before}
    with monkeypatch.context() as m:
        m.setattr(native, "segment_walk", lambda body, cap: None)
        got_numpy = _outcome(reader.parse, data)
    assert got_native == got_numpy == _outcome(jax_reader.parse, data)
    if name == "no_terminator":
        assert got_native == ("error", "InvalidJpeg", "no end-of-image marker")
    elif name == "lone_ff_last":
        assert got_native[:2] == ("error", "InvalidJpeg")
    else:
        assert got_native[SCAN_FIELDS.index("num_segments")] > 0
        # the overflow takes the numpy walk, every other scan the native
        overflow = name == "more_rst_than_dri"
        assert took == {"native": int(not overflow), "numpy": int(overflow)}


def test_walks_counts_one_native_walk_a_scan(test_image):
    assert native.get_lib() is not None
    data = encode(test_image[:24, :40], EncodeSpec(
        sampling=S420, interleaved=False, restart_interval=2))
    before = dict(reader.walks)
    stream = reader.parse(data)
    assert len(stream.scans) == 3
    assert reader.walks["native"] - before["native"] == 3
    assert reader.walks["numpy"] == before["numpy"]
