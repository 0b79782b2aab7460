"""jpeggpu_tpu_torch: baseline-JPEG decoding on an NVIDIA GPU with PyTorch.

The PyTorch/CUDA port of the JAX package beside it: host-side marker
parsing, table derivation and destuffing, then on the device the
subsequence-parallel speculative Huffman decode with self-synchronisation,
the DC prefix sums and the fused de-interleave + integer dequantise + IDCT.
Plain tensor code is PyTorch; the kernels of the decode path (three on the
default path, five more on the records write path that
``Tuning(write_mode="tiles")`` selects, one more in the tail of the sharded
decode, ``parallel.segments.decode_sharded``) are CUDA C++
(``kernels/csrc``), built at first use. A batch of images decodes through
``parallel.decode_batch`` / ``parallel.BatchDecoder``: images of one
geometry that share their Huffman tables as one decode, their lanes side by
side. ``Decoder(host_destuff=False)`` destuffs on the device (tensor code,
``ops/destuff.py``); ``debug`` holds the debug mode and ``profile_trace``;
``python -m jpeggpu_tpu_torch.decode_tool`` is the command line. The
package imports torch and numpy only.
"""

from .config import Tuning, default_tuning, set_default_tuning

from .errors import (
    IncompleteBitstream,
    InternalError,
    InvalidArgument,
    InvalidJpeg,
    JpegError,
    NotSupported,
    OutOfHostMemory,
    Status,
    get_status_string,
)
from .reader import JpegStream, parse

__all__ = [
    "IncompleteBitstream",
    "InternalError",
    "InvalidArgument",
    "InvalidJpeg",
    "JpegError",
    "JpegStream",
    "NotSupported",
    "OutOfHostMemory",
    "Status",
    "Tuning",
    "Decoder",
    "ImgInfo",
    "decode",
    "decode_rgb",
    "default_tuning",
    "get_status_string",
    "parse",
    "set_default_tuning",
]


def __getattr__(name):
    # lazy: importing the API pulls in torch; keep host-only imports light
    if name in ("Decoder", "ImgInfo", "decode", "decode_rgb", "is_css_444"):
        from . import api

        return getattr(api, name)
    if name in ("golden", "debug", "encoder"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
