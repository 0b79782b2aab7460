"""End-to-end decode command line: JPEG in, PNG out.

The port of ``examples/decode_tool.py``, the analog of the reference example
tool (example/example_tool.c:75-181): read the file, run the five-phase
decode protocol, convert the planar output to interleaved RGB on the host
(util/util.h:33-107) and write a PNG (with the standard library's ``zlib``;
nothing else is needed). ``--planes``, and images of neither one nor three
components, write each plane as ``.npy`` instead.

Usage:
  python -m jpeggpu_tpu_torch.decode_tool input.jpg [output.png]
      [--logging] [--info] [--planes] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import struct
import sys
import time
import zlib

import numpy as np


def png_bytes(img: np.ndarray) -> bytes:
    """A uint8 image, (h, w) gray or (h, w, 3) RGB, as an 8-bit PNG with
    one IDAT chunk and no filtering."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"not an 8-bit gray or RGB image: {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default=None)
    ap.add_argument("--logging", action="store_true",
                    help="enable parser/stage logging")
    ap.add_argument("--info", action="store_true",
                    help="print header info and exit (no device work)")
    ap.add_argument("--planes", action="store_true",
                    help="write raw planes as .npy instead of RGB PNG")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="decode on this device (default: the CUDA device, "
                         "which must exist)")
    args = ap.parse_args(argv)

    with open(args.input, "rb") as f:
        data = f.read()

    from .api import Decoder
    from .utils.color import to_rgb

    with Decoder(device=args.device) as dec:
        dec.set_logging(args.logging)
        t0 = time.perf_counter()
        info = dec.parse_header(data)
        t_parse = time.perf_counter() - t0
        print(f"{args.input}: {info.sizes_x[0]}x{info.sizes_y[0]}, "
              f"{info.num_components} component(s), "
              f"subsampling {info.subsampling} "
              f"(parsed in {t_parse * 1e3:.2f} ms)")
        if args.info:
            return 0

        print(f"device buffer: {dec.get_buffer_size() / 1e6:.1f} MB")
        dec.transfer()
        t0 = time.perf_counter()
        planes = dec.decode()
        t_dec = time.perf_counter() - t0
        mp = info.sizes_x[0] * info.sizes_y[0] / 1e6
        print(f"decoded in {t_dec * 1e3:.1f} ms ({mp / t_dec:.1f} MP/s, "
              f"first decode)")

        out = args.output or (args.input.rsplit(".", 1)[0] + ".png")
        if args.planes or info.num_components not in (1, 3):
            for i, p in enumerate(planes):
                np.save(f"{out}.plane{i}.npy", p)
                print(f"wrote {out}.plane{i}.npy {p.shape}")
            return 0

        rgb = to_rgb(planes, info.subsampling)
        with open(out, "wb") as f:
            f.write(png_bytes(rgb))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
