"""The benchmark's inputs: photo-like images encoded by PIL's libjpeg.

Everything is made from the run's seed, nothing is read from disk. Where
a configuration gives ``content_seed``, the pool's images come from that
seed instead, so that every run has the same set of images and the run's
seed orders them (the traffic draws the order and each request's rows):

- :func:`synthetic_image`: a smooth random field plus Gaussian noise (the
  port's bench image, made on the device);
- :func:`make_pool`: the distinct images of a run, from a configuration's
  geometry mix and noise model (the traffic may set the pool's size).

PIL encodes with libjpeg's standard Huffman and quantisation tables. A host
without PIL cannot make the inputs: the import raises, there is no other
encoder.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Dict, List, Sequence

import numpy as np


# PIL's `subsampling` argument for each chroma subsampling
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
SEED_MASK = (1 << 64) - 1


def seed_key(seed: int, *stream: int) -> List[int]:
    """Entropy for numpy's generators: the run's seed (any whole number)
    and the numbers of a sub-stream."""
    return [seed & SEED_MASK, *stream]


def synthetic_image(h: int, w: int, seed: int, sigma, device) -> np.ndarray:
    """Photo-like RGB test image, made on `device` from `seed` (a whole
    number below 2**64): a smooth random field (bilinear interpolation of a
    coarse grid of random colours) plus Gaussian noise of deviation
    ``sigma``, a number or one per row. The arithmetic of the port's bench
    image, in torch on the device, so that a 12 MP frame takes a fraction
    of a second; the same seed on the same kind of device gives the same
    image."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f32 = torch.float32
    grid = torch.randint(0, 256, (h // 32 + 2, w // 32 + 2, 3), generator=g,
                         device=device).to(f32)
    ys = torch.arange(h, dtype=f32, device=device) / 32.0
    xs = torch.arange(w, dtype=f32, device=device) / 32.0
    y0, x0 = ys.long(), xs.long()
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
    bot = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
    sig = torch.as_tensor(np.asarray(sigma, np.float32), device=device)
    if sig.dim():
        sig = sig[:, None, None]
    noise = torch.randn(top.shape, generator=g, device=device, dtype=f32)
    img = top * (1 - fy) + bot * fy + noise * sig
    return img.clamp_(0, 255).to(torch.uint8).cpu().numpy()


def torch_seed(seed: int, *stream: int) -> int:
    """A seed for torch's generators from the run's seed and a sub-stream."""
    ss = np.random.SeedSequence(seed_key(seed, *stream))
    return int(ss.generate_state(1, np.uint64)[0])


def encode(img: np.ndarray, quality: int, subsampling: str,
           restart_rows: int) -> bytes:
    """`img` as a baseline JPEG by PIL's libjpeg (standard tables); a
    restart marker every `restart_rows` MCU rows, none for 0."""
    from PIL import Image

    kw = dict(quality=quality, subsampling=SUBSAMPLING[subsampling])
    if restart_rows:
        kw["restart_marker_rows"] = restart_rows
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def make_frame(seed: int, width: int, height: int, quality: int,
               subsampling: str, restart_rows: int, sigma: Sequence[float],
               bands: int, device) -> bytes:
    """One :func:`synthetic_image` whose noise steps from ``sigma[0]`` to
    ``sigma[1]`` over `bands` bands of rows, encoded whole."""
    band = np.arange(height) * bands // height
    lo, hi = sigma
    img = synthetic_image(height, width, seed,
                          lo + (hi - lo) * band / max(bands - 1, 1), device)
    return encode(img, quality, subsampling, restart_rows)


@dataclasses.dataclass(frozen=True)
class PoolImage:
    """One distinct image of a run."""

    data: bytes
    width: int
    height: int


def _counts(shares: Sequence[float], n: int) -> List[int]:
    """`n` split by `shares`, largest remainders first (ties to the earlier
    entry)."""
    raw = [s * n for s in shares]
    out = [int(np.floor(r)) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: (out[i] - raw[i], i))
    for i in order[:n - sum(out)]:
        out[i] += 1
    return out


def geometries(params: Dict, n: int) -> List[tuple]:
    """(width, height) of each of the pool's `n` images: the configuration's
    ``geometry`` entries in order, each given its share of `n`; a size
    given as ``[lo, hi]`` is drawn per image from ``size_seed``, so that
    every run seed has the same set of sizes."""
    entries = params["geometry"]
    rng = np.random.default_rng(params.get("size_seed", 0))
    out = []
    for entry, k in zip(entries, _counts([e["share"] for e in entries], n)):
        for _ in range(k):
            out.append(tuple(
                int(rng.integers(v[0], v[1] + 1)) if isinstance(v, list)
                else int(v) for v in (entry["width"], entry["height"])))
    return out


def make_pool(params: Dict, seed: int, device) -> List[PoolImage]:
    """The run's distinct images (``pool`` of them).

    ``noise`` is ``{"sigma": [lo, hi], "bands": k}``: within each image the
    noise steps from lo to hi over k bands of rows; or ``{"sigma": [lo,
    hi], "per_image": true}``: image i gets a deviation of its own, the
    pool's deviations spread evenly from lo to hi and dealt out in an
    order drawn from the seed. The content of image i comes from the seed
    (``content_seed`` where the configuration gives one) and i, made on
    `device`."""
    n = int(params["pool"])
    seed = int(params.get("content_seed", seed))
    noise = params["noise"]
    lo, hi = noise["sigma"]
    sigmas = None
    if noise.get("per_image"):
        even = lo + (hi - lo) * np.arange(n) / max(n - 1, 1)
        sigmas = np.random.default_rng(seed_key(seed, 0)).permutation(even)
    pool = []
    for i, (w, h) in enumerate(geometries(params, n)):
        common = (params["quality"], params["subsampling"],
                  int(params.get("restart_rows", 0)))
        if sigmas is None:
            data = make_frame(torch_seed(seed, 1, i), w, h, *common,
                              (lo, hi), int(noise["bands"]), device)
        else:
            img = synthetic_image(h, w, torch_seed(seed, 1, i),
                                  float(sigmas[i]), device)
            data = encode(img, *common)
        pool.append(PoolImage(data, w, h))
    return pool
