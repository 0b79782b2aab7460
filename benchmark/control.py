"""The control of ``correct``: the reference with its integer IDCT replaced
by a float32 one, put in the program's place.

    python -m benchmark.control --workload <cell> --seeds 1 2 3

The configurations state one guarantee, planes bit-exact against the
sequential integer decoder; the control breaks it the way a later change
would be tempted to (a float IDCT in place of the integer one). For each
seed it makes the cell's images at the cell's size, draws the first
``sample`` images of the cell's request stream, decodes them with the
control, and judges them against the reference exactly as a run judges the
program's planes (:func:`benchmark.check.judge`). It prints one JSON line a
seed, and fails (exit 1) unless every seed's control comes out not correct.
The images are made on the card where there is one (as a run makes
them), else on the host's CPU; nothing else runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List

import numpy as np

from .reference.golden import decode
from .reference.reader import parse


def _idct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.where(u == 0, np.sqrt(0.5), 1.0)
    return (c / 2 * np.cos((2 * x + 1) * u * np.pi / 16)).astype(np.float32)


def float_decode(data: bytes) -> List[np.ndarray]:
    """The reference's entropy decode, then dequantisation and an 8x8 IDCT
    in float32, +128, rounded to the nearest and clamped."""
    stream = parse(data)
    coeffs = decode(data, with_idct=False)
    m = _idct_matrix()
    out = []
    for comp, plane in zip(stream.components, coeffs):
        h, w = plane.shape
        blocks = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
        q = stream.qtables[comp.qtable_idx].astype(np.float32).reshape(8, 8)
        f = blocks.astype(np.float32) * q
        pix = np.einsum("ux,abuv,vy->abxy", m, f, m) + 128.0
        pix = np.clip(np.rint(pix), 0, 255).astype(np.uint8)
        pix = pix.transpose(0, 2, 1, 3).reshape(h, w)
        out.append(pix[:comp.size_y, :comp.size_x])
    return out


def control_run(cell: str, seed: int, params=None, workers: int = 1):
    """The numbers the control gives in place of the program for `seed`."""
    import torch

    from . import check
    from .inputs import make_pool
    from .run import load_cell
    from .traffic import Stream, row_cuts

    params = params or load_cell(cell)[1]
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    pool = make_pool(params, seed, dev)
    rows = row_cuts(pool, params)
    stream = Stream(pool, params, seed, sub=0, rows=rows)
    n = int(params.get("sample", 16))
    keys = []
    while len(keys) < n:
        keys += stream.next().keys
    keys = keys[:n]
    datas = [p.data for p in pool]
    got = check.reference_planes(datas, keys, rows, workers,
                                 decoder=float_decode)
    want = check.reference_planes(datas, keys, rows, workers)
    return check.judge([(k, got[k]) for k in keys], want, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workers", type=int,
                    default=min(8, os.cpu_count() or 1))
    args = ap.parse_args(argv)
    from .check import passed

    ok = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control_run(args.workload, seed, workers=args.workers)
        correct = passed(checks)
        ok = ok and not correct
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              control_correct=correct, checks=checks,
                              seconds=time.perf_counter() - t0)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
