"""Weak-scaling harness of the multi-process decode.

    python -m jpeggpu_tpu_torch.parallel.weakscale [--nproc 1 2 4]
        [--imgs 4] [--iters 5] [--size 136] [--device cuda|cpu]
        [--out FILE]

The port of ``scripts/weakscale.py``. Starts N processes on this machine,
wires them with ``torch.distributed`` (gloo, a ``file://`` rendezvous in a
temporary directory), and runs :class:`~jpeggpu_tpu_torch.parallel.
multihost.MultiHostBatchDecoder` with a fixed per-process workload: each
process makes ``--imgs`` images (a comma list gives process k the k-th
count, mixed counts) of one geometry from a numpy seed, checks its planes
against the port's golden decoder, then times ``--iters`` decodes.
Process 0's result also carries the kernel wrappers' launch counts of its
first decode (0 on the CPU, where the plain versions run).
Weak-scaling efficiency = t(1 process) / t(N processes) for the same
per-process work. The default, ``--device cuda``, puts every process on
card ``rank % device_count`` and raises where there is no CUDA device;
``--device cpu`` runs the plain versions, one thread per worker. Prints
one JSON list of ``{nproc, per_process_s, imgs_per_process,
weak_scaling_efficiency}`` and, with ``--out``, writes the table there; a
worker that fails or runs past its time limit makes the exit code
non-zero.

:func:`launch` also takes a directory of prepared images in place of the
generated ones: ``{k}.jpg`` with the SHA-256 of its expected planes in
``{k}.sha256`` (:func:`planes_sha256`); process p then decodes the images
``p * imgs .. p * imgs + imgs - 1``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

_WORKER_FLAG = "JPEGGPU_TORCH_WEAKSCALE_WORKER"
WORKER_TIMEOUT_S = 900


def planes_sha256(planes) -> str:
    """SHA-256 over a decode's planes: each plane's shape, type and
    bytes, in order."""
    h = hashlib.sha256()
    for p in planes:
        p = np.ascontiguousarray(p)
        h.update(f"{p.shape}{p.dtype}".encode())
        h.update(p.tobytes())
    return h.hexdigest()


def _counts(imgs: str, nproc: int) -> List[int]:
    counts = [int(x) for x in str(imgs).split(",")]
    return [counts[p % len(counts)] for p in range(nproc)]


def _images(n: int, size: int) -> List[bytes]:
    """`n` JPEGs of one geometry (4:2:0, restart interval 4), width `size`
    rounded up to whole MCUs, made from numpy seed 17."""
    from PIL import Image

    from ..encoder import EncodeSpec, encode

    rng = np.random.default_rng(17)
    base = rng.integers(0, 255, (9, 12, 3)).astype(np.uint8)
    w = -(-size // 16) * 16
    h = -(-(size * 3 // 4) // 16) * 16
    img = np.array(Image.fromarray(base).resize((w, h), Image.BILINEAR))
    return [encode(np.clip(img.astype(np.int64) + i, 0, 255).astype(np.uint8),
                   EncodeSpec(sampling=[(2, 2), (1, 1), (1, 1)],
                              restart_interval=4))
            for i in range(n)]


def _wrappers():
    """The kernel wrappers of the decode, each with its launch count."""
    from ..ops import huffman, idct, write

    found = {id(fn): fn for m in (huffman, write, idct)
             for fn in vars(m).values()
             if callable(fn) and hasattr(fn, "launches")}
    return list(found.values())


def worker() -> int:
    """One process of a run, configured by the environment that
    :func:`launch` sets."""
    import torch

    from . import make_mesh, multihost
    from .. import golden

    env = os.environ
    nproc, pid = int(env["WS_NPROC"]), int(env["WS_PID"])
    imgs = _counts(env["WS_IMGS"], nproc)[pid]
    iters, device = int(env["WS_ITERS"]), env["WS_DEVICE"]
    if device == "cpu":
        torch.set_num_threads(1)
        devices = ["cpu"]
    else:
        devices = [torch.device("cuda", pid % torch.cuda.device_count())]
    multihost.initialize(env["WS_INIT"], nproc, pid)
    try:
        assert multihost.process_count() == nproc
        data_dir = env.get("WS_DATA")
        if data_dir:
            first = pid * imgs
            datas, expect = [], []
            for k in range(first, first + imgs):
                with open(os.path.join(data_dir, f"{k}.jpg"), "rb") as f:
                    datas.append(f.read())
                with open(os.path.join(data_dir, f"{k}.sha256")) as f:
                    expect.append(f.read().strip())
        else:
            datas = _images(imgs, int(env["WS_SIZE"]))
            expect = [planes_sha256(golden.decode(d)) for d in datas]
        dec = multihost.MultiHostBatchDecoder(mesh=make_mesh(devices))
        for fn in _wrappers():
            fn.launches = 0
        out = dec.decode(datas)  # warm-up: builds the kernels, if any
        launches = {fn.__name__: fn.launches for fn in _wrappers()}
        assert len(out) == imgs
        for planes, want in zip(out, expect):
            if planes_sha256(planes) != want:
                raise AssertionError(
                    f"process {pid}: multi-process decode differs from the "
                    f"expected planes")
        t0 = time.perf_counter()
        for _ in range(iters):
            dec.decode(datas)
        dt = (time.perf_counter() - t0) / iters
        if pid == 0:
            print(json.dumps({"nproc": nproc, "per_process_s": dt,
                              "imgs_per_process": imgs,
                              "counts": list(dec.counts),
                              "launches": launches}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def launch(nproc: int, imgs="4", iters: int = 5, size: int = 136,
           device: str = "cuda", data_dir: Optional[str] = None,
           timeout: float = WORKER_TIMEOUT_S) -> dict:
    """Run one configuration of N processes; returns process 0's result.
    Raises as soon as a worker fails, or when the run outlives ``timeout``
    seconds; the other workers are then killed. ``device="cuda"``, the
    default, raises at once where there is no CUDA device."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' takes the CUDA devices and none is "
                           "available; pass device='cpu' (--device cpu) to "
                           "run the plain versions")
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="jpeggpu_ws_") as tmp:
        procs = []
        try:
            for pid in range(nproc):
                env = dict(os.environ)
                env.update({
                    _WORKER_FLAG: "1", "WS_NPROC": str(nproc),
                    "WS_PID": str(pid), "WS_IMGS": str(imgs),
                    "WS_ITERS": str(iters), "WS_SIZE": str(size),
                    "WS_DEVICE": device,
                    "WS_INIT": f"file://{os.path.join(tmp, 'rendezvous')}",
                    "PYTHONPATH": os.pathsep.join(
                        [pkg_root] + [p for p in env.get(
                            "PYTHONPATH", "").split(os.pathsep) if p]),
                })
                if data_dir:
                    env["WS_DATA"] = data_dir
                if device == "cpu":
                    env["OMP_NUM_THREADS"] = "1"
                out = open(os.path.join(tmp, f"{pid}.out"), "w+")
                procs.append((subprocess.Popen(
                    [sys.executable, "-m",
                     "jpeggpu_tpu_torch.parallel.weakscale"],
                    env=env, stdout=out, stderr=subprocess.STDOUT), out))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p, _ in procs):
                failed = [pid for pid, (p, _) in enumerate(procs)
                          if p.returncode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            logs = []
            for p, out in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                out.seek(0)
                logs.append(out.read())
        finally:
            for p, out in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                out.close()
    failed = [f"worker {pid} of {nproc} (rc={p.returncode}):\n"
              f"{logs[pid][-3000:]}"
              for pid, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"the {nproc}-process run failed or was stopped "
                           f"after {timeout} s; " + "\n".join(failed))
    line = [ln for ln in logs[0].splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def main(argv=None) -> int:
    if os.environ.get(_WORKER_FLAG) == "1":
        return worker()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--imgs", default="4",
                    help="images per process, or a comma list by process")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--size", type=int, default=136)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    results = []
    for n in args.nproc:
        r = launch(n, args.imgs, args.iters, args.size, args.device)
        results.append(r)
        print(f"nproc={n}: {r['per_process_s'] * 1e3:.1f} ms/iter "
              f"({args.imgs} imgs/process, {args.device})", file=sys.stderr,
              flush=True)
    base = results[0]["per_process_s"]
    rows = [{"nproc": r["nproc"], "per_process_s": r["per_process_s"],
             "imgs_per_process": r["imgs_per_process"],
             "weak_scaling_efficiency": base / r["per_process_s"]}
            for r in results]
    if args.out:
        table = {"harness": "multi-process on one machine, torch.distributed "
                            "(gloo)",
                 "device": args.device, "imgs_per_process": args.imgs,
                 "image_width": args.size, "iters": args.iters,
                 "results": rows}
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
