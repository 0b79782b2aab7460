"""PyTorch port, the multi-process decode (``parallel/multihost.py``) and
its weak-scaling harness (``parallel/weakscale.py``) on the CPU: gloo
process groups with a ``file://`` rendezvous in a temporary directory, so
that runs in parallel never meet on a port. Every worker checks its planes
against the port's golden decoder itself (bit-exact, ``np.array_equal`` of
their SHA-256). Every process started here has a time limit: a hang fails
the test instead of holding up the run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jpeggpu_tpu_torch import golden
from jpeggpu_tpu_torch.parallel import make_mesh, multihost, weakscale

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def test_two_processes_two_images():
    r = weakscale.launch(2, "2", iters=1, device="cpu",
                         timeout=TIMEOUT_S)
    assert r["nproc"] == 2 and r["imgs_per_process"] == 2
    assert r["counts"] == [2, 2] and r["per_process_s"] > 0


def test_four_processes_mixed_counts():
    """Counts 1, 2, 2, 3: no process pads its batch, and each decodes
    exactly its own images (checked against golden in every worker)."""
    r = weakscale.launch(4, "1,2,2,3", iters=1, device="cpu",
                         timeout=TIMEOUT_S)
    assert r["nproc"] == 4 and r["counts"] == [1, 2, 2, 3]


_RANK = """
import sys
from jpeggpu_tpu_torch.parallel import make_mesh, multihost, weakscale
rank, init, case = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(init, 2, rank)
try:
    if case == "buckets":
        datas = weakscale._images(1, 136 if rank == 0 else 152)
    else:
        datas = weakscale._images(1, 136) if rank else []
    try:
        multihost.MultiHostBatchDecoder(mesh=make_mesh(["cpu"])).decode(datas)
    except ValueError as e:
        print("ValueError:", e)
finally:
    import torch.distributed
    torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("case,messages", [
    ("buckets", ["one geometry bucket across processes"] * 2),
    ("empty", ["each process must supply >= 1 image",
               "process(es) [0] could not join"]),
])
def test_mismatch_raises_on_every_rank(tmp_path, case, messages):
    """Peers that pass another geometry bucket, or no image, make every
    rank raise ValueError, none hangs."""
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(rank), init, case], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out, message in zip(procs, outs, messages):
        assert p.returncode == 0, out[-2000:]
        assert "ValueError:" in out and message in out, out[-2000:]


def test_single_process_without_initialize():
    """No process group: process 0 of 1, and the decode == golden, with
    the JAX package's errors for no image and mixed signatures."""
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    mesh = multihost.global_mesh(devices=["cpu"])
    assert mesh.size == 1 and mesh.device_counts == (1,)
    dec = multihost.MultiHostBatchDecoder(mesh=mesh)
    datas = weakscale._images(2, 64)
    out = dec.decode(datas)
    assert dec.counts == (2,)
    for data, planes in zip(datas, out):
        for a, b in zip(planes, golden.decode(data)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="each process must supply"):
        dec.decode([])
    mixed = weakscale._images(1, 64) + weakscale._images(1, 96)
    with pytest.raises(ValueError, match="one geometry bucket"):
        multihost.MultiHostBatchDecoder(mesh=make_mesh(["cpu"])).decode(mixed)


def test_no_devices_named_needs_cuda():
    """global_mesh() and MultiHostBatchDecoder() take the cards, and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.global_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.MultiHostBatchDecoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        weakscale.launch(1, "1", iters=1)


def test_weakscale_cli(tmp_path):
    out = tmp_path / "weakscale.json"
    res = subprocess.run(
        [sys.executable, "-m", "jpeggpu_tpu_torch.parallel.weakscale",
         "--nproc", "1", "2", "--imgs", "2", "--iters", "1", "--device",
         "cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-2000:]
    table = json.loads(out.read_text())
    assert [r["nproc"] for r in table["results"]] == [1, 2]
    for r in table["results"]:
        assert set(r) == {"nproc", "per_process_s", "imgs_per_process",
                          "weak_scaling_efficiency"}
        assert r["per_process_s"] > 0 and r["imgs_per_process"] == 2
    assert table["results"][0]["weak_scaling_efficiency"] == 1.0
    assert json.loads(res.stdout.splitlines()[-1]) == table["results"]
