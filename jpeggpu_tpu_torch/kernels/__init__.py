"""The hand-written CUDA kernels and the loader that builds them.

Sources live in ``csrc/``: one ``.cu`` file per kernel, each with a plain C
interface (pointers, ints and the stream), so none includes PyTorch's
headers and each compiles in seconds. At first use every source is compiled
with ``nvcc`` for ``sm_90a`` into its own shared library, all compilers
started together, in the package's build directory, and loaded with
``ctypes``. Nothing is built or imported from CUDA when this module is
imported: a machine with no ``nvcc`` can import the package and run the
plain versions on CPU tensors.

Nine kernels: the whole sync round (``subseq_pass.cu``, which also holds
its gathered mode, the pass of a compacted sync round), the direct writing
decode (``decode_write.cu``), the stream -> planes tail of a scan
(``idct_stream.cu``, one launch for all its components), the records
write path: the emitting decode
(``emit_pass.cu``; it, K1 and K2 decode by the one-lookup symbol table), its
supertile shape (``supertiles.cu``, ``expand_supertiles.cu``) and its
per-lane shape for sparse scans (``tiles.cu``, ``expand_tiles.cu``); and
the plane IDCT of the sharded decode's tail (``idct_blocks.cu``, one
launch for all planes of a shard's chunk).

The wrappers that launch the kernels (and count their launches) live beside
the plain PyTorch versions in ``ops/huffman.py``, ``ops/write.py`` and
``ops/idct.py``; they
call :func:`get` for the C function, pass ``tensor.data_ptr()`` and
``torch.cuda.current_stream().cuda_stream`` (the IDCT kernels also take a
descriptor of their planes in host memory, :func:`host_int64`), and raise
when the function
returns anything but ``cudaSuccess``. A kernel that fails to build or to
launch is an error; there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

from .._build_dir import library_path

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64

# C function -> (source file, headers it includes, argtypes); a source
# that holds two functions is built once
_KERNELS = {
    "jpeggpu_subseq_pass": (
        "subseq_pass.cu", ("huffman_common.cuh",),
        [_P] * 20 + [_U64] + [_I] * 3 + [_P]),
    "jpeggpu_subseq_pass_at": (
        "subseq_pass.cu", ("huffman_common.cuh",),
        [_P] * 18 + [_U64] + [_I] * 3 + [_P]),
    "jpeggpu_decode_write": (
        "decode_write.cu", ("huffman_common.cuh",),
        [_P] * 17 + [_U64] + [_I] * 3 + [_P]),
    "jpeggpu_idct_stream_to_planes": (
        "idct_stream.cu", ("idct_common.cuh", "bulk_copy.cuh"),
        [_P] * 4 + [_I] + [_P]),
    "jpeggpu_emit_pass": (
        "emit_pass.cu", ("huffman_common.cuh",),
        [_P] * 17 + [_U64] + [_I] * 4 + [_P]),
    "jpeggpu_supertiles": (
        "supertiles.cu", ("tile_common.cuh",), [_P] * 5 + [_I] * 4 + [_P]),
    "jpeggpu_expand_supertiles": (
        "expand_supertiles.cu", ("tile_common.cuh",),
        [_P] * 5 + [_I] * 5 + [_P]),
    "jpeggpu_tiles": (
        "tiles.cu", ("tile_common.cuh",), [_P] * 7 + [_I] * 3 + [_P]),
    "jpeggpu_expand_tiles": (
        "expand_tiles.cu", ("tile_common.cuh",), [_P] * 5 + [_I] * 3 + [_P]),
    "jpeggpu_dequant_idct_planes": (
        "idct_blocks.cu", ("idct_common.cuh",), [_P, _I, _P]),
}

_lock = threading.Lock()
_functions: Dict[str, ctypes._CFuncPtr] = {}
# what the last build printed (ptxas -v: registers, shared memory, spills)
# and how long it took; read by chip_smoke.py
build_log: List[str] = []
build_seconds: float = 0.0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
        if not os.path.exists(nvcc):
            raise RuntimeError(
                "the CUDA kernels need nvcc to be built (not on PATH, not "
                f"under {cuda_home}); CPU tensors take the plain versions")
    return nvcc


def _build_and_load() -> None:
    global build_seconds
    t0 = time.perf_counter()
    libs = {}
    running = []
    for src, headers, _ in _KERNELS.values():
        if src in libs:
            continue
        src_path = os.path.join(_CSRC, src)
        deps = [src_path] + [os.path.join(_CSRC, h) for h in headers]
        so_path = library_path(os.path.splitext(src)[0], deps, NVCC_FLAGS)
        libs[src] = so_path
        if os.path.exists(so_path):
            continue
        tmp = f"{so_path}.tmp{os.getpid()}"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, proc, tmp, so_path))
    failures = []
    for src, proc, tmp, so_path in running:
        out, _ = proc.communicate()
        build_log.append(f"--- nvcc {src} (exit {proc.returncode})\n{out}")
        if proc.returncode == 0:
            os.replace(tmp, so_path)
        else:
            failures.append(f"{src}:\n{out}")
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    for fn_name, (src, _, argtypes) in _KERNELS.items():
        fn = getattr(ctypes.CDLL(libs[src]), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[fn_name] = fn
    build_seconds = time.perf_counter() - t0


def get(fn_name: str):
    """The C launch function ``fn_name``; builds and loads all kernels on
    the first call."""
    with _lock:
        if not _functions:
            _build_and_load()
        return _functions[fn_name]


def host_int64(values) -> ctypes.Array:
    """A launch descriptor in host memory: ``values`` as a C int64 array,
    whose address (``ctypes.addressof``) the launch functions take; the
    caller keeps it alive for the call."""
    return (ctypes.c_int64 * len(values))(*values)


def check(err: int, what: str) -> None:
    """Raise if a launch function returned anything but cudaSuccess."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed, cudaError {err}")
