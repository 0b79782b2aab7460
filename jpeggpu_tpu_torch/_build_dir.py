"""Where the package puts what it compiles at first use.

Both the host destuffer (``native/``) and the CUDA kernels (``kernels/``)
are built from the sources shipped in the package into one directory that
version control ignores, never beside the sources. A library's file name
carries a hash of its source text and flags, so an edited source is rebuilt
and a stale library is never loaded.
"""

from __future__ import annotations

import hashlib
import os
from typing import Sequence

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")


def library_path(stem: str, sources: Sequence[str], flags: Sequence[str]) -> str:
    """Path of the shared library for these sources and flags (creates the
    build directory)."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
