"""Host-side C++ components, built with g++ at first use.

Counterpart of ``paddle_tpu/core/native/__init__.py``.  It holds the C++
source of the rendezvous store's server (``tcp_store.cc``, the JAX
package's file as it is, a C ABI loaded through ctypes) and :func:`build`,
which compiles a source of this directory into
``build/paddle_tpu_torch/native/`` beside the package.  These are host
programs, not kernels: they stay out of ``csrc/``, whose ``.cu`` files
make the kernel library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

__all__ = ["build", "BUILD_DIR"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[2] / "build" / "paddle_tpu_torch" / "native"


def build(name: str, extra_flags=()) -> Optional[ctypes.CDLL]:
    """Compile ``<name>.cc`` of this directory into a shared library named
    by the source's digest, and load it.

    Returns None when there is no C++ toolchain (or the source is
    missing): the caller then serves from its Python implementation, as
    in the JAX package.  ``PADDLE_TPU_DISABLE_NATIVE=1`` forces that."""
    if os.environ.get("PADDLE_TPU_DISABLE_NATIVE"):
        return None
    src = _HERE / f"{name}.cc"
    try:
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    except OSError:
        return None
    out = BUILD_DIR / f"{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o",
               str(tmp), str(src), "-lpthread", *extra_flags]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
        os.replace(tmp, out)    # concurrent builds each finish whole
    try:
        return ctypes.CDLL(str(out))
    except OSError:
        return None
