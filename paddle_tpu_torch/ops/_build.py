"""Build the hand-written CUDA kernels and bind them with ctypes.

The sources under ``paddle_tpu_torch/csrc/`` have a plain C interface (no
PyTorch headers), so ``nvcc`` compiles each in seconds.  At first use every
``*.cu`` file is compiled on its own ``nvcc`` process, all started
together, and the objects are linked into
``build/paddle_tpu_torch/libkernels.so`` at the root of the checkout.  The
library is rebuilt when the hash of the sources or the flags changes.  The
``-Xptxas -v`` report of each source (registers, shared memory, spills) is
kept beside it as ``<source>.ptxas.txt``.

Each C entry point returns the ``cudaError_t`` of its launch; the wrappers
pass it to :func:`check`, which raises.  Nothing here falls back to a plain
version: a missing ``nvcc``, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["library", "build", "check", "stream", "dtype_code",
           "check_device_tensors", "BUILD_DIR", "CSRC"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
_LIB_NAME = "libkernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# the flash kernels' dropout: seed, keep threshold (uint32), keep probability
_DROPOUT = [ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
# C signature of every entry point: pointer arguments, then int arguments,
# then (flash) the dropout arguments, then the stream
_SIGNATURES = {
    "ptt_flash_fwd": [_P] * 6 + [_I] * 8 + _DROPOUT + [_P],
    "ptt_flash_bwd_dq": [_P] * 8 + [_I] * 8 + _DROPOUT + [_P],
    "ptt_flash_bwd_dkv": [_P] * 10 + [_I] * 8 + _DROPOUT + [_P],
    "ptt_paged_decode": [_P] * 7 + [_I] * 8 + [_P],
    "ptt_paged_chunk": [_P] * 7 + [_I] * 9 + [_P],
    "ptt_moe_dispatch": [_P] * 3 + [_I] * 4 + [_P],
    "ptt_moe_combine": [_P] * 4 + [_I] * 5 + [_P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of paddle_tpu_torch build only "
            "where the CUDA toolkit is installed (CPU tensors use the plain "
            "PyTorch versions and need no build)")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile and link the kernels if the sources changed; returns the
    library's path."""
    lib = BUILD_DIR / _LIB_NAME
    stamp = BUILD_DIR / (_LIB_NAME + ".sha256")
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        log = open(BUILD_DIR / f"{src.stem}.ptxas.txt", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for src, obj, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name} (exit {rc}):\n"
                          + (BUILD_DIR / f"{src.stem}.ptxas.txt").read_text())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = BUILD_DIR / f"{_LIB_NAME}.{tag}"
    cmd = [nvcc, *NVCC_FLAGS[:4], "-shared", "-o", str(tmp),
           *(str(o) for _, o, _, _ in procs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _, _ in procs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)          # atomic: a concurrent reader sees old or new
    stamp.write_text(digest)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        what = library().ptt_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: error {err} "
                           f"({what})")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def check_device_tensors(kernel: str, floats, ints=()) -> None:
    """The checks every wrapper makes before a launch: one CUDA device,
    contiguous, 16-byte aligned (the kernels load 4 elements at a time),
    one floating type, int32 index tensors."""
    dev = floats[0].device
    for t in (*floats, *ints):
        if t.device != dev:
            raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: tensors must be contiguous")
    for t in floats:
        if t.dtype != floats[0].dtype:
            raise TypeError(f"{kernel}: mixed dtypes {t.dtype} and "
                            f"{floats[0].dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: tensor data must be 16-byte aligned")
    dtype_code(floats[0].dtype)
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{kernel}: index tensors must be int32, "
                            f"got {t.dtype}")
