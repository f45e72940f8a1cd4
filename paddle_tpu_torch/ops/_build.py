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
Every such failure, and every wrapper's refusal of its arguments, raises a
:class:`KernelError`: the fault of the program or the card, never of the
data it serves, so the serving engine's crash-only guard lets it through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["library", "build", "check", "stream", "sm_count", "dtype_code",
           "check_device_tensors", "KERNEL_DTYPES", "FP16_DTYPES",
           "BUILD_DIR", "CSRC", "KernelError", "KernelLaunchError",
           "KernelValueError", "KernelTypeError"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
_LIB_NAME = "libkernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# the flash kernels' dropout: seed, keep threshold (uint32), keep
# probability, the masks' head count and this launch's first head
_DROPOUT = [ctypes.c_uint, ctypes.c_uint, ctypes.c_float, _I, _I]
# C signature of every entry point: pointer arguments, then int arguments,
# then (flash) the dropout arguments, then the stream; the fused
# optimizer's mix pointers, counts and float hyperparameters
_SIGNATURES = {
    "ptt_flash_fwd": [_P] * 6 + [_I] * 8 + _DROPOUT + [_P],
    "ptt_flash_bwd_dq": [_P] * 8 + [_I] * 8 + _DROPOUT + [_P],
    "ptt_flash_bwd_dkv": [_P] * 10 + [_I] * 8 + _DROPOUT + [_P],
    "ptt_paged_decode": [_P] * 7 + [_I] * 8 + [_P],
    "ptt_paged_chunk": [_P] * 7 + [_I] * 9 + [_P],
    "ptt_moe_dispatch": [_P] * 3 + [_I] * 4 + [_P],
    "ptt_moe_combine": [_P] * 4 + [_I] * 5 + [_P],
    "ptt_weight_only_matmul": [_P] * 5 + [_I] * 5 + [_P],
    "ptt_weight_only_gemm": [_P] * 6 + [_I] * 8 + [_P],
    "ptt_fused_table_upload": [_P, _P, _L, _P],
    "ptt_fused_norm": [_P, _P, _I, _I, _L] + [_P] * 8 + [_I, _F, _I, _I,
                                                        _F, _F, _I, _I, _P],
    "ptt_fused_finish": [_P, _I] + [_P] * 7 + [_I, _F, _I, _F, _F, _I, _I,
                                               _P],
    "ptt_fused_update": [_P, _P, _I, _I, _L] + [_P] * 4 + [_I] * 3
                        + [_F] * 4 + [_I, _F, _F, _I, _P],
}


class KernelError(Exception):
    """A kernel wrapper's failure.  A launch that fails also reports a
    sticky fault of an earlier kernel (an illegal address, a trap), which
    ``cudaGetLastError`` returns at the next launch."""


class KernelLaunchError(KernelError, RuntimeError):
    """No ``nvcc``, a failed build, or a launch that returned a CUDA
    error."""


class KernelValueError(KernelError, ValueError):
    """Tensors of a shape, layout or device a kernel does not take."""


class KernelTypeError(KernelError, TypeError):
    """Tensors of a type a kernel does not take."""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelLaunchError(
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
        raise KernelLaunchError("nvcc failed for " + "\n".join(failed))
    tmp = BUILD_DIR / f"{_LIB_NAME}.{tag}"
    cmd = [nvcc, *NVCC_FLAGS[:4], "-shared", "-o", str(tmp),
           *(str(o) for _, o, _, _ in procs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _, _ in procs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise KernelLaunchError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)          # atomic: a concurrent reader sees old or new
    stamp.write_text(digest)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (its seconds are
    charged to the training step in progress: ``compile.seconds``)."""
    from ..observability import telemetry
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    telemetry.observe_compile("kernel_build", time.perf_counter() - t0)
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        what = library().ptt_error_string(err).decode()
        raise KernelLaunchError(f"{kernel}: CUDA launch failed: error {err} "
                                f"({what})")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (schedules that fill them)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# the type codes of the C entry points
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# what the weight-only pair takes; the kernels with float16 instances
# (FP16_DTYPES) are the flash, paged and MoE kernels and fused_adamw
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
FP16_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def dtype_code(dtype: torch.dtype, accepts=KERNEL_DTYPES,
               kernel: str = "kernels") -> int:
    """The C type code of ``dtype`` (0 float32, 1 bfloat16, 2 float16)
    for a kernel that takes the types ``accepts``; any other raises
    :class:`KernelTypeError`, before any launch."""
    if dtype not in accepts:
        names = " or ".join(str(t).replace("torch.", "") for t in accepts)
        raise KernelTypeError(f"{kernel} take {names}, got {dtype}")
    return _CODES[dtype]


def check_device_tensors(kernel: str, floats, ints=(),
                         accepts=KERNEL_DTYPES) -> None:
    """The checks every wrapper makes before a launch: one CUDA device,
    contiguous, 16-byte aligned (the kernels load 4 elements at a time),
    one floating type of ``accepts``, int32 index tensors."""
    dev = floats[0].device
    for t in (*floats, *ints):
        if t.device != dev:
            raise KernelValueError(
                f"{kernel}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise KernelValueError(f"{kernel}: tensors must be contiguous")
    for t in floats:
        if t.dtype != floats[0].dtype:
            raise KernelTypeError(f"{kernel}: mixed dtypes {t.dtype} and "
                                  f"{floats[0].dtype}")
        if t.data_ptr() % 16:
            raise KernelValueError(
                f"{kernel}: tensor data must be 16-byte aligned")
    dtype_code(floats[0].dtype, accepts, kernel)
    for t in ints:
        if t.dtype != torch.int32:
            raise KernelTypeError(f"{kernel}: index tensors must be int32, "
                                  f"got {t.dtype}")
