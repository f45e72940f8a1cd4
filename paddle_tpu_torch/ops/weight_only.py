"""Weight-only quantized linear layers: the ``weight_only_matmul`` CUDA
kernel and its plain PyTorch version.

The JAX package has no Pallas kernel here: its serving programs
dequantize the int8 or fp8 weight snapshot in the trace
(``paddle_tpu/inference/quant.py`` ``dequant_values``) and XLA fuses the
per-channel scale multiply into the consuming dot
(``paddle_tpu/quantization/weight_only.py:90``).  PyTorch fuses nothing,
so the port's counterpart of that fused product is the hand-written kernel
``paddle_tpu_torch/csrc/weight_only.cu``, for the serving tick's few rows.

``weight_only_matmul(x, q, scale, bias)`` computes ``x @ W.T + bias``
with ``W = dequantize(q, scale[:, None])``: q ``[N, K]`` int8 or
``float8_e4m3fn`` codes in the ``nn.Linear`` layout, scale and bias ``[N]``
in x's type.  A CPU tensor takes :func:`weight_only_matmul_reference`; a
CUDA tensor launches the kernel (counted in
``weight_only_matmul.launches``) or raises if the kernel does not take
it: more than ``KERNEL_MAX_ROWS`` rows, or K not a multiple of 16.

The kernel covers the serving tick's row counts (the decode tick, the
speculative verify and the draft steps).  Wider products (the prompt
programs' pad buckets, where the weight's bytes are shared by many rows)
are the callers' route, decided from the shape before any launch
(:func:`dequant_route`): the caller dequantizes into a temporary of x's
type and multiplies with ``torch.matmul`` (the plain version), as the JAX
package leaves such a product to XLA, and adds one to
``weight_only_matmul.dequant_calls``, never to ``launches``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["weight_only_matmul", "weight_only_matmul_reference",
           "dequantize", "dequant_route", "KERNEL_MAX_ROWS", "CODE_DTYPES"]

KERNEL_MAX_ROWS = 128       # csrc/weight_only.cu: up to 8 tiles of 16 rows
# code type -> the kernel's qtype
CODE_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}


def dequantize(q, scale):
    """``q * scale`` in the scale's type (codes of either format);
    ``scale`` broadcasts against ``q`` (keepdims).  int8 codes enter the
    product directly (one pass over the codes; their cast to the scale's
    type is exact, so the values are those of cast-then-multiply), fp8
    codes, which PyTorch does not promote, are cast first."""
    if q.dtype == torch.int8:
        return q * scale
    return q.to(scale.dtype) * scale


def weight_only_matmul_reference(x, q, scale, bias=None):
    """The plain version: the dequantized weight ``[N, K]`` in the scale's
    type, cast to x's, then ``F.linear``."""
    w = dequantize(q, scale[:, None]).to(x.dtype)
    return F.linear(x, w, None if bias is None else bias.to(x.dtype))


def dequant_route(x) -> bool:
    """The callers' route, decided from the shape before any launch: True
    for a tensor off the CPU with more rows (all dims but the last) than
    ``KERNEL_MAX_ROWS``.  The caller then runs
    :func:`weight_only_matmul_reference` and adds one to the wrapper's
    ``dequant_calls``, never to its ``launches``.  A CPU tensor gives
    False: the wrapper takes its plain version for it anyway."""
    return x.device.type != "cpu" and \
        math.prod(x.shape[:-1]) > KERNEL_MAX_ROWS


def _checks(x, q, scale, bias):
    if q.dim() != 2 or scale.shape != (q.shape[0],):
        raise ValueError(f"weight_only_matmul: q {tuple(q.shape)} must be "
                         f"[N, K] and scale {tuple(scale.shape)} [N]")
    if x.shape[-1] != q.shape[1]:
        raise ValueError(f"weight_only_matmul: x {tuple(x.shape)} does not "
                         f"contract with q {tuple(q.shape)}")
    if q.dtype not in CODE_DTYPES:
        raise TypeError(f"weight_only_matmul: codes must be int8 or "
                        f"float8_e4m3fn, got {q.dtype}")
    if bias is not None and bias.shape != (q.shape[0],):
        raise ValueError(f"weight_only_matmul: bias {tuple(bias.shape)} "
                         f"must be [{q.shape[0]}]")


def weight_only_matmul(x, q, scale, bias=None):
    """``x [..., K] @ dequantize(q, scale).T (+ bias)`` -> ``[..., N]``.

    CUDA tensors: x, scale and bias float32 or bfloat16 of one type,
    contiguous, at most ``KERNEL_MAX_ROWS`` rows, K a multiple of 16 (the
    callers send wider products down :func:`dequant_route`).  CPU tensors
    take the plain version."""
    _checks(x, q, scale, bias)
    if x.device.type == "cpu":
        return weight_only_matmul_reference(x, q, scale, bias)
    N, K = q.shape
    lead = x.shape[:-1]
    M = math.prod(lead)
    if M > KERNEL_MAX_ROWS:
        raise ValueError(f"weight_only_matmul: {M} rows, the kernel takes "
                         f"at most {KERNEL_MAX_ROWS} (wider products take "
                         "the callers' dequant_route)")
    x2 = x.reshape(M, K)
    floats = (x2, scale) if bias is None else (x2, scale, bias)
    _build.check_device_tensors("weight_only_matmul", floats, ())
    if q.device != x.device or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("weight_only_matmul: codes must be contiguous and "
                         "16-byte aligned on x's device")
    if K % 16:
        raise ValueError(f"weight_only_matmul: K {K} is not a multiple of "
                         "16 (the kernel loads 16 codes at a time)")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M:
        err = _build.library().ptt_weight_only_matmul(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), M, N,
            K, _build.dtype_code(x.dtype), CODE_DTYPES[q.dtype],
            _build.stream(x.device))
        _build.check(err, "weight_only_matmul")
        weight_only_matmul.launches += 1
    return y.reshape(*lead, N)


weight_only_matmul.launches = 0
weight_only_matmul.dequant_calls = 0    # callers' wide routes (dequant_route)
