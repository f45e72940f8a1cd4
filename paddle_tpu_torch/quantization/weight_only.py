"""Weight-only int8 / fp8 quantization for the inference path.

Counterpart of ``paddle_tpu/quantization/weight_only.py``: per-channel
symmetric absmax codes, one scale per channel of the reduced axis, kept
with that axis (``keepdims``), so a scale has the weight's rank with size
1 on the reduced axis, and slicing along any other axis commutes with
quantization bit for bit.  The arithmetic is the JAX package's, op for
op, so codes and scales are bit-identical to its for float32 and
bfloat16 weights.

* **int8**: codes in [-127, 127] (the -128 code is never produced);
  scale ``absmax / 127``.
* **fp8 (e4m3fn)**: each channel scaled into the +-448 finite range and
  cast; the same one byte a weight, relative instead of uniform precision.

An all-zero channel gets the scale 1 (its codes are 0, its dequantized
weights exactly 0).  The serving engine quantizes at construction
(``inference/quant.py``); the card multiplies the codes through the
``weight_only_matmul`` kernel (``ops/weight_only.py``) where the JAX
package leaves the dequantize-and-dot to XLA.
"""

from __future__ import annotations

import torch

from ..ops.weight_only import dequantize

__all__ = ["quantize_absmax_int8", "quantize_absmax_fp8", "dequantize",
           "dequantize_int8", "QMAX", "FP8_MAX", "HAS_FP8"]

QMAX = 127  # symmetric int8: the -128 code is never produced
FP8_MAX = 448.0             # largest finite float8_e4m3fn value
_FP8 = getattr(torch, "float8_e4m3fn", None)
HAS_FP8 = _FP8 is not None


def _div(t, c):
    """``t / c`` divided element by element on ``t``'s device: PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, which
    can land an ulp away from the CPU's (and JAX's) quotient."""
    return t / torch.full_like(t, c)


def quantize_absmax_int8(w, axis: int = 0):
    """Per-channel symmetric absmax int8 over the ``axis`` dimension (the
    matmul contraction axis, so each output channel owns a scale).

    Returns ``(q, scale)``: ``q`` int8 with ``w``'s shape, ``scale`` in
    ``w``'s dtype with ``shape[axis] == 1``."""
    w = torch.as_tensor(w)
    absmax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, _div(absmax, QMAX),
                        torch.ones_like(absmax)).to(w.dtype)
    q = torch.clamp(torch.round(w / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale


def quantize_absmax_fp8(w, axis: int = 0):
    """Per-channel absmax fp8 (e4m3fn) over the ``axis`` dimension, with
    the int8 twin's shape contract.  The clip before the cast matters: the
    e4m3fn conversion does not saturate (an out-of-range value becomes
    NaN), and the division can land ``absmax / scale`` a ULP above 448."""
    if not HAS_FP8:
        raise RuntimeError(
            "this torch build has no torch.float8_e4m3fn; fp8 weight-only "
            "quantization is unavailable (use int8)")
    w = torch.as_tensor(w)
    absmax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, _div(absmax, FP8_MAX),
                        torch.ones_like(absmax)).to(w.dtype)
    q = torch.clamp(w / scale, -FP8_MAX, FP8_MAX).to(_FP8)
    return q, scale


# the historical int8-specific name; the math never was int8-specific
dequantize_int8 = dequantize
