"""Weight-only quantized linear ops in Paddle's layout.

Counterpart of ``paddle_tpu/nn/quant/__init__.py`` and its helpers
(``paddle_tpu/ops/codegen_helpers.py`` ``weight_quantize``,
``weight_dequantize``, ``weight_only_linear``), the API of Paddle's
``quantized_linear.py``.  These keep Paddle's own layout and rule, which
differ from ``quantization/weight_only.py``'s: the weight is ``[K, N]``
(in, out), the scale float32 ``[N]``, ``max(absmax, 1e-8) / 127`` (an
all-zero channel gets the scale 1e-8 / 127, not 1).

The kernels (``weight_only_matmul``, ``weight_only_gemm``) read an output
channel's codes contiguously, the ``[N, K]`` layout of ``nn.Linear``. That
layout reaches them through a transposed copy made at quantize time:
:func:`weight_quantize` returns its ``[K, N]`` codes as the transposed view
of an ``[N, K]`` contiguous tensor, and :func:`weight_only_linear` hands
the kernels that tensor, no copy at the call. A contiguous ``[K, N]``
weight from anywhere else is transposed at each call (one more read and
write of its codes).
"""

from __future__ import annotations

import torch

from ...ops.weight_only import weight_only_forward

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear"]


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1,
                    name=None):
    """Per-output-channel symmetric int8: x ``[K, N]`` -> (int8 ``[K, N]``,
    float32 scale ``[N]``).  Parity: the ``weight_quantize`` op."""
    if algo not in ("weight_only_int8", "llm.int8"):
        raise NotImplementedError(f"weight_quantize algo {algo!r}: int8 only")
    if group_size != -1:
        raise NotImplementedError("weight_quantize: per-channel scales only")
    xf = x.float()
    # XLA compiles the JAX op's division by the constant 127 into a product
    # with its float32 reciprocal; the same here, so the scales are equal
    scale = torch.clamp(xf.abs().amax(dim=0), min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    # [K, N] codes over [N, K] storage: the kernel's layout, made once here
    return q.t().contiguous().t(), scale


def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float32",
                      group_size=-1, name=None):
    """Inverse of :func:`weight_quantize`.  Parity: the
    ``weight_dequantize`` op."""
    if group_size != -1:
        raise NotImplementedError("weight_dequantize: per-channel only")
    dtype = getattr(torch, out_dtype) if isinstance(out_dtype, str) \
        else out_dtype
    return (x.float() * scale[None, :]).to(dtype)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1,
                       name=None):
    """``x @ (weight * weight_scale) + bias`` over int8 codes ``[K, N]``
    (scale and bias optional, cast to x's type), through
    ``weight_only_forward``: a kernel on the card (a shape or type neither
    takes: the counted dequantize route), the plain version on the CPU.
    Parity: the ``weight_only_linear`` op."""
    if weight_dtype != "int8":
        raise NotImplementedError("weight_only_linear: int8 weights only")
    if group_size != -1:
        raise NotImplementedError("weight_only_linear: per-channel only")
    q = weight.t()
    if not q.is_contiguous():
        q = q.contiguous()
    scale = torch.ones(q.shape[0], dtype=x.dtype, device=x.device) \
        if weight_scale is None else weight_scale.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    return weight_only_forward(x, q, scale, bias)


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0,
                    name=None):
    """Parity: ``llm_int8_linear`` (its outlier split is a CUDA memory-layout
    optimisation of Paddle's; numerically the same product as
    :func:`weight_only_linear`)."""
    return weight_only_linear(x, weight, bias, weight_scale)
