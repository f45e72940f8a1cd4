"""Fake quantization with straight-through gradients.

Counterpart of ``paddle_tpu/quantization/quanters.py``: the
quantize-dequantize round trip at an absmax scale, whose gradient passes
through inside the clip range and is zero outside (the estimator of
Paddle's ``fake_quantize_dequantize_abs_max`` kernel), and the QAT quanter
with an EMA of the absmax.  No kernel: elementwise ops.
"""

from __future__ import annotations

import torch
import torch.nn as nn

__all__ = ["fake_quantize_absmax", "quantize_dequantize",
           "FakeQuanterWithAbsMaxObserver"]


def _qdq(x, scale, bits):
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
    return q * s / qmax


class QuantizeDequantize(torch.autograd.Function):
    """The round trip with the JAX package's straight-through VJP: the
    cotangent where ``|x| <= max(scale, 1e-8)``, zero elsewhere; no
    gradient to the scale."""

    @staticmethod
    def forward(ctx, x, scale, bits):
        ctx.save_for_backward(x, scale)
        return _qdq(x, scale, bits)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        mask = (x.abs() <= torch.clamp(scale, min=1e-8)).to(g.dtype)
        return g * mask, None, None


def quantize_dequantize(x, scale, bits: int = 8):
    """STE quantize-dequantize round trip at the given absmax scale."""
    return QuantizeDequantize.apply(x, torch.as_tensor(scale,
                                                       device=x.device),
                                    bits)


def fake_quantize_absmax(x, bits: int = 8):
    """One-shot fake quant at the tensor's current absmax."""
    return quantize_dequantize(x, x.detach().abs().max(), bits)


class FakeQuanterWithAbsMaxObserver(nn.Module):
    """QAT activation/weight quanter with an EMA absmax scale (the first
    training call takes the absmax itself).  Parity: Paddle's
    ``quanters/abs_max.py`` (``moving_rate``, ``bit_length``)."""

    def __init__(self, moving_rate: float = 0.9, bit_length: int = 8,
                 name=None):
        super().__init__()
        self.moving_rate = moving_rate
        self.bit_length = bit_length
        self.register_buffer("scale", torch.tensor(0.0))
        self._initialized = False

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                cur = x.detach().abs().max().to(self.scale.dtype)
                if not self._initialized:
                    new = cur
                    self._initialized = True
                else:
                    r = self.moving_rate
                    new = self.scale * r + cur * (1.0 - r)
                self.scale.copy_(new)
        return quantize_dequantize(x, self.scale, self.bit_length)
