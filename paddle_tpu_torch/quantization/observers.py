"""PTQ observers.

Counterpart of ``paddle_tpu/quantization/observers.py``
(``AbsmaxObserver``, Paddle's ``observers/abs_max.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .quanters import quantize_dequantize

__all__ = ["AbsmaxObserver"]


class AbsmaxObserver(nn.Module):
    """Collects the running absmax during calibration (passing the signal
    through untouched); after ``PTQ.convert`` the observed scale drives
    quantize-dequantize."""

    def __init__(self, quant_bits: int = 8, name=None):
        super().__init__()
        self.quant_bits = quant_bits
        self.register_buffer("scale", torch.tensor(1e-8))
        self._observing = True

    def observe(self, on: bool = True):
        self._observing = on

    def forward(self, x):
        if self._observing:
            with torch.no_grad():
                cur = x.detach().abs().max().to(self.scale.dtype)
                self.scale.copy_(torch.maximum(self.scale, cur))
            return x
        return quantize_dequantize(x, self.scale, self.quant_bits)
