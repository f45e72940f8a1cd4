"""Quantization-aware training.

Counterpart of ``paddle_tpu/quantization/qat.py`` (Paddle's ``QAT``
swapping layers for their fake-quantized twins, and ``QuantedLinear``).
``QuantedConv2D`` waits until the port has ``Conv2D`` (see ROADMAP.md).
"""

from __future__ import annotations

import copy

import torch.nn as nn
import torch.nn.functional as F

from .config import QuantConfig

__all__ = ["QAT", "QuantedLinear"]


def _make(quanter):
    if quanter is None:
        return None
    if isinstance(quanter, type):
        return quanter()
    return copy.deepcopy(quanter)


class QuantedLinear(nn.Module):
    """``nn.Linear`` with a fake-quantized weight and (optionally)
    activation; it shares the linear's weight and bias."""

    def __init__(self, linear: nn.Linear, cfg):
        super().__init__()
        self.weight = linear.weight
        self.bias = linear.bias
        self.weight_quanter = _make(cfg.weight)
        self.activation_quanter = _make(cfg.activation)

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return F.linear(x, w, self.bias)


_SWAPS = {nn.Linear: QuantedLinear}


class QAT:
    """model -> fake-quantized model (on a deep copy unless ``inplace``).

    Parity: ``QAT(config).quantize(model, inplace=False)``."""

    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model: nn.Module, inplace: bool = False) -> nn.Module:
        model = model if inplace else copy.deepcopy(model)
        self._swap(model)
        return model

    def _swap(self, layer: nn.Module):
        for name, child in list(layer._modules.items()):
            cfg = self._config.config_for(child)
            dst = _SWAPS.get(type(child)) if cfg is not None else None
            if dst is not None:
                layer._modules[name] = dst(child, cfg)
            else:
                self._swap(child)
