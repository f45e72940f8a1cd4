"""Quantization configuration.

Counterpart of ``paddle_tpu/quantization/config.py`` (Paddle's
``QuantConfig``: a default, per-type and per-layer configs).  Quanters are
given as classes (a fresh instance per layer) or instances (deep-copied
per layer).
"""

from __future__ import annotations

from typing import Dict, Optional, Type

import torch.nn as nn

__all__ = ["QuantConfig"]


class _LayerConfig:
    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight


class QuantConfig:
    def __init__(self, activation=None, weight=None):
        self._default = _LayerConfig(activation, weight)
        self._by_type: Dict[Type[nn.Module], _LayerConfig] = {}
        self._by_layer: Dict[int, _LayerConfig] = {}

    def add_type_config(self, layer_types, activation=None, weight=None):
        if not isinstance(layer_types, (list, tuple)):
            layer_types = [layer_types]
        for t in layer_types:
            self._by_type[t] = _LayerConfig(activation, weight)

    def add_layer_config(self, layers, activation=None, weight=None):
        if not isinstance(layers, (list, tuple)):
            layers = [layers]
        for layer in layers:
            self._by_layer[id(layer)] = _LayerConfig(activation, weight)

    def config_for(self, layer: nn.Module) -> Optional[_LayerConfig]:
        """A layer's own config, else its type's, else the default (if it
        names a quanter)."""
        if id(layer) in self._by_layer:
            return self._by_layer[id(layer)]
        for t, cfg in self._by_type.items():
            if isinstance(layer, t):
                return cfg
        if self._default.activation or self._default.weight:
            return self._default
        return None
