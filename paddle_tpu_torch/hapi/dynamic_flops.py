"""``flops``: the per-layer multiply-accumulate count of
``paddle_tpu/hapi/dynamic_flops.py``, through forward hooks on the leaf
modules of one forward at ``input_size``.

Counts: ``nn.Linear`` output elements x in_features, convolutions output
elements x the kernel's (in / groups) x k volume, the norms 2 x input
elements, activations input elements, pools output elements,
``nn.Embedding`` 0 (a gather).  ``custom_ops`` maps a module type to
``fn(module, input, output) -> int`` and takes precedence.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

__all__ = ["flops"]


def _numel(shape):
    return math.prod(shape) if len(shape) else 1


def _count_linear(module, x, y) -> int:
    return _numel(y.shape) * module.in_features


def _count_conv(module, x, y) -> int:
    return _numel(y.shape) * _numel(module.weight.shape[1:])


def _count_norm(module, x, y) -> int:
    return 2 * _numel(x.shape)


def _count_activation(module, x, y) -> int:
    return _numel(x.shape)


def _count_pool(module, x, y) -> int:
    return _numel(y.shape)


def _count_embedding(module, x, y) -> int:
    return 0


def _handlers():
    from ..nn.norm import RMSNorm
    return [
        (nn.Linear, _count_linear),
        ((nn.Conv1d, nn.Conv2d, nn.Conv3d), _count_conv),
        ((nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm,
          RMSNorm, nn.RMSNorm), _count_norm),
        ((nn.ReLU, nn.GELU, nn.Sigmoid, nn.Tanh, nn.SiLU), _count_activation),
        ((nn.MaxPool2d, nn.AvgPool2d, nn.AdaptiveAvgPool2d), _count_pool),
        (nn.Embedding, _count_embedding),
    ]


def flops(net: nn.Module, input_size: Sequence[int],
          custom_ops: Optional[Dict] = None, print_detail: bool = False) -> int:
    """Total multiply-accumulate count of one forward of float32 zeros of
    ``input_size`` (batch dimension included), on the network's device."""
    handlers = list((custom_ops or {}).items()) + _handlers()
    counts: Dict[int, int] = {}
    rows = []

    def hook(module, inputs, outputs):
        x = inputs[0] if isinstance(inputs, tuple) else inputs
        y = outputs[0] if isinstance(outputs, tuple) else outputs
        if not isinstance(x, torch.Tensor) or not isinstance(y, torch.Tensor):
            return
        for kind, fn in handlers:
            if isinstance(module, kind):
                n = int(fn(module, x, y))
                counts[id(module)] = counts.get(id(module), 0) + n
                rows.append((type(module).__name__, tuple(y.shape), n))
                return

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if not any(True for _ in m.children())]
    device = next(net.parameters()).device
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(torch.zeros(list(input_size), device=device))
    finally:
        for h in hooks:
            h.remove()
        net.train(was_training)
    total = sum(counts.values())
    if print_detail:
        print(f"{'Layer':<24}{'Output shape':<24}{'FLOPs':>14}")
        print("-" * 62)
        for name, shape, n in rows:
            print(f"{name:<24}{str(list(shape)):<24}{n:>14,}")
        print("-" * 62)
        print(f"Total FLOPs (MACs): {total:,}")
    return total
