"""``RMSNorm``: counterpart of ``paddle_tpu/nn/layer/norm.py:RMSNorm``
(a weight of ones over the last axis, :func:`rms_norm`'s formula)."""

from __future__ import annotations

import torch
import torch.nn as nn

from .functional.norm import rms_norm

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
