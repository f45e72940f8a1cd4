"""RMSNorm: counterpart of ``paddle_tpu/nn/functional/norm.py:rms_norm``.

The JAX formula exactly: ``(x32 * rsqrt(mean(x32^2) + eps)).to(x.dtype) *
weight`` with ``x32 = x.float()``; ``torch.nn.RMSNorm`` rounds in another
order.  The op is on the JAX package's amp black list
(``paddle_tpu/ops/specs/registered_ops.yaml``): under ``auto_cast`` its
inputs are taken to float32 first, so it runs and returns float32 (under
custom autocast lists, as ``amp/op_lists.py`` rules for ``rms_norm``).
"""

from __future__ import annotations

import torch

from ...amp import op_lists

__all__ = ["rms_norm"]


def rms_norm(x, weight=None, epsilon: float = 1e-6, axis: int = -1):
    if torch.is_autocast_enabled(x.device.type):
        x = x.float()
        weight = None if weight is None else weight.float()
    x, weight = op_lists.cast_inputs("rms_norm", x, weight)
    with op_lists.outside_lists():
        x32 = x.float()
        var = x32.square().mean(dim=axis, keepdim=True)
        out = (x32 * torch.rsqrt(var + epsilon)).to(x.dtype)
        return out if weight is None else out * weight
