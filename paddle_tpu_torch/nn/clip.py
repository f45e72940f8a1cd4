"""Global-norm gradient clipping: counterpart of
``paddle_tpu/nn/clip.py:ClipGradByGlobalNorm``."""

from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scales every gradient by ``clip_norm / max(global_norm, clip_norm)``
    (so by 1 when the norm is within the limit), with ``global_norm`` the
    2-norm over all gradients together, taken in float32.

    Called with ``[(param, grad), ...]``; scales the gradients in place
    and returns the list.  The scale stays on the device: no sync."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return list(params_grads)
        norms = torch._foreach_norm([g.float() for g in grads])
        total = torch.linalg.vector_norm(torch.stack(norms))
        scale = self.clip_norm / total.clamp_min(self.clip_norm)
        torch._foreach_mul_(grads, scale)
        return list(params_grads)
