"""Gradient clipping: counterpart of ``paddle_tpu/nn/clip.py``
(``ClipGradBase``, ``ClipGradByValue``, ``ClipGradByNorm``,
``ClipGradByGlobalNorm``, ``clip_grad_norm_``).

A clip object is called with ``[(param, grad), ...]``, scales or clamps
the gradients of the parameters whose ``need_clip`` attribute is not
False IN PLACE (the JAX package returns new arrays; the port saves the
copy) and returns the list.  Nothing is read back to the host.  The fused
optimizer step (``optimizer/fused.py``) carries the three kinds into its
kernels instead of calling these; a subclass of them takes the list
rules there.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError

    @staticmethod
    def _applicable(params_grads):
        """The gradients this clip applies to: present, and the parameter
        opted in (``need_clip``)."""
        return [g for p, g in params_grads
                if g is not None and getattr(p, "need_clip", True)]


class ClipGradByValue(ClipGradBase):
    """Clamps every gradient to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def __call__(self, params_grads):
        for g in self._applicable(params_grads):
            g.clamp_(self.min, self.max)
        return list(params_grads)


class ClipGradByNorm(ClipGradBase):
    """Scales each gradient on its own by ``clip_norm / norm`` where its
    2-norm exceeds ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params_grads):
        cn = self.clip_norm
        for g in self._applicable(params_grads):
            norm = torch.sqrt(torch.sum(torch.square(g)))
            g.mul_(torch.where(norm > cn, cn / torch.clamp(norm, min=1e-12),
                               torch.ones_like(norm)))
        return list(params_grads)


class ClipGradByGlobalNorm(ClipGradBase):
    """Scales every gradient by ``clip_norm / max(global_norm,
    clip_norm)`` (so by 1 when the norm is within the limit), with
    ``global_norm`` the 2-norm over all gradients together, taken in
    float32.  The scale stays on the device: no sync."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @torch.no_grad()
    def __call__(self, params_grads):
        grads = self._applicable(params_grads)
        if not grads:
            return list(params_grads)
        norms = torch._foreach_norm([g.float() for g in grads])
        total = torch.linalg.vector_norm(torch.stack(norms))
        scale = self.clip_norm / total.clamp_min(self.clip_norm)
        torch._foreach_mul_(grads, scale)
        return list(params_grads)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scales the gradients of ``parameters`` in place by ``min(max_norm
    / (total + 1e-6), 1)``, ``total`` their ``norm_type``-norm taken
    together; returns ``total``."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.max(torch.stack([g.abs().max() for g in grads]))
    else:
        total = torch.pow(sum(torch.sum(torch.pow(g.abs(), norm_type))
                              for g in grads), 1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"clip_grad_norm_: the total norm is {total}")
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return total
