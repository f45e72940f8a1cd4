"""Gradient clipping: counterpart of ``paddle_tpu/nn/clip.py``
(``ClipGradBase``, ``ClipGradByValue``, ``ClipGradByNorm``,
``ClipGradByGlobalNorm``, ``clip_grad_norm_``).

A clip object is called with ``[(param, grad), ...]`` and returns the
list with the gradients of the parameters whose ``need_clip`` attribute
is not False replaced by clipped NEW tensors, as the JAX package returns
new arrays: the gradients it was given are left as they were, so
``p.grad`` after an optimizer step is what backward wrote (unscaled by a
GradScaler), whichever route the step took.  Nothing is read back to the
host.

Each clip is two parts: :meth:`ClipGradBase._prepare` (what depends on
all the gradients together: the global norm's scale) and
:meth:`ClipGradBase._clip_many` (new clipped tensors for a list of
them).  The optimizer's list rules call the two apart, so that they clip
one slice of the gradients at a time beside the update and never hold a
clipped copy of every gradient (``Optimizer._apply_per_leaf``).  The
fused optimizer step (``optimizer/fused.py``) carries the three kinds
into its kernels instead of calling these; a subclass of them takes the
list rules there, through its ``__call__``.

``_global_norm_reduce_fn`` (the JAX package's hook, set by
``fleet.distributed_optimizer`` and the ZeRO wrappers when each rank
holds a part of the gradients): ``fn(params, sq)`` turns the local sums
of squares ``sq`` of ``params``' gradients into the global ones
(``distributed/fleet/norm.py``), so the global norm and a tensor's own
norm are the whole model's.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


class ClipGradBase:
    # fn(params, sq) -> the global sums of squares (see the module's head)
    _global_norm_reduce_fn = None

    @torch.no_grad()
    def __call__(self, params_grads):
        idx = [i for i, (p, g) in enumerate(params_grads)
               if self._applies(p, g)]
        out = list(params_grads)
        if not idx:
            return out
        grads = [params_grads[i][1] for i in idx]
        prepared = self._prepare(grads, [params_grads[i][0] for i in idx])
        for i, g in zip(idx, self._clip_many(grads, prepared)):
            out[i] = (params_grads[i][0], g)
        return out

    @staticmethod
    def _applies(p, g) -> bool:
        """Whether this clip applies to ``(p, g)``: a gradient is present
        and the parameter opted in (``need_clip``)."""
        return g is not None and getattr(p, "need_clip", True)

    def _prepare(self, grads, params=None):
        """What the clip needs from all the applicable gradients (of
        ``params``) at once (None if nothing)."""
        return None

    def _global_sq(self, grads, params):
        """Each gradient's sum of squares over every rank (float32), or
        None without a reduce hook."""
        fn = self._global_norm_reduce_fn
        if fn is None or params is None:
            return None
        return fn(params, [torch.sum(torch.square(g.float()))
                           for g in grads])

    def _clip_many(self, grads, prepared):
        """New clipped tensors for ``grads`` (a part or all of the
        applicable ones), given :meth:`_prepare`'s result over all."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamps every gradient to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_many(self, grads, prepared):
        return [g.clamp(self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Scales each gradient on its own by ``clip_norm / norm`` where its
    2-norm exceeds ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _prepare(self, grads, params=None):
        sq = self._global_sq(grads, params)
        return None if sq is None else {
            id(g): torch.sqrt(s) for g, s in zip(grads, sq.unbind())}

    def _clip_many(self, grads, prepared):
        cn, out = self.clip_norm, []
        for g in grads:
            norm = prepared[id(g)] if prepared is not None else \
                torch.sqrt(torch.sum(torch.square(g)))
            out.append(g * torch.where(
                norm > cn, cn / torch.clamp(norm, min=1e-12),
                torch.ones_like(norm)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scales every gradient by ``clip_norm / max(global_norm,
    clip_norm)`` (so by 1 when the norm is within the limit), with
    ``global_norm`` the 2-norm over all gradients together, taken in
    float32.  The scale stays on the device: no sync."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _prepare(self, grads, params=None):
        sq = self._global_sq(grads, params)
        if sq is not None:
            total = torch.sqrt(sq.sum())
        else:
            norms = torch._foreach_norm([g.float() for g in grads])
            total = torch.linalg.vector_norm(torch.stack(norms))
        return self.clip_norm / total.clamp_min(self.clip_norm)

    def _clip_many(self, grads, scale):
        return list(torch._foreach_mul(grads, scale))


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
