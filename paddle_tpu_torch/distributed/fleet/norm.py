"""What an optimizer step needs from the other ranks when each rank holds
a part of the gradients (tensor parallelism, ZeRO).

The JAX package's tensor-parallel and ZeRO steps run on global arrays, so
its global-norm clip sees every gradient, a GradScaler's ``found_inf`` is
one value, and ``ClipGradByGlobalNorm._global_norm_reduce_fn``
(``paddle_tpu/nn/clip.py:118``) is never set.  In the port a rank holds
shards, so a step reduces two things over the groups that split the
gradients (the mp group, then the sharding group):

- per tensor its sum of squares, weighted so that the sum over the ranks
  counts each element once: weight 1 on the groups a tensor is split
  over, ``1 / nranks`` on each group that holds it whole (layer norms,
  ``wpe``, a row-parallel bias, a ZeRO tensor no dimension of which
  divides); the global norm is the sum of the reduced sums, a tensor's
  own norm its reduced sum;
- the non-finite flag, summed (any rank's overflow skips every rank's
  step).

A tensor is split over ``mp`` when it carries ``mp_split``
(``mp_layers.py``), and over the groups named in its ``_split_over``
(ZeRO's shards).  :class:`CrossRankNorm` is given to an optimizer by
``fleet.distributed_optimizer`` and by the ZeRO wrappers
(``Optimizer._set_grad_reduce``): the fused step's split norm
(``ops/fused_optimizer.py``), the list rules' clips (``nn/clip.py``) and
the GradScaler's host path read it.
"""

from __future__ import annotations

import torch

from .. import collective as _coll

__all__ = ["CrossRankNorm", "split_over"]


def split_over(t) -> frozenset:
    """The names of the groups ``t`` is split over."""
    s = getattr(t, "_split_over", None)
    if s is not None:
        return frozenset(s)
    return frozenset(("mp",)) if getattr(t, "mp_split", False) \
        else frozenset()


class CrossRankNorm:
    """Sums over ``groups`` (name -> ``Group``, in reduction order; groups
    of one rank are dropped)."""

    def __init__(self, groups: dict):
        self.groups = {n: g for n, g in groups.items()
                       if g is not None and g.nranks > 1}

    def __bool__(self) -> bool:
        return bool(self.groups)

    def weight(self, t) -> float:
        w, split = 1.0, split_over(t)
        for name, g in self.groups.items():
            if name not in split:
                w /= g.nranks
        return w

    def weights(self, tensors) -> list:
        return [self.weight(t) for t in tensors]

    @torch.no_grad()
    def reduce(self, vec: torch.Tensor) -> torch.Tensor:
        """Sum ``vec`` over every group, in place."""
        for g in self.groups.values():
            _coll.all_reduce(vec, _coll.ReduceOp.SUM, g)
        return vec

    @torch.no_grad()
    def per_tensor_sq(self, tensors, sq) -> torch.Tensor:
        """The global sums of squares of ``tensors`` from their local
        ones ``sq`` (float32, one per tensor)."""
        w = torch.tensor(self.weights(tensors), dtype=torch.float64)
        vec = torch.stack([s.double() for s in sq]) * w.to(sq[0].device)
        return self.reduce(vec).float()

    @torch.no_grad()
    def any_found(self, found: torch.Tensor) -> torch.Tensor:
        """Whether any rank's ``found`` (a bool tensor) is set."""
        v = found.double().reshape(1)
        return self.reduce(v)[0] > 0
