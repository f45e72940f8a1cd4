"""Activation recomputation: counterpart of
``paddle_tpu/distributed/fleet/recompute.py``.

``recompute(function, *args, policy=None)`` runs ``function`` under
``torch.utils.checkpoint`` (non-reentrant): the forward keeps only what
the policy saves, and the backward runs the region again for the rest.

- ``policy=None`` (or ``"nothing_saveable"``): full recompute, the region's
  inputs alone are kept (Megatron's "full" granularity).
- A ``jax.checkpoint_policies`` name maps to a selective-checkpoint policy
  where torch has a meaning for it: ``"dots_with_no_batch_dims_saveable"``
  (alias ``"checkpoint_dots_with_no_batch_dims"``) saves the outputs of the
  2-D matrix products (``aten.mm``, ``aten.addmm``: every ``nn.Linear``)
  and recomputes everything else, the flash kernels included (their
  launches are not aten ops, so the policy never sees them and they run
  again); ``"dots_saveable"`` (``"checkpoint_dots"``) also saves batched
  products (``bmm``, ``baddbmm``); ``"everything_saveable"`` saves all.
  Every other name raises, naming itself.

Randomness: the JAX package captures the region's draws at trace time, so
forward and recompute see the same randomness.  ``torch.utils.checkpoint``
restores only the global RNG states, while the port's models draw their
dropout (the flash kernels' seeds, the elementwise masks) from their own
``torch.Generator``.  So the region's generators (every
``torch.Generator`` attribute of the modules of ``function``, or of the
module a bound method belongs to) are recorded at the forward and put
back for the recompute, and restored afterwards: the recompute draws the
forward's seeds and masks, and the generators advance once, as without
recompute.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List

import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...core.random import module_generators

__all__ = ["recompute", "POLICIES"]

_aten = torch.ops.aten
_DOTS_2D = (_aten.mm.default, _aten.addmm.default)
_DOTS = _DOTS_2D + (_aten.bmm.default, _aten.baddbmm.default)

# jax.checkpoint_policies name -> the aten ops whose outputs are saved
# (None: full recompute; "all": nothing recomputed)
POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": "all",
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_2D,
    "checkpoint_dots_with_no_batch_dims": _DOTS_2D,
}


def _policy_fn(saved):
    def policy(ctx, func, *args, **kwargs):
        if saved == "all" or func in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _generators(function) -> List[torch.Generator]:
    owner = function if isinstance(function, nn.Module) \
        else getattr(function, "__self__", None)
    if not isinstance(owner, nn.Module):
        return []
    return module_generators(owner)


class _Replay:
    """The generators' states at the region's forward (``Record``), put
    back for its recompute (``Replay``) and restored after it."""

    def __init__(self, gens):
        self.gens = gens
        self.states = None

    @contextlib.contextmanager
    def record(self):
        self.states = [g.get_state() for g in self.gens]
        yield

    @contextlib.contextmanager
    def replay(self):
        now = [g.get_state() for g in self.gens]
        for g, s in zip(self.gens, self.states):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(self.gens, now):
                g.set_state(s)


def recompute(function: Callable, *args, preserve_rng_state: bool = True,
              use_reentrant: bool = True, policy: str = None,
              **kwargs) -> Any:
    """Run ``function(*args, **kwargs)`` with activation recomputation in
    backward (``use_reentrant`` is taken for paddle's signature: the port
    always checkpoints non-reentrantly, as the JAX package's region is one
    op whatever it says).  ``policy``: see the module docstring."""
    if policy is not None and policy not in POLICIES:
        raise ValueError(
            f"recompute policy {policy!r} has no counterpart in the port "
            f"(taken: {sorted(POLICIES)})")
    saved = POLICIES.get(policy) if policy is not None else None
    replay = _Replay(_generators(function))

    def context_fn():
        fwd, rec = replay.record(), replay.replay()
        if saved is None:
            return fwd, rec
        sac_fwd, sac_rec = create_selective_checkpoint_contexts(
            _policy_fn(saved))
        return _both(fwd, sac_fwd), _both(rec, sac_rec)

    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=context_fn, **kwargs)


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield
