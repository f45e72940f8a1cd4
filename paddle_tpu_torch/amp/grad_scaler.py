"""Dynamic loss scaling: counterpart of ``paddle_tpu/amp/grad_scaler.py``
(``GradScaler``, ``AmpScaler``).

A disabled scaler is a strict passthrough.  Enabled, ``step()`` first
tries the fused step (``optimizer/fused.py``): unscale, the ``found_inf``
reduction, the clip, the update (skipped on overflow) and the dynamic
scale's bookkeeping run on the ``fused_adamw`` kernels, and the scale,
the good, bad and skip counts and ``found_inf`` stay ON THE CARD.  Reading
a host field (``_scale``, ``_good_steps``, ``_bad_steps``,
``_found_inf``: properties) or ``state_dict()`` / ``get_loss_scaling()``
is the one sync point, ``_sync_fused_state`` (the JAX package's ``_lazy``
fields).  A scaler step makes no device-to-host sync: ``scale(loss)``
multiplies by the scale on the card once it lives there.

The host path (``unscale_()`` then ``step()``, the recipe that clips
between the two; or a step the fused path declines) unscales the
gradients in place, reads ``found_inf`` back once, and steps the optimizer
only if every gradient is finite, as the JAX package's does.  Where the
ranks split the gradients (the optimizer's ``_grad_reduce``, tensor
parallelism and ZeRO) ``found_inf`` is reduced over them first, so no
rank steps while another skips.  An optimizer with a ``_scaler_step``
(``fleet``'s wrappers, which communicate around the step) runs the step
itself.
"""

from __future__ import annotations

import torch

from ..observability import metrics as _metrics
from ..ops.fused_optimizer import ScalerConfig

__all__ = ["GradScaler", "AmpScaler"]

# per-step outcome (outcome=ok|skipped); fused steps are counted in bulk
# at the next _sync_fused_state()
_M_FOUND_INF = _metrics.counter(
    "amp.found_inf", "GradScaler step outcomes (outcome=ok|skipped)")


class GradScaler:
    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 65536.0,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        # the card's state after a fused step: (scale float32 [1], counts
        # int32 [found, good, bad, skips since the last sync]); None = the
        # host fields are current
        self._dev_state = None
        self._steps_since_sync = 0
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._already_unscaled = False

    # host fields: reading one first brings the card's state back
    def _lazy(name):  # noqa: N805 - descriptor factory, not a method
        store = name + "_h"

        def get(self):
            self._sync_fused_state()
            return getattr(self, store)

        def set(self, v):  # noqa: A001
            setattr(self, store, v)
        return property(get, set)

    _scale = _lazy("_scale")
    _good_steps = _lazy("_good_steps")
    _bad_steps = _lazy("_bad_steps")
    _found_inf = _lazy("_found_inf")
    del _lazy

    def is_enable(self) -> bool:
        return self._enable

    is_use_dynamic_loss_scaling = is_enable

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return var
        if self._dev_state is not None:
            return var * self._dev_state[0][0].to(var.dtype)
        return var * self._scale_h

    # ------------------------------------------------- fused device state
    def _config(self) -> ScalerConfig:
        return ScalerConfig(float(self._incr_ratio),
                            float(self._decr_ratio), int(self._incr_every),
                            int(self._decr_every), bool(self._dynamic))

    def _fused_state(self, device):
        """The card's scale and counts, seeded from the host fields (fills,
        no copy from the host)."""
        if self._dev_state is None or self._dev_state[0].device != device:
            self._sync_fused_state()
            scale = torch.full((1,), self._scale_h, dtype=torch.float32,
                               device=device)
            counts = torch.zeros(4, dtype=torch.int32, device=device)
            counts[1].fill_(int(self._good_steps_h))
            counts[2].fill_(int(self._bad_steps_h))
            self._dev_state = (scale, counts)
        return self._dev_state

    def _fused_commit(self) -> None:
        self._steps_since_sync += 1

    def _sync_fused_state(self):
        """The one host read of the card's state: scale, counts, the last
        found_inf, and the outcomes since the last read on
        ``amp.found_inf``.  No-op when no fused step ran since."""
        if self._dev_state is None:
            return None
        scale, counts = self._dev_state
        self._dev_state = None
        s = float(scale.item())
        found, good, bad, nskip = (int(x) for x in counts.tolist())
        self._scale_h = s
        self._good_steps_h = good
        self._bad_steps_h = bad
        self._found_inf_h = bool(found)
        ok = self._steps_since_sync - nskip
        if ok > 0:
            _M_FOUND_INF.inc(ok, outcome="ok")
        if nskip > 0:
            _M_FOUND_INF.inc(nskip, outcome="skipped")
        self._steps_since_sync = 0
        return bool(found)

    # --------------------------------------------------------- step paths
    @torch.no_grad()
    def _unscale_and_check(self, optimizer) -> bool:
        """Divide the gradients by the scale in place; found_inf read back
        once."""
        self._sync_fused_state()
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        if not grads:
            self._found_inf = False
            return False
        inv = torch.tensor(1.0 / self._scale, dtype=torch.float32)
        bad = []
        for g in grads:
            g.mul_(inv.to(g.dtype))
            bad.append(~torch.isfinite(g).all())
        found = torch.stack(bad).any()
        red = getattr(optimizer, "_grad_reduce", None)
        if red is not None:
            found = red.any_found(found)
        self._found_inf = bool(found)
        return self._found_inf

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if hasattr(type(optimizer), "_scaler_step"):
            optimizer._scaler_step(self)
            return
        self._step(optimizer)

    def _step(self, optimizer):
        """An enabled step of ``optimizer`` (a plain ``Optimizer``)."""
        # no second unscale after unscale_() (unscale_ -> clip -> step)
        if not self._already_unscaled:
            from ..optimizer import fused as _fused
            if _fused.scaler_step(self, optimizer):
                return
            self._unscale_and_check(optimizer)
        if not self._found_inf:
            optimizer.step()
        _M_FOUND_INF.inc(outcome="skipped" if self._found_inf else "ok")
        self._already_unscaled = False
        self.update()

    def minimize(self, optimizer, scaled_loss):
        if scaled_loss.requires_grad:
            scaled_loss.backward()
        self.step(optimizer)

    def unscale_(self, optimizer):
        if self._enable:
            if hasattr(type(optimizer), "_before_unscale"):
                optimizer._before_unscale()     # ZeRO's gradient reduce
            self._unscale_and_check(optimizer)
            self._already_unscaled = True

    def update(self):
        if not (self._enable and self._dynamic):
            return
        self._sync_fused_state()
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale = self._scale * self._incr_ratio
                self._good_steps = 0

    def get_loss_scaling(self) -> torch.Tensor:
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._sync_fused_state()
        self._scale = float(v)

    def state_dict(self) -> dict:
        self._sync_fused_state()
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._sync_fused_state()
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
