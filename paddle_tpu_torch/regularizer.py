"""Weight-decay regularizers: the port's copy of
``paddle_tpu/regularizer.py``.  An optimizer's ``weight_decay`` may be a
float or an ``L2Decay`` (both added to the gradient as ``coeff * w``, or
decoupled by AdamW) or an ``L1Decay`` (``coeff * sign(w)`` added to the
gradient, on the per-tensor path only: the fused step falls back for it,
as the JAX package's does)."""

from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self._coeff})"


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay({self._coeff})"
