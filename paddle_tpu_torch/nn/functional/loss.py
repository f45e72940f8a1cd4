"""Cross-entropy with paddle's reduction: counterpart of ``_ce_impl`` in
``paddle_tpu/nn/functional/loss.py`` (hard labels).

The log-softmax and the per-row loss are ``F.cross_entropy``'s (a library
call, as the JAX package leaves them to XLA), always in float32: the JAX
package's O1 lists keep cross-entropy out of the low-precision set, and so
does torch's autocast.  ``reduction="mean"`` divides by the number of
labels that are not ``ignore_index`` (at least 1), as paddle does, so a
batch whose labels are all ignored gives 0, not NaN.
"""

from __future__ import annotations

import torch.nn.functional as F

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index: int = -100,  # noqa: A002
                  reduction: str = "mean"):
    """``input`` ``[N, C]`` logits, ``label`` ``[N]`` (or ``[N, 1]``)
    class indices; ``reduction`` is ``mean``, ``sum`` or ``none``."""
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    label = label.long()
    per = F.cross_entropy(input.float(), label, ignore_index=ignore_index,
                          reduction="none")
    if reduction == "none":
        return per
    if reduction == "sum":
        return per.sum()
    if reduction != "mean":
        raise ValueError(f"cross_entropy: reduction {reduction!r}")
    valid = (label != ignore_index).sum().clamp_min(1)
    return per.sum() / valid
