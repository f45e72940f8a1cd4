"""FLOPs per token for MFU.

The port's own copy of ``training_flops_per_token`` from
``paddle_tpu/observability/flops.py``: a train step (forward and backward)
costs ``6 * N`` FLOPs per token for the weights (N parameters: 2 forward
and 4 backward per weight) plus ``12 * L * H * S`` for attention's two
batched matrix products over a sequence of S tokens, forward and backward.
Recompute does not inflate the count: MFU counts the model's FLOPs.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["training_flops_per_token"]


def training_flops_per_token(n_params: float,
                             num_layers: Optional[int] = None,
                             hidden_size: Optional[int] = None,
                             seq_len: Optional[int] = None) -> float:
    """Train-step FLOPs per token, ``6N + 12 L H S``; the attention term
    only when L, H and S are all given."""
    flops = 6.0 * float(n_params)
    if num_layers and hidden_size and seq_len:
        flops += 12.0 * num_layers * hidden_size * seq_len
    return flops
