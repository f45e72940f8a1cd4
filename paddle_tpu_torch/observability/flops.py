"""FLOPs per token and MFU.

The port's own copy of ``paddle_tpu/observability/flops.py``
(``training_flops_per_token``, ``peak_flops``, ``mfu``), with the peak
table of the cards the port runs on.  A train step (forward and backward)
costs ``6 * N`` FLOPs per token for the weights (N parameters: 2 forward
and 4 backward per weight) plus ``12 * L * H * S`` for attention's two
batched matrix products over a sequence of S tokens, forward and backward.
Recompute does not inflate the count: MFU counts the model's FLOPs.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["training_flops_per_token", "peak_flops", "mfu"]


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


# dense bfloat16 tensor-core peak per card by device name (NVIDIA's data
# sheets, SXM parts, at the full power limit).  Anything else reads as
# the CPU's deliberate 2e12, so a CPU run's MFU is a schema check, not a
# measurement.
_PEAK_TABLE = {
    "h100": 989e12,
    "h200": 989e12,
}


def peak_flops(device_kind: Optional[str]) -> float:
    """bf16 peak FLOP/s of a card, by ``torch.cuda.get_device_name``."""
    kind = (device_kind or "").lower()
    for k, v in _PEAK_TABLE.items():
        if k in kind:
            return v
    return 2e12


def mfu(tokens_per_sec: float, flops_per_token: float,
        device_kind: Optional[str] = None,
        peak: Optional[float] = None) -> float:
    """Model FLOPs utilization: achieved FLOP/s over peak FLOP/s."""
    if peak is None:
        peak = peak_flops(device_kind)
    if not peak or peak <= 0:
        return 0.0
    return tokens_per_sec * flops_per_token / peak
