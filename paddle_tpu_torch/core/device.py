"""Where the port runs: the card unless the caller asks for the CPU.

Counterpart of ``paddle_tpu/core/device.py``, which maps paddle places onto
JAX devices.  Here there are two places: ``cuda`` (the H100, the default)
and ``cpu`` (the plain PyTorch versions of the kernels, for tests).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless ``device`` says otherwise.  Raises when CUDA is
    absent and the caller did not ask for ``cpu``: the port never moves to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"paddle_tpu_torch runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU "
            "with the plain PyTorch versions of the kernels")
    return dev
