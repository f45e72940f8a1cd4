"""Dropout: counterpart of ``paddle_tpu/nn/functional/common.py`` dropout
(mode ``upscale_in_train``): keep each element with probability 1 - p
and divide the kept ones by 1 - p in training; the identity otherwise.

Randomness comes from an explicit ``torch.Generator``, the model's.  A
generator on another device than ``x`` (the model keeps its own on the
host) seeds a generator on ``x``'s device with one draw, so the mask is
made where ``x`` lives and the host never waits for the card.
"""

from __future__ import annotations

import torch

__all__ = ["dropout"]


def _device_generator(generator, device: torch.device):
    """``generator`` if it is on ``device`` (or None), else a generator on
    ``device`` seeded from one draw of ``generator``."""
    if generator is None or generator.device == device:
        return generator
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x, p: float = 0.5, training: bool = True, generator=None):
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=_device_generator(generator,
                                                           x.device),
                      device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
