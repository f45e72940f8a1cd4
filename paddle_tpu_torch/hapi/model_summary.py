"""Model summary: the per-layer parameter table of
``paddle_tpu/hapi/model_summary.py`` over an ``nn.Module`` (a static walk
of the modules' own parameters; no forward runs)."""

from __future__ import annotations

import torch.nn as nn

__all__ = ["summary"]


def summary(net: nn.Module, input_size=None, dtypes=None, verbose=1):
    """Print each module that owns parameters, with their count, and the
    totals; returns ``{"total_params", "trainable_params"}``
    (trainable: ``requires_grad``)."""
    rows = []
    total = trainable = 0
    for name, module in net.named_modules():
        own = list(module.parameters(recurse=False))
        if not own:
            continue
        n = sum(p.numel() for p in own)
        t = sum(p.numel() for p in own if p.requires_grad)
        rows.append((name or type(module).__name__, type(module).__name__,
                     n))
        total += n
        trainable += t
    if verbose:
        w = max((len(r[0]) for r in rows), default=10) + 2
        print(f"{'Layer':<{w}}{'Type':<24}{'Params':>12}")
        print("-" * (w + 36))
        for name, ty, n in rows:
            print(f"{name:<{w}}{ty:<24}{n:>12,}")
        print("-" * (w + 36))
        print(f"Total params: {total:,}")
        print(f"Trainable params: {trainable:,}")
        print(f"Non-trainable params: {total - trainable:,}")
    return {"total_params": total, "trainable_params": trainable}
