"""Counterpart of ``paddle_tpu/framework/``: ``save`` / ``load`` (the
Tensor and its tape map onto torch and are not copied)."""

from .io import load, save

__all__ = ["save", "load"]
