"""The port's host random source: counterpart of the stateful key source
of ``paddle_tpu/framework/random.py`` (``seed``, ``next_key``).

Off a TPU the JAX package keys its global source with threefry2x32
(``framework/random.py:_key_impl``): ``seed(n)`` stores ``key(n)``, and
every ``next_key()`` splits the stored key into (the next stored key, the
sub-key handed out).  This module keeps the same chain in
``core/threefry.py``'s integer arithmetic, so a seeded stream of draws
(``GenerationMixin.generate``'s samples) is the JAX package's bit for
bit.  Keys are pairs of uint32 words in int64 0-d tensors on the CPU;
a consumer moves them where it draws.
"""

from __future__ import annotations

import threading

import torch

from . import threefry

__all__ = ["seed", "next_key"]

_LOCK = threading.Lock()
_KEY = threefry.key(torch.tensor(0))


def seed(n: int) -> None:
    """Reset the source to ``key(n)`` (the JAX package's ``paddle.seed``
    for its global key)."""
    global _KEY
    with _LOCK:
        _KEY = threefry.key(torch.tensor(int(n)))


def next_key():
    """Split the stored key: keep the first half, hand out the second
    (``jax.random.split(key)`` then ``key, sub = ...``)."""
    global _KEY
    with _LOCK:
        _KEY, sub = threefry.split(_KEY)
    return sub

