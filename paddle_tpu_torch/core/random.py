"""The port's host random source: counterpart of the stateful key source
of ``paddle_tpu/framework/random.py`` (``seed``, ``next_key``).

Off a TPU the JAX package keys its global source with threefry2x32
(``framework/random.py:_key_impl``): ``seed(n)`` stores ``key(n)``, and
every ``next_key()`` splits the stored key into (the next stored key, the
sub-key handed out).  This module keeps the same chain in
``core/threefry.py``'s integer arithmetic, so a seeded stream of draws
(``GenerationMixin.generate``'s samples) is the JAX package's bit for
bit.  Keys are pairs of uint32 words in int64 0-d tensors on the CPU;
a consumer moves them where it draws.  :class:`KeySource` is one such
chain, and ``key_source_guard`` makes another source the active one for
a block (``distributed/fleet/random.py``'s named states).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from . import threefry

__all__ = ["seed", "next_key", "KeySource", "key_source_guard"]


class KeySource:
    """A stored key split at every draw (the JAX package's
    ``StatefulKeySource``): ``next_key()`` keeps the first half and hands
    out the second.  ``get_state`` / ``set_state`` read and restore the
    stored key."""

    def __init__(self, seed_val: int = 0):
        self._key = threefry.key(torch.tensor(int(seed_val)))
        self._lock = threading.Lock()

    def next_key(self):
        with self._lock:
            self._key, sub = threefry.split(self._key)
        return sub

    def get_state(self):
        return tuple(w.clone() for w in self._key)

    def set_state(self, key) -> None:
        with self._lock:
            self._key = tuple(w.clone() for w in key)


_SOURCE = KeySource(0)
_STACK: list = []                     # key_source_guard's sources


def seed(n: int) -> None:
    """Reset the source to ``key(n)`` (the JAX package's ``paddle.seed``
    for its global key)."""
    global _SOURCE
    _SOURCE = KeySource(n)


def next_key():
    """Split the active source's key: keep the first half, hand out the
    second (``jax.random.split(key)`` then ``key, sub = ...``)."""
    return (_STACK[-1] if _STACK else _SOURCE).next_key()


@contextlib.contextmanager
def key_source_guard(source: KeySource):
    """Draws inside the block come from ``source`` (the JAX package's
    ``key_source_guard``: the RNG tracker's named states)."""
    _STACK.append(source)
    try:
        yield source
    finally:
        _STACK.pop()
