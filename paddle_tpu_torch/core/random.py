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

:func:`rng_checkpoint_state` / :func:`restore_rng_checkpoint_state` (the
JAX package's pair) snapshot and restore the active key chain, torch's
default generators (the CPU one, and each card's once CUDA is up) and any
``torch.Generator`` the caller names: a model's own dropout generator,
``hapi.Model.fit``'s checkpoints pass every one its network holds.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from . import threefry

__all__ = ["seed", "next_key", "KeySource", "key_source_guard",
           "module_generators", "rng_checkpoint_state",
           "restore_rng_checkpoint_state"]


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


def module_generators(module) -> list:
    """Every ``torch.Generator`` the modules of ``module`` (an
    ``nn.Module``) hold, once each, in module order: the port's models
    draw their dropout from their own."""
    found = {}
    for m in module.modules():
        for v in vars(m).values():
            if isinstance(v, torch.Generator):
                found[id(v)] = v
    return list(found.values())


def _active() -> KeySource:
    return _STACK[-1] if _STACK else _SOURCE


def _bytes(state: torch.Tensor) -> np.ndarray:
    return state.detach().cpu().numpy().copy()


def rng_checkpoint_state(generators=()) -> dict:
    """A host snapshot of every random source a resumed process must
    continue from: the active key chain's key (``key_data``, two uint32
    words, and ``impl``, as the JAX package's), torch's default CPU
    generator, each card's default generator once CUDA is initialised,
    and the states of ``generators`` (in their order).  Every state is a
    numpy array, so the snapshot rides a checkpoint's array leaves."""
    key = _active().get_state()
    out = {"key_data": np.array([int(w) & 0xFFFFFFFF for w in key],
                                dtype=np.uint32),
           "impl": "threefry2x32",
           "torch": _bytes(torch.get_rng_state()),
           "generators": {str(i): _bytes(g.get_state())
                          for i, g in enumerate(generators)}}
    if torch.cuda.is_initialized():
        out["cuda"] = {str(i): _bytes(s)
                       for i, s in enumerate(torch.cuda.get_rng_state_all())}
    return out


def restore_rng_checkpoint_state(state: dict, generators=()) -> None:
    """The inverse of :func:`rng_checkpoint_state` (given the same
    ``generators``): the draws that follow are the snapshotted process's.
    A snapshot of other generators than those given raises."""
    if str(state.get("impl", "threefry2x32")) != "threefry2x32":
        raise ValueError(f"a {state['impl']} key: the port's chain is "
                         "threefry2x32")
    words = np.asarray(state["key_data"]).astype(np.int64)
    _active().set_state(tuple(torch.tensor(int(w)) for w in words))
    if "torch" in state:
        torch.set_rng_state(torch.from_numpy(np.asarray(state["torch"],
                                                        np.uint8).copy()))
    saved = state.get("generators") or {}
    if len(saved) != len(generators):
        raise ValueError(f"the snapshot holds {len(saved)} generators, "
                         f"{len(generators)} were given")
    for i, g in enumerate(generators):
        g.set_state(torch.from_numpy(np.asarray(saved[str(i)],
                                                np.uint8).copy()))
    cuda = state.get("cuda") or {}
    if cuda:
        torch.cuda.set_rng_state_all(
            [torch.from_numpy(np.asarray(cuda[str(i)], np.uint8).copy())
             for i in range(len(cuda))])
