"""The RNG state tracker of tensor parallelism: counterpart of
``paddle_tpu/distributed/fleet/random.py`` (Paddle's
``fleet/layers/mpu/random.py``).

A named state is a :class:`~paddle_tpu_torch.core.random.KeySource` of
its own; ``rng_state(name)`` makes it the active source of
``core/random.py`` for the block, so draws inside differ from rank to
rank where the state's seed does.  ``model_parallel_random_seed(seed)``
seeds the global source with ``seed`` (the same on every rank) and adds
the state ``"model_parallel_rng"`` with ``seed + 1024 + rank`` (this
rank's own), as the JAX package does.

The port's models draw their dropout from their own ``torch.Generator``,
the same on every tensor-parallel rank; attention dropout over a rank's
heads draws the masks of those heads of the whole model
(``ops/flash_attention.py`` ``mask_heads``), so no tracker state is
needed for it.
"""

from __future__ import annotations

import contextlib
import random as _pyrandom

from ...core import random as _random
from ..env import get_rank

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "determinate_seed",
           "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_.clear()
        self.seeds_.clear()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already added")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"state {name} already added")
        self.states_[name] = _random.KeySource(seed)

    def get_states_tracker(self):
        return {n: s.get_state() for n, s in self.states_.items()}

    def set_states_tracker(self, states):
        for n, v in states.items():
            if n in self.states_:
                self.states_[n].set_state(v)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} not added yet")
        with _random.key_source_guard(self.states_[name]):
            yield


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None):
    seed = seed if seed is not None else _pyrandom.randint(0, 2 ** 31 - 1)
    _tracker.reset()
    _random.seed(seed)
    _tracker.add(MODEL_PARALLEL_RNG, seed + 1024 + get_rank())


def determinate_seed(name):
    return 0
