"""Counter-based Threefry-2x32 random bits, bit for bit those of
``jax.random`` with ``jax_threefry_partitionable`` on (jax 0.9.0's
default), in torch integer arithmetic.

The serving engine draws a sampled request's tokens from
``fold_in(key(seed), position)`` as the JAX package's ``_next_tokens``
does (``paddle_tpu/inference/serving.py:476``), so that one seed gives one
stream in both.  Values are uint32 held in int64 tensors, masked back to
32 bits often enough that nothing leaves int64 (:func:`threefry2x32`); no
product is formed.  Works on any device; the key is a pair ``(k1, k2)`` of such
tensors with any common shape.

Counterparts, in ``jax/_src/prng.py`` and ``jax/_src/random.py``:
:func:`key` is ``threefry_seed``, :func:`fold_in` ``threefry_fold_in``,
:func:`random_bits` the partitionable ``threefry_random_bits`` (counters
from ``iota_2x32_shape``), :func:`uniform` ``_uniform`` for float32,
:func:`gumbel` ``_gumbel`` in its default "low" mode and
:func:`categorical` ``categorical`` over the last axis.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "key", "fold_in", "random_bits", "uniform",
           "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny
_ONE_BITS = 0x3F800000          # 1.0f


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) of the counter pair
    ``(x1, x2)`` under the key ``(k1, k2)``; all uint32 in int64 tensors
    that broadcast together.  Returns the pair of outputs.

    One round is ``x1 += x2; x2 = rotl(x2, r) ^ x1`` mod 2**32.  ``x1`` is
    masked only at the key injections (four additions of values below
    2**32 stay far inside int64) and ``x2`` once per round, after the XOR:
    its high bits come from ``x1`` alone and the mask drops them."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & _M32
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def key(seed):
    """``jax.random.key(seed)`` for 32-bit seeds: the pair (0, seed mod
    2**32).  ``seed`` is an integer tensor (a negative int32 wraps, as
    jax's conversion to uint32 does)."""
    seed = torch.as_tensor(seed).long() & _M32
    return torch.zeros_like(seed), seed


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``: the key ``threefry2x32(k, (0,
    data mod 2**32))``."""
    k1, k2 = k
    data = torch.as_tensor(data, device=k1.device).long() & _M32
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def random_bits(k, n: int):
    """``jax.random.bits(k, (n,), uint32)`` for each key of a batch: the
    keys' shape ``[...]`` gives bits ``[..., n]``.  The partitionable
    counters of element i are (0, i); the bits are the XOR of the cipher's
    two outputs."""
    k1, k2 = (x[..., None] for x in k)
    count = torch.arange(n, dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(count), count)
    return y1 ^ y2


def uniform(k, n: int, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(k, (n,), float32, minval, maxval)``: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled, and no
    lower than ``minval``; float32 arithmetic throughout."""
    bits = (random_bits(k, n) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference as float32 values (exact in a
    # Python float), so the tensor arithmetic below is jax's float32 one
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return (floats * span + float(lo)).clamp_min(float(lo))


def gumbel(k, n: int):
    """``jax.random.gumbel(k, (n,), float32)`` in its default "low" mode:
    ``-log(-log(u))``, u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(k, n, _TINY, 1.0)))


def categorical(k, logits):
    """``jax.random.categorical(k, logits)`` row by row: logits ``[...,
    V]`` float32 with one key per row (the keys' shape ``[...]``); the
    argmax of Gumbel noise plus the logits (the first index on ties, as
    ``jnp.argmax``).  Returns int64 ``[...]``."""
    return (gumbel(k, logits.shape[-1]) + logits).argmax(dim=-1)
