"""The port's seeded sampling against jax.random and the JAX engine's token
choice, on the CPU.

`paddle_tpu_torch/core/threefry.py` must give jax 0.9.0's bits exactly
(`jax_threefry_partitionable` on): keys, `fold_in`, `random_bits` and
float32 uniforms are compared for equality.  Gumbel noise goes through
`log` twice, whose last bit XLA and torch may round apart, so it is held
to 2 float32 ulps of its size; the token choice (`sample_rows` against the
JAX package's `_next_tokens`) must still be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import _next_tokens
from paddle_tpu_torch.core import threefry
from paddle_tpu_torch.models.generation import sample_rows

# int32 seeds (0, the largest, negatives that wrap to uint32) and token
# positions up to 2**16
SEEDS = [0, 1, 1234, 2 ** 31 - 1, -1, -7, -2 ** 31]
POSITIONS = [0, 1, 63, 255, 4097, 2 ** 16 - 1, 2 ** 16]


def _jax_key(seed, pos):
    return jax.random.fold_in(jax.random.key(seed), pos)


def _port_keys(seeds, positions):
    return threefry.fold_in(threefry.key(torch.tensor(seeds)),
                            torch.tensor(positions))


def test_key_matches_jax():
    k1, k2 = threefry.key(torch.tensor(SEEDS))
    for i, seed in enumerate(SEEDS):
        want = np.asarray(jax.random.key_data(jax.random.key(seed)))
        assert [int(k1[i]), int(k2[i])] == want.tolist()


@pytest.mark.parametrize("pos", POSITIONS)
def test_fold_in_matches_jax(pos):
    k1, k2 = _port_keys(SEEDS, [pos] * len(SEEDS))
    for i, seed in enumerate(SEEDS):
        want = np.asarray(jax.random.key_data(_jax_key(seed, pos)))
        assert [int(k1[i]), int(k2[i])] == want.tolist()


def test_threefry2x32_known_answer():
    """The Threefry-2x32 test vector of Salmon et al. (Random123) that
    jax's own tests use: key (0x13198a2e, 0x03707344), counters
    (0x243f6a88, 0x85a308d3)."""
    t = lambda x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    y1, y2 = threefry.threefry2x32(t(0x13198A2E), t(0x03707344),
                                   t(0x243F6A88), t(0x85A308D3))
    assert (int(y1), int(y2)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_match_jax(seed):
    n = 3001                                       # odd: no pairing quirk
    keys = _port_keys([seed] * len(POSITIONS), POSITIONS)
    bits = threefry.random_bits(keys, n).numpy()
    tiny = float(jnp.finfo(jnp.float32).tiny)
    uni = threefry.uniform(keys, n, tiny, 1.0).numpy()
    uni01 = threefry.uniform(keys, n).numpy()
    for i, pos in enumerate(POSITIONS):
        k = _jax_key(seed, pos)
        want = np.asarray(jax.random.bits(k, (n,), jnp.uint32))
        np.testing.assert_array_equal(bits[i], want.astype(np.int64))
        want_u = np.asarray(jax.random.uniform(k, (n,), jnp.float32, tiny,
                                               1.0))
        np.testing.assert_array_equal(uni[i].view(np.int32),
                                      want_u.view(np.int32))
        want_u01 = np.asarray(jax.random.uniform(k, (n,), jnp.float32))
        np.testing.assert_array_equal(uni01[i].view(np.int32),
                                      want_u01.view(np.int32))


def test_gumbel_and_categorical_match_jax():
    keys = _port_keys(SEEDS, POSITIONS)
    n = 512
    g = threefry.gumbel(keys, n).numpy()
    logits = np.random.RandomState(0).randn(len(SEEDS), n).astype(
        np.float32)
    drawn = threefry.categorical(keys, torch.from_numpy(logits)).numpy()
    for i, (seed, pos) in enumerate(zip(SEEDS, POSITIONS)):
        k = _jax_key(seed, pos)
        want = np.asarray(jax.random.gumbel(k, (n,), jnp.float32))
        np.testing.assert_allclose(g[i], want, rtol=2 * 2.0 ** -23,
                                   atol=2 * 2.0 ** -23)
        assert drawn[i] == int(jax.random.categorical(k, logits[i]))


def _sampling_rows(B, V, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    do_sample = np.arange(B) % 4 != 0                  # some greedy rows
    temperature = rng.uniform(0.5, 1.5, B).astype(np.float32)
    top_k = np.array([0, 5, 40, 0, 1, 100, 0, 17][:B], np.int32)
    top_p = np.array([1.0, 0.9, 0.95, 0.5, 1.0, 0.8, 0.99, 1.0][:B],
                     np.float32)
    seeds = rng.randint(0, 2 ** 32, B).astype(np.uint32)
    tok_pos = rng.randint(0, 2 ** 16, B).astype(np.int32)
    return logits, do_sample, temperature, top_k, top_p, seeds, tok_pos


@pytest.mark.parametrize("j", [0, 3])
@pytest.mark.parametrize("V", [1024, 50304])
def test_sample_rows_matches_next_tokens(V, j):
    """The decode tick's token choice, row for row: greedy rows, filtered
    sampled rows, uint32 seeds past 2**31, positions tok_pos + j."""
    for draw in range(4):
        args = _sampling_rows(8, V, 10 * draw + j)
        want = np.asarray(_next_tokens(*(jnp.asarray(a) for a in args), j))
        logits, do_sample, temperature, top_k, top_p, seeds, tok_pos = (
            torch.from_numpy(np.asarray(a)) for a in args)
        keys = threefry.fold_in(threefry.key(seeds.long()),
                                tok_pos.long() + j)
        got = sample_rows(logits, do_sample, temperature, top_k, top_p,
                          keys, True)
        np.testing.assert_array_equal(got.numpy(), want)


def test_all_greedy_rows_skip_the_draw(monkeypatch):
    args = _sampling_rows(4, 64, 1)
    logits = torch.from_numpy(args[0])

    def no_draw(*a):
        raise AssertionError("drew for an all-greedy batch")
    monkeypatch.setattr(threefry, "categorical", no_draw)
    t = [torch.from_numpy(np.asarray(a)) for a in args[1:5]]
    t[0] = torch.zeros(4, dtype=torch.bool)
    got = sample_rows(logits, *t, None, False)
    np.testing.assert_array_equal(got.numpy(), args[0].argmax(-1))
