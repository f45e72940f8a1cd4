"""The port's GPT and sampling filters against the JAX package's, on the
CPU.

Weights go from the JAX `gpt3_tiny` to the port through
`paddle_tpu_torch/models/convert.py`; the same prompt then runs a paged
prefill from empty and three decode steps through both models'
`forward_with_cache`.  Logits agree to atol 1e-4 (fp32, two frameworks'
matmul and softmax orders over two layers).  The row-wise top-k / top-p
filter agrees on which entries it removes exactly and on the rest to
atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)
    tm.load_state_dict(gpt_state_from_numpy(state))
    return jm, tm, state


def test_convert_transposes_linear_weights_only(models):
    _, tm, state = models
    sd = tm.state_dict()
    assert set(sd) == set(state)
    for name, arr in state.items():
        got = sd[name].numpy()
        if name.endswith(("qkv.weight", "proj.weight", "fc1.weight",
                          "fc2.weight")):
            np.testing.assert_array_equal(got, arr.T)
        else:
            np.testing.assert_array_equal(got, arr)


def test_paged_prefill_and_decode_logits_match_jax(models):
    jm, tm, _ = models
    B, S, bs, steps = 2, 13, 8, 3
    ids = np.random.RandomState(0).randint(1, 1024, (B, S)).astype(np.int32)
    jc = jm.init_caches(B, cache_impl="paged", max_context=S + steps,
                        block_size=bs)
    tc = tm.init_caches(B, S + steps, block_size=bs)
    jl, jc = jm.forward_with_cache(paddle.to_tensor(ids), jc, pos_offset=0)
    with torch.no_grad():
        tl, tc = tm.forward_with_cache(torch.from_numpy(ids).long(), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value), atol=1e-4,
                               rtol=0)
    nxt = np.asarray(jl._value)[:, -1].argmax(-1).astype(np.int32)
    for step in range(steps):
        jl, jc = jm.forward_with_cache(paddle.to_tensor(nxt[:, None]), jc,
                                       pos_offset=S + step)
        with torch.no_grad():
            tl, tc = tm.forward_with_cache(
                torch.from_numpy(nxt[:, None]).long(), tc, S + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value),
                                   atol=1e-4, rtol=0)
        nxt = np.asarray(jl._value)[:, -1].argmax(-1).astype(np.int32)
    assert tc[0].seq_lens.tolist() == [S + steps] * B


def test_moe_and_cacheless_attention_wait_for_later_slices(models):
    """Both have come: a GPT-MoE builds with MoE blocks at 1, 3, ... (its
    parity with the JAX model is in tests/test_torch_moe.py), and
    cache-less attention (the training path) matches the JAX model's
    (atol 1e-5)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    moe = GPTForCausalLM(gpt3_tiny(moe_num_experts=4, num_layers=4),
                         device="cpu")
    assert [i for i, b in enumerate(moe.gpt.blocks)
            if isinstance(b.mlp, MoELayer)] == [1, 3]
    assert moe.gpt.blocks[1].mlp.experts.w1.shape == (4, 128, 512)
    with pytest.raises(ValueError, match="moe_every_n_layers"):
        gpt3_tiny(moe_num_experts=4, moe_every_n_layers=0)
    jm, tm, _ = models
    x = np.random.RandomState(3).standard_normal((2, 11, 128)).astype(
        np.float32)
    want = jm.gpt.blocks[1].attn(paddle.to_tensor(x))
    with torch.no_grad():
        got = tm.gpt.blocks[1].attn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                               atol=1e-5, rtol=0)


def test_process_logits_rows_matches_jax():
    rng = np.random.RandomState(1)
    B, V = 6, 257
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    temp = np.asarray([1.0, 0.7, 1.3, 0.9, 1.0, 2.0], np.float32)
    top_k = np.asarray([0, 5, 40, 0, 1, 300], np.int32)
    top_p = np.asarray([1.0, 1.0, 0.95, 0.5, 0.9, 0.8], np.float32)
    want = np.asarray(jgen._process_logits_rows(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    got = tgen._process_logits_rows(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = ~np.isinf(want)
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-6, rtol=0)
    # the filters did bite: top-k 5 keeps 5, top-k 1 keeps 1
    assert keep[1].sum() == 5 and keep[4].sum() == 1


def test_sampler_draws_by_seed_and_position():
    from paddle_tpu_torch.core import threefry

    def keys(seeds, positions):
        return threefry.fold_in(threefry.key(seeds), positions)

    V = 64
    logits = torch.from_numpy(
        np.random.RandomState(2).standard_normal((3, V)).astype(np.float32))
    args = dict(do_sample=torch.tensor([True, True, False]),
                temperature=torch.ones(3), top_k=torch.zeros(3,
                                                            dtype=torch.long),
                top_p=torch.ones(3), any_sample=True)
    seeds = torch.tensor([7, 7, 7])
    a = tgen.sample_rows(logits, keys=keys(seeds, torch.tensor([0, 0, 0])),
                         **args)
    b = tgen.sample_rows(logits, keys=keys(seeds, torch.tensor([0, 0, 0])),
                         **args)
    assert torch.equal(a, b)
    assert a[2] == logits[2].argmax()           # the greedy row
    # rows with the same logits, seed and position draw the same token
    same = tgen.sample_rows(logits[[0, 0]],
                            keys=keys(seeds[:2], torch.tensor([5, 5])),
                            do_sample=torch.tensor([True, True]),
                            temperature=torch.ones(2),
                            top_k=torch.zeros(2, dtype=torch.long),
                            top_p=torch.ones(2), any_sample=True)
    assert same[0] == same[1]
    # the draws follow the distribution: token frequencies over many
    # positions against softmax(logits), within 4 standard errors
    n = 4000
    row = logits[:1].expand(n, V)
    draws = tgen.sample_rows(row, keys=keys(torch.full((n,), 11),
                                            torch.arange(n)),
                             do_sample=torch.ones(n, dtype=torch.bool),
                             temperature=torch.ones(n),
                             top_k=torch.zeros(n, dtype=torch.long),
                             top_p=torch.ones(n), any_sample=True)
    p = torch.softmax(logits[0], -1).numpy()
    freq = np.bincount(draws.numpy(), minlength=V) / n
    assert np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / n) + 1e-3)
