"""``GenerationMixin.generate`` and the KV caches of the port against the
JAX package's, on the CPU: the counterparts of ``tests/test_generation.py``.

The same weights (``models/convert.py``) and numpy prompts go through the
JAX ``generate`` and the port's, GPT (``gpt3_tiny``) and Llama with GQA
(``llama_tiny(num_kv_heads=2)``), with each ``cache_impl``: ``"dense"``,
``"static"`` and ``"paged"`` (the JAX whole-generation program; the
port's captured decode step, eager on the CPU) and ``"paged_eager"`` (the
host-allocated ``BlockKVCache``).  Tolerances: token streams EXACTLY
equal (greedy, and sampled with the same seed: ``core/random.py`` and
``core/threefry.py`` are jax's bits); logits atol 1e-4 (fp32, two
frameworks' matmul and softmax orders over two layers); the chunked
prefill's last logits against a full forward rtol 2e-4 / atol 2e-5 (the
JAX test's limits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_gpt_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

IMPLS = ["dense", "static", "paged", "paged_eager"]


def _pair(family):
    """A JAX model and the port's with its weights (eval mode)."""
    paddle.seed(0)
    if family == "gpt":
        jm, tm = JaxGPT(jax_gpt_tiny()), GPTForCausalLM(gpt3_tiny(),
                                                        device="cpu", seed=1)
    else:
        jm = JaxLlama(jax_llama_tiny(num_kv_heads=2))
        tm = LlamaForCausalLM(llama_tiny(num_kv_heads=2), device="cpu",
                              seed=1)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_from_numpy(state, tm))
    jm.eval()
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module", params=["gpt", "llama-gqa"])
def pair(request):
    return _pair(request.param)


def _ids(seed, B=2, S=7):
    return np.random.RandomState(seed).randint(0, 100, (B, S)).astype(
        np.int32)


def _jgen(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw)._value)


def _tgen(tm, ids, **kw):
    return tm.generate(torch.from_numpy(ids), **kw).numpy()


def _greedy_no_cache(tm, ids, n_new):
    """Reference decoding: a full forward each step, no cache."""
    cur = torch.from_numpy(ids).long()
    with torch.no_grad():
        for _ in range(n_new):
            nxt = tm(cur)[:, -1].argmax(-1)
            cur = torch.cat([cur, nxt[:, None]], dim=1)
    return cur.numpy()


@pytest.mark.parametrize("impl", IMPLS)
def test_cached_greedy_matches_full_forward(pair, impl):
    """Every cache implementation's greedy stream equals the no-cache
    decode's and the JAX ``generate``'s with the same cache_impl."""
    jm, tm = pair
    ids = _ids(0)
    want = _greedy_no_cache(tm, ids, 6)
    got = _tgen(tm, ids, max_new_tokens=6, cache_impl=impl)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _jgen(jm, ids, max_new_tokens=6, cache_impl=impl))


def test_static_cache_matches_dense(pair):
    """The static cache's stream equals the dense cache's, and its
    prefill and decode logits the JAX StaticKVCache's."""
    jm, tm = pair
    ids = _ids(3)
    dense = _tgen(tm, ids, max_new_tokens=6, cache_impl="dense")
    static = _tgen(tm, ids, max_new_tokens=6, cache_impl="static")
    np.testing.assert_array_equal(static, dense)
    jc = jm.init_caches(2, cache_impl="static")
    tc = tm.init_caches(2, cache_impl="static")
    assert isinstance(tc[0], tkv.StaticKVCache)
    assert tuple(tc[0].k.shape) == tuple(jc[0].k.shape)
    cur = ids
    for off in (0, 7, 8):
        jl, jc = jm.forward_with_cache(paddle.to_tensor(cur), jc,
                                       pos_offset=off)
        with torch.no_grad():
            tl, tc = tm.forward_with_cache(torch.from_numpy(cur).long(), tc,
                                           off)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value),
                                   atol=1e-4, rtol=0)
        cur = np.asarray(jl._value)[:, -1:].argmax(-1).astype(np.int32)
    assert tc[0].host_length == 9 and int(tc[0].length) == 9


def test_static_cache_overflow_raises():
    """Past the capacity raises, as the JAX cache does: a prefill longer
    than the cache, and an eager decode past it; ``generate`` checks
    prompt + new tokens against ``max_seq_len`` before its program."""
    for make, zeros in ((lambda: jkv.StaticKVCache(1, 4, 2, 8),
                         lambda *s: paddle.zeros(list(s))._value),
                        (lambda: tkv.StaticKVCache(1, 4, 2, 8),
                         torch.zeros)):
        with pytest.raises(ValueError, match="capacity"):
            make().update_and_attend(zeros(1, 5, 2, 8), zeros(1, 5, 2, 8),
                                     zeros(1, 5, 2, 8))
    cache = tkv.StaticKVCache(1, 4, 2, 8)
    cache.update_and_attend(*(torch.zeros(1, 3, 2, 8),) * 3)
    with pytest.raises(ValueError, match="capacity"):
        cache.update_and_attend(*(torch.zeros(1, 2, 2, 8),) * 3)
    tm = GPTForCausalLM(gpt3_tiny(max_seq_len=16), device="cpu")
    for impl in ("static", "paged"):
        with pytest.raises(ValueError, match="max_seq_len"):
            tm.generate(torch.ones((1, 10), dtype=torch.long),
                        max_new_tokens=7, cache_impl=impl)


def test_generate_sampling_and_eos():
    """Sampled streams (temperature, top-k, top-p) equal the JAX
    package's for the same seed on the host loop, which draws
    ``categorical(next_key(), ...)`` a token (the split chain); eos
    stops it early and pads finished rows with eos."""
    jm, tm = _pair("gpt")
    ids = np.ones((2, 4), np.int32)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.8, top_k=20,
              top_p=0.95)
    paddle.seed(1)
    trandom.seed(1)
    want = _jgen(jm, ids, **kw)
    got = _tgen(tm, ids, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == 12 and (got[:, :4] == 1).all()
    trandom.seed(2)
    assert not np.array_equal(_tgen(tm, ids, **kw), got)
    # eos: the first greedy token of row 0 ends row 0 at once
    first = int(_tgen(tm, ids, max_new_tokens=1)[0, -1])
    for impl in ("dense", "static"):
        gen = _tgen(tm, ids, max_new_tokens=6, eos_token_id=first,
                    cache_impl=impl)
        np.testing.assert_array_equal(
            gen, _jgen(jm, ids, max_new_tokens=6, eos_token_id=first,
                       cache_impl=impl))
        assert (gen[0, 4:] == first).all()
    assert tm.last_generate["steps"] == 6


@pytest.mark.parametrize("impl", ["static", "paged", "paged_eager"])
def test_sampled_streams_equal_jax_for_a_seed(pair, impl):
    """Sampling with a fixed seed: the compiled programs (static, paged)
    draw ``categorical(fold_in(key, step), ...)`` from ONE ``next_key()``
    draw, the host loop one key a token; each equals the JAX package's."""
    jm, tm = pair
    ids = _ids(5)
    kw = dict(max_new_tokens=8, do_sample=True, top_k=50, top_p=0.9,
              cache_impl=impl)
    paddle.seed(11)
    trandom.seed(11)
    np.testing.assert_array_equal(_tgen(tm, ids, **kw), _jgen(jm, ids, **kw))


def test_chunked_prefill_matches_full(pair):
    """The prompt in two chunks through dense caches (the second attends
    the first under flash's end-aligned causal mask) gives a full
    forward's last logits, and the JAX chunked run's."""
    jm, tm = pair
    ids = np.random.RandomState(3).randint(0, 100, (2, 8)).astype(np.int32)
    with torch.no_grad():
        full = tm(torch.from_numpy(ids).long())[:, -1].numpy()
        caches = tm.init_caches(2)
        _, caches = tm.forward_with_cache(torch.from_numpy(ids[:, :5]).long(),
                                          caches, 0)
        logits, caches = tm.forward_with_cache(
            torch.from_numpy(ids[:, 5:]).long(), caches, 5)
    chunked = logits[:, -1].numpy()
    np.testing.assert_allclose(chunked, full, rtol=2e-4, atol=2e-5)
    jc = jm.init_caches(2)
    _, jc = jm.forward_with_cache(paddle.to_tensor(ids[:, :5]), jc,
                                  pos_offset=0)
    jl, _ = jm.forward_with_cache(paddle.to_tensor(ids[:, 5:]), jc,
                                  pos_offset=5)
    np.testing.assert_allclose(chunked, np.asarray(jl._value)[:, -1],
                               atol=1e-4, rtol=0)
    # Llama's dense caches hold the kv heads, as the JAX model's
    kvh = getattr(tm.cfg, "num_kv_heads", tm.cfg.num_heads)
    assert caches[0][0].shape[2] == kvh == jc[0][0].shape[2]
    # a chunk against a non-empty block cache is the JAX models' refusal
    bc = tm.init_caches(2, cache_impl="paged")
    assert isinstance(bc[0], tkv.BlockKVCache)
    with torch.no_grad():
        _, bc = tm.forward_with_cache(torch.from_numpy(ids[:, :5]).long(),
                                      bc, 0)
        with pytest.raises(NotImplementedError, match="chunk"):
            tm.forward_with_cache(torch.from_numpy(ids[:, 5:]).long(), bc, 5)


def test_generate_restores_training_mode():
    for tm in (GPTForCausalLM(gpt3_tiny(), device="cpu"),
               LlamaForCausalLM(llama_tiny(), device="cpu")):
        tm.train()
        for impl in IMPLS:
            tm.generate(torch.ones((1, 3), dtype=torch.long),
                        max_new_tokens=2, cache_impl=impl)
            assert tm.training
        tm.eval()
        tm.generate(torch.ones((1, 3), dtype=torch.long), max_new_tokens=2)
        assert not tm.training


def test_full_forward_unchanged_by_cache_plumbing():
    """The cache-less training path of Llama (GQA) still matches the JAX
    model's loss, and its gradients reach the projections."""
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(num_kv_heads=2))
    tm = LlamaForCausalLM(llama_tiny(num_kv_heads=2), device="cpu")
    tm.load_state_dict(state_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, tm))
    ids = np.random.RandomState(1).randint(0, 100, (2, 8)).astype(np.int32)
    labels = np.random.RandomState(2).randint(0, 100, (2, 8)).astype(
        np.int32)
    jl = jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    tl = tm.compute_loss(torch.from_numpy(ids).long(),
                         torch.from_numpy(labels).long())
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl._value), atol=1e-5)
    assert tm.model.layers[0].self_attn.q_proj.weight.grad is not None
    assert tm.model.layers[0].self_attn.k_proj.weight.grad.abs().sum() > 0


def test_compiled_paged_cache_matches_dense(pair):
    """The paged program (a ``PagedKVCache`` sized by the context,
    ``paged_decode`` through the block table) and the host loop over a
    ``BlockKVCache`` pick the dense cache's tokens; the block cache's
    allocator hands out block 1 first and pads with block 0."""
    jm, tm = pair
    ids = _ids(5)
    dense = _tgen(tm, ids, max_new_tokens=6, cache_impl="dense")
    np.testing.assert_array_equal(
        _tgen(tm, ids, max_new_tokens=6, cache_impl="paged"), dense)
    np.testing.assert_array_equal(
        _tgen(tm, ids, max_new_tokens=6, cache_impl="paged_eager"), dense)
    caches = tm.init_caches(2, cache_impl="paged")
    with torch.no_grad():
        _, caches = tm.forward_with_cache(torch.from_numpy(ids).long(),
                                          caches, 0)
    c = caches[0]
    assert c._owned == [[1], [2]] and c._lens == [7, 7]
    assert c.tables[:, 0].tolist() == [1, 2] and c.tables[:, 1:].sum() == 0
    c.free(0)
    assert c._free[-1] == 1 and c._lens[0] == 0


def test_paged_pool_sized_by_context_not_max_seq_len():
    """A paged pool holds the generation's context, not ``max_seq_len``:
    ceil(24 / 64) = 1 block a sequence and the pad block."""
    tm = GPTForCausalLM(gpt3_tiny(max_seq_len=8192), device="cpu")
    caches = tm.init_caches(2, cache_impl="paged", max_context=24)
    assert isinstance(caches[0], tkv.PagedKVCache)
    assert caches[0].k.shape[1] <= 2 * 1 + 1
    jm = JaxGPT(jax_gpt_tiny(max_seq_len=8192))
    jc = jm.init_caches(2, cache_impl="paged", max_context=24)
    assert tuple(caches[0].k.shape) == tuple(jc[0].k.shape)
    out = tm.generate(torch.ones((2, 5), dtype=torch.long), max_new_tokens=4,
                      cache_impl="paged")
    assert tuple(out.shape) == (2, 9)


def test_block_kv_cache_allocator_matches_jax():
    """The host allocator against the JAX ``BlockKVCache`` on the same
    prefill and appends: the free list, the blocks each sequence owns,
    the host lengths, the tables, the lengths and the pools' written
    values; a freed sequence's blocks come back; out of blocks and past
    ``max_blocks_per_seq`` both raise ``RuntimeError``."""
    from paddle_tpu.ops.pallas_paged import BlockKVCache as JaxBlockKVCache
    rng = np.random.RandomState(6)
    nh, hd, bs, B = 2, 8, 4, 2
    caches = (JaxBlockKVCache(9, bs, nh, hd, B, 3),
              tkv.BlockKVCache(9, bs, nh, hd, B, 3))
    k, v = (rng.standard_normal((B, 6, nh, hd)).astype(np.float32)
            for _ in range(2))
    caches[0].append_prefill(paddle.to_tensor(k)._value,
                             paddle.to_tensor(v)._value)
    caches[1].append_prefill(torch.from_numpy(k), torch.from_numpy(v))
    for _ in range(3):
        ks, vs = (rng.standard_normal((B, nh, hd)).astype(np.float32)
                  for _ in range(2))
        caches[0].append(paddle.to_tensor(ks)._value,
                         paddle.to_tensor(vs)._value)
        caches[1].append(torch.from_numpy(ks), torch.from_numpy(vs))
    j, t = caches
    assert (t._free, t._owned, t._lens) == (j._free, j._owned, j._lens)
    np.testing.assert_array_equal(t.tables.numpy(), np.asarray(j.tables))
    np.testing.assert_array_equal(t.seq_lens.numpy(), np.asarray(j.seq_lens))
    np.testing.assert_array_equal(t.k.numpy(), np.asarray(j.k))
    np.testing.assert_array_equal(t.v.numpy(), np.asarray(j.v))
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    np.testing.assert_allclose(t.attend(torch.from_numpy(q)).numpy(),
                               np.asarray(j.attend(jnp.asarray(q),
                                                   interpret=True)),
                               atol=1e-5, rtol=0)
    j.free(0)
    t.free(0)
    assert (t._free, t._owned, t._lens) == (j._free, j._owned, j._lens)
    step = torch.zeros((B, nh, hd))
    for c in caches:               # sequence 1 holds 3 blocks: the table's
        with pytest.raises(RuntimeError, match="max_blocks_per_seq"):
            for _ in range(4):
                if c is t:
                    c.append(step, step)
                else:
                    c.append(paddle.zeros([B, nh, hd])._value,
                             paddle.zeros([B, nh, hd])._value)
    small = tkv.BlockKVCache(2, bs, nh, hd, B, 3)
    with pytest.raises(RuntimeError, match="out of physical blocks"):
        small.append_prefill(torch.zeros((B, 1, nh, hd)),
                             torch.zeros((B, 1, nh, hd)))
