"""The port's speculative decoding against the JAX package's, on the CPU.

* `accept_and_choose` and the accept tail with per-slot caps
  (`paddle_tpu_torch/inference/speculative.py`) against the JAX ones on
  the same seeded numpy inputs, greedy and sampled, with rows whose
  residual `max(p - q, 0)` is all zero (the guard that draws from `p`);
  exact equality of tokens and counts.
* The tagged draws, `fold_in(fold_in(key(seed), tag), position)`, their
  shape-`()` uniforms and the categorical over `log(residual)` with its
  `-inf` entries, bit for bit against `jax.random` (tokens for the
  categorical: Gumbel's `log` may round an ulp apart).
* `NGramDraft` proposals against the JAX drafter's.
* The engines on `gpt3_tiny` with the same weights: n-gram and model
  drafts, fixed and adaptive k, greedy and sampled requests, one budget
  short of k (its cap binds), whole-prompt and chunked prefill: equal
  streams and equal `stats()["speculative"]`; the greedy streams also
  equal the port's plain decoding.  The JAX engine runs with its paged
  Pallas views off, as in `tests/test_torch_prefix_cache.py`, and both
  engines with the overlapped tick loop off and on, the same on both
  (`FLAGS_serving_overlap`, the port's `overlap`): `stats()["steps"]`
  and `["ticks"]` are equal too.  With overlap on, model-draft spec ticks
  must have been chained, n-gram ones never (their proposals need the
  harvested tokens).  One n-gram case runs the Llama family
  (`llama_tiny(num_kv_heads=2)`) through the same `models` fixture.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.flags import flag_guard
from paddle_tpu.inference import drafting as jdraft
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.core import threefry
from paddle_tpu_torch.inference import drafting as tdraft
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

JAX_FLAGS = dict(serving_pallas_prefill=False, serving_pallas_verify=False)
SEEDS = np.array([7, 2 ** 31 + 5, 123456, 0xFFFFFFFF], np.uint32)


# ----------------------------------------------------------------- draws

@pytest.mark.parametrize("tag", [tspec.DRAFT_FOLD, tspec.ACCEPT_FOLD,
                                 tspec.RESID_FOLD])
def test_tagged_keys_and_uniforms_are_jax_bit_for_bit(tag):
    pos = np.array([[0, 1, 2], [17, 18, 19], [1023, 1024, 1025],
                    [5, 6, 7]], np.int32)
    want = jspec._keys_at(jnp.asarray(SEEDS), jnp.asarray(pos), tag)
    got = tspec.keys_at(torch.from_numpy(SEEDS.astype(np.int64)),
                        torch.from_numpy(pos.astype(np.int64)), tag)
    data = np.asarray(jax.random.key_data(want))
    np.testing.assert_array_equal(torch.stack(got, -1).numpy(), data)
    # one position per seed: the draft's keys
    w1 = jspec._keys_at(jnp.asarray(SEEDS), jnp.asarray(pos[:, 1]), tag)
    g1 = tspec.keys_at(torch.from_numpy(SEEDS.astype(np.int64)),
                       torch.from_numpy(pos[:, 1].astype(np.int64)), tag)
    np.testing.assert_array_equal(torch.stack(g1, -1).numpy(),
                                  np.asarray(jax.random.key_data(w1)))
    # jax's uniform of shape (): the port's n=None draw, bit for bit
    u = jax.vmap(jax.vmap(jax.random.uniform))(want)
    np.testing.assert_array_equal(threefry.uniform(got).numpy(),
                                  np.asarray(u))


def test_categorical_over_a_log_residual_with_zeros():
    """The residual draw: log(0) = -inf entries are never drawn, and the
    tokens are jax's."""
    rng = np.random.RandomState(4)
    resid = rng.rand(4, 3, 64).astype(np.float32)
    resid[resid < 0.6] = 0.0
    resid[1, 2] = 0.0
    resid[1, 2, 9] = 0.5          # one live entry
    pos = np.arange(12, dtype=np.int32).reshape(4, 3) + 40
    keys = jspec._keys_at(jnp.asarray(SEEDS), jnp.asarray(pos),
                          tspec.RESID_FOLD)
    want = jax.vmap(jax.vmap(jax.random.categorical))(
        keys, jnp.log(jnp.asarray(resid)))
    tk = tspec.keys_at(torch.from_numpy(SEEDS.astype(np.int64)),
                       torch.from_numpy(pos.astype(np.int64)),
                       tspec.RESID_FOLD)
    got = threefry.categorical(tk, torch.log(torch.from_numpy(resid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1, 2] == 9
    assert (np.take_along_axis(resid, got.numpy()[..., None], -1) > 0).all()


# ------------------------------------------------------- accept and choose

def _accept_case(sampled):
    """B 5 slots, k 3, V 64.  Filters per row; row 2 takes top-k 1, so its
    p is a one-hot, and its q is that one-hot plus the draft token's: the
    draft is rejected with an all-zero residual.  Row 4 is a free slot
    (length 0) with a cap of 0."""
    rng = np.random.RandomState(9)
    B, k, V = 5, 3, 64
    tl = (rng.standard_normal((B, k, V)) * 2).astype(np.float32)
    greedy = tl.argmax(-1)
    dtoks = rng.randint(0, V, (B, k)).astype(np.int32)
    dtoks[0, :2] = greedy[0, :2]            # a greedy run of 2 accepts
    dtoks[3] = greedy[3]
    q = rng.rand(B, k, V).astype(np.float32)
    q /= q.sum(-1, keepdims=True)
    q[1] = np.eye(V, dtype=np.float32)[dtoks[1]]      # a host draft
    dtoks[2, 0] = (greedy[2, 0] + 1) % V
    q[2] = np.eye(V, dtype=np.float32)[greedy[2]] \
        + np.eye(V, dtype=np.float32)[dtoks[2]]
    args = dict(
        do_sample=np.array([True, True, True, False, False]) & sampled,
        temperature=np.array([1.0, 0.7, 1.0, 1.0, 1.0], np.float32),
        top_k=np.array([0, 8, 1, 0, 0], np.int32),
        top_p=np.array([1.0, 0.9, 1.0, 1.0, 1.0], np.float32))
    seeds = np.append(SEEDS, np.uint32(3))
    lens = np.array([30, 7, 1000, 64, 0], np.int32)
    kcap = np.array([3, 2, 3, 1, 0], np.int32)
    return tl, dtoks, q, args, seeds, lens, kcap


@pytest.mark.parametrize("sampled", [False, True])
def test_accept_and_choose_matches_jax(sampled):
    tl, dtoks, q, args, seeds, lens, kcap = _accept_case(sampled)
    j = jspec.accept_and_choose(
        jnp.asarray(tl), jnp.asarray(dtoks), jnp.asarray(q),
        *(jnp.asarray(a) for a in args.values()), jnp.asarray(seeds),
        jnp.asarray(lens))
    jf = jspec._finish(None, jnp.asarray(tl), jnp.asarray(dtoks),
                       jnp.asarray(q),
                       *(jnp.asarray(a) for a in args.values()),
                       jnp.asarray(seeds), jnp.asarray(lens),
                       jnp.asarray(kcap))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in args.items()}
    u, rkeys = tspec.host_draws(torch.from_numpy(seeds.astype(np.int64)),
                            torch.from_numpy(lens.astype(np.int64)), 3)
    any_s = bool(args["do_sample"].any())
    dt = torch.from_numpy(dtoks.astype(np.int64))
    dq = torch.from_numpy(q) if any_s else None
    samp = (t["do_sample"], t["temperature"], t["top_k"].long(), t["top_p"])
    got = tspec.accept_and_choose(torch.from_numpy(tl), dt, dq, *samp, u,
                                  rkeys, any_s)
    for a, b in zip(got, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    chosen, counts, accepts = tspec.finish(
        torch.from_numpy(tl), dt, dq, samp,
        torch.from_numpy(lens), torch.from_numpy(kcap.astype(np.int64)), u,
        rkeys, any_s)
    for a, b in zip((chosen, counts, accepts), jf[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert counts[4] == 0 and counts[3] == 1       # free slot; cap 1
    if sampled:
        # row 2: rejected, its residual all zero, redrawn from p = the
        # target's one-hot
        assert got[0][2, 0] == tl[2, 0].argmax() and got[2][2] == 0


# ---------------------------------------------------------------- drafter

def test_ngram_proposals_match_the_jax_drafter():
    rng = np.random.RandomState(2)
    for trial in range(6):
        pat = rng.randint(0, 9, (rng.randint(2, 7),)).tolist()
        prompt = (pat * 6)[:rng.randint(1, 30)]
        out = []
        j, t = jdraft.NGramDraft(), tdraft.NGramDraft()
        for step in range(25):
            k = 1 + (step + trial) % 5
            assert t.propose_stream(prompt, out, k) == \
                j.propose_stream(prompt, out, k)
            out = out + rng.choice(pat + [50], (rng.randint(1, 3),)).tolist()
        assert (t.matched, t.fallbacks) == (j.matched, j.fallbacks)
        assert t.propose(prompt[:3], 4) == j.propose(prompt[:3], 4)
    with pytest.raises(ValueError):
        tdraft.NGramDraft(max_n=1, min_n=2)


# ---------------------------------------------------------------- engines

def _jax_llama_tiny(**kw):
    """The JAX preset with overrides (its own takes none of its fields)."""
    return JaxLlamaConfig(**{**vars(jax_llama_tiny()), **kw})


# GPT, and Llama with GQA (2 kv heads for 4 query heads)
FAMILIES = {"gpt": (JaxGPT, jax_tiny, GPTForCausalLM, gpt3_tiny, {}),
            "llama": (JaxLlama, _jax_llama_tiny, LlamaForCausalLM, llama_tiny,
                      dict(num_kv_heads=2))}


@pytest.fixture(scope="module")
def models(request):
    """The target and a one-layer draft of a family (GPT unless a test
    asks for another), each as the JAX model and the port's with the same
    weights."""
    jax_cls, jax_cfg, cls, cfg, fkw = FAMILIES[getattr(request, "param",
                                                       "gpt")]

    def pair(seed, **kw):
        paddle.seed(seed)
        jm = jax_cls(jax_cfg(**fkw, **kw))
        jm.eval()
        state = {k: np.asarray(v._value)
                 for k, v in jm.state_dict().items()}
        tm = cls(cfg(**fkw, **kw), device="cpu", seed=1)
        tm.load_state_dict(state_from_numpy(state, tm))
        return jm, tm
    return pair(0), pair(5, num_layers=1)


def _mix():
    """Two repetitive prompts (the n-gram drafter's hits) and two random
    ones; requests 1 and 2 sampled (one unfiltered, so a model draft is
    sometimes accepted); request 2's budget of 3 is short of k."""
    rng = np.random.RandomState(1)
    pat = rng.randint(1, 1024, (6,)).tolist()
    out = []
    for i in range(4):
        p = (pat * 8)[:20 + 3 * i] if i % 2 == 0 else \
            rng.randint(1, 1024, (15 + i,)).tolist()
        filt = dict(temperature=1.3, top_k=0, top_p=1.0) if i == 1 else \
            dict(temperature=0.9, top_k=40, top_p=0.95)
        out.append(dict(prompt_ids=p, max_new_tokens=(12, 9, 3, 14)[i],
                        do_sample=i in (1, 2), seed=11 + i, **filt))
    return out


ENGINE = dict(max_batch=3, max_context=64, block_size=16, steps_per_tick=4)
SPEC_CASES = [dict(spec_draft="ngram", spec_k=4),
              dict(spec_draft="ngram", spec_adaptive=True,
                   prefill_chunk=16),
              dict(spec_draft="model", spec_k=3),
              dict(spec_draft="model", spec_adaptive=True,
                   spec_k_ladder=[2, 4], prefill_chunk=16)]


def _serve(engine_cls, req_cls, model, mix=_mix, overlap=False, **kw):
    if engine_cls is ServingEngine:
        kw["overlap"] = overlap
    eng = engine_cls(model, **{**ENGINE, **kw})
    reqs = [eng.add_request(req_cls(**m)) for m in mix()]
    eng.run()
    st = eng.stats()
    assert st["free_blocks"] == eng.num_blocks and st["reserved"] == 0
    assert [len(r.output_ids) for r in reqs] == [m["max_new_tokens"]
                                                 for m in mix()]
    return [list(r.output_ids) for r in reqs], st


SPEC_IDS = ["ngram-k4", "ngram-adaptive-chunked", "model-k3",
            "model-adaptive-chunked"]


@pytest.fixture(scope="module")
def plain_streams():
    """Plain decoding's streams by family and chunk, served once:
    streams depend on neither the overlap nor the tick size (only the
    stats do)."""
    return {}


@pytest.mark.parametrize(
    "models,case,overlap",
    [pytest.param("gpt", c, o, id=f"{i}-{o}")
     for c, i in zip(SPEC_CASES, SPEC_IDS) for o in (False, True)]
    # one n-gram case of the Llama family, overlap on (n-gram ticks never
    # chain)
    + [pytest.param("llama", SPEC_CASES[0], True, id="llama-ngram-k4-True")],
    indirect=["models"])
def test_engine_matches_the_jax_engine(models, plain_streams, case,
                                       overlap):
    (jm, tm), (jd, td) = models
    kw = dict(spec_decode=True, overlap=overlap, **case)
    model_draft = case["spec_draft"] == "model"
    with flag_guard(serving_overlap=overlap, **JAX_FLAGS):
        want, jst = _serve(JaxEngine, JaxRequest, jm, prefix_cache=True,
                           draft_model=jd if model_draft else None, **kw)
    got, st = _serve(ServingEngine, Request, tm, device="cpu",
                     draft_model=td if model_draft else None, **kw)
    assert got == want
    assert st["speculative"] == jst["speculative"]
    assert (st["steps"], st["ticks"], st["prefill_chunks"]) == \
        (jst["steps"], jst["ticks"], jst["prefill_chunks"])
    assert (st["overlapped_ticks"] > 0) == (overlap and model_draft)
    sp = st["speculative"]
    assert sp["ticks"] > 0 and sp["ineligible_slots"] > 0
    if model_draft or case["spec_draft"] == "ngram":
        assert sp["accepted_tokens"] > 0
    if case.get("spec_adaptive") and not model_draft:
        assert sp["k_switches"] > 0
    # greedy speculation is lossless: plain decoding's streams
    key = (type(tm).__name__, case.get("prefill_chunk", 0))
    if key not in plain_streams:
        plain_streams[key] = _serve(ServingEngine, Request, tm, device="cpu",
                                    overlap=overlap,
                                    prefill_chunk=key[1])[0]
    plain = plain_streams[key]
    assert [got[i] for i in (0, 3)] == [plain[i] for i in (0, 3)]


def _full_context_mix():
    """Requests whose prompt and budget fill the context exactly: the
    draft's last steps of a tick run past the slot's table."""
    rng = np.random.RandomState(2)
    out = []
    for i, L in enumerate((50, 61, 47)):
        out.append(dict(prompt_ids=rng.randint(1, 1024, (L,)).tolist(),
                        max_new_tokens=ENGINE["max_context"] - L,
                        do_sample=i == 1, seed=21 + i, temperature=1.3,
                        top_k=0, top_p=1.0))
    return out


@pytest.mark.parametrize("overlap", [False, True])
def test_model_draft_serves_requests_that_fill_the_context(models, overlap):
    (jm, tm), (jd, td) = models
    kw = dict(spec_decode=True, spec_draft="model", spec_k=4,
              mix=_full_context_mix, overlap=overlap)
    with flag_guard(serving_overlap=overlap, **JAX_FLAGS):
        want, jst = _serve(JaxEngine, JaxRequest, jm, prefix_cache=True,
                           draft_model=jd, **kw)
    got, st = _serve(ServingEngine, Request, tm, device="cpu",
                     draft_model=td, **kw)
    assert got == want
    assert st["speculative"] == jst["speculative"]
    assert (st["steps"], st["ticks"]) == (jst["steps"], jst["ticks"])


def test_spec_settings_are_checked(models):
    (_, tm), (_, td) = models
    base = dict(device="cpu", spec_decode=True)
    with pytest.raises(ValueError, match="model-free"):
        ServingEngine(tm, spec_draft="ngram", draft_model=td, **base)
    with pytest.raises(ValueError, match="needs a draft model"):
        ServingEngine(tm, **base)
    with pytest.raises(ValueError, match="spec_draft"):
        ServingEngine(tm, spec_draft="oracle", **base)
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(tm, spec_draft="ngram", spec_k=0, **base)
    with pytest.raises(ValueError, match="ladder"):
        ServingEngine(tm, spec_draft="ngram", spec_adaptive=True,
                      spec_k_ladder="1,4", **base)
    wide = GPTForCausalLM(gpt3_tiny(num_layers=1, vocab_size=512),
                          device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        ServingEngine(tm, draft_model=wide, **base)
    short = GPTForCausalLM(gpt3_tiny(num_layers=1, max_seq_len=32),
                           device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        ServingEngine(tm, draft_model=short, max_context=64, **base)
    eng = ServingEngine(tm, spec_draft="ngram", spec_adaptive=True,
                        spec_k_ladder=[8, 2, 4, 4], **base)
    assert eng.spec_ladder == (2, 4, 8) and eng.spec_k_now == 2
    assert "speculative" not in ServingEngine(tm, device="cpu").stats()
