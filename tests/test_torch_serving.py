"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve the same three greedy requests on `gpt3_tiny` with the
same weights (carried by `paddle_tpu_torch/models/convert.py`), with
whole-prompt prefill and with 16-token chunks; the token streams must be
identical.  So must the streams of sampled requests (temperature, top-k,
top-p) with the same seeds: both engines draw the first token from
`numpy.random.RandomState(seed)` on the host and every later token from
`fold_in(key(seed), position)`, the port through its own threefry
(`paddle_tpu_torch/core/threefry.py`).  The JAX engine runs with its
prefix cache off (not ported yet) and with `FLAGS_serving_pallas_prefill`
off: its chunk kernel's default interpret strategy calls `pl.load`, which
this jax release does not have, and the dense chunk view it falls back
to is the same math.

Within the port, a sampled stream is a function of the request's seed
alone, whatever the tick size or batch.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.flags import flag_guard
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny

PROMPT_LENS = (29, 11, 40)
BUDGETS = (8, 6, 5)
ENGINE = dict(max_batch=2, max_context=64, block_size=16, steps_per_tick=4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)
    tm.load_state_dict(gpt_state_from_numpy(state))
    return jm, tm


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 1024, (n,)).tolist() for n in PROMPT_LENS]


def _serve_port(model, reqs, **kw):
    eng = ServingEngine(model, device="cpu", **{**ENGINE, **kw})
    for r in reqs:
        eng.add_request(r)
    eng.run()
    st = eng.stats()
    assert st["free_blocks"] == eng.num_blocks and st["reserved"] == 0
    assert all(r.done for r in reqs)
    return eng, [list(r.output_ids) for r in reqs]


@pytest.mark.parametrize("chunk", [0, 16])
def test_greedy_streams_match_the_jax_engine(models, chunk):
    jm, tm = models
    prompts = _prompts()
    with flag_guard(serving_pallas_prefill=False):
        jeng = JaxEngine(jm, prefill_chunk=chunk, prefix_cache=False,
                         **ENGINE)
        jreqs = [jeng.add_request(JaxRequest(p, max_new_tokens=b))
                 for p, b in zip(prompts, BUDGETS)]
        jeng.run()
    want = [list(r.output_ids) for r in jreqs]
    eng, got = _serve_port(tm, [Request(p, max_new_tokens=b)
                                for p, b in zip(prompts, BUDGETS)],
                           prefill_chunk=chunk)
    assert got == want
    assert [len(s) for s in got] == list(BUDGETS)
    if chunk:
        # 29 -> 2 chunks, 11 -> 1, 40 -> 3
        assert eng.stats()["prefill_chunks"] == 6


def _sampled_mix(seed0):
    """The three prompts, all sampled with different filters and seeds
    (one seed past 2**31), beside one greedy request."""
    prompts = _prompts(4)
    kws = [dict(temperature=0.9, top_k=40, top_p=0.95),
           dict(temperature=1.3, top_k=0, top_p=0.8),
           dict(temperature=0.7, top_k=5, top_p=1.0)]
    reqs = [dict(prompt_ids=p, max_new_tokens=b, do_sample=True,
                 seed=seed0 + 2 ** 31 * (i == 1) + i, **kw)
            for i, (p, b, kw) in enumerate(zip(prompts, BUDGETS, kws))]
    reqs.append(dict(prompt_ids=_prompts(5)[1], max_new_tokens=7))
    return reqs


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("seed0", [11, 2024])
def test_sampled_streams_match_the_jax_engine(models, chunk, seed0):
    jm, tm = models
    mix = _sampled_mix(seed0)
    with flag_guard(serving_pallas_prefill=False):
        jeng = JaxEngine(jm, prefill_chunk=chunk, prefix_cache=False,
                         **ENGINE)
        jreqs = [jeng.add_request(JaxRequest(**kw)) for kw in mix]
        jeng.run()
    want = [list(r.output_ids) for r in jreqs]
    _, got = _serve_port(tm, [Request(**kw) for kw in mix],
                         prefill_chunk=chunk)
    assert got == want
    assert [len(s) for s in got] == [kw["max_new_tokens"] for kw in mix]


def _sampled(seed, **kw):
    return Request(_prompts(1)[0][:17], max_new_tokens=12, do_sample=True,
                   temperature=0.9, top_k=40, top_p=0.95, seed=seed, **kw)


def test_sampled_stream_depends_on_the_seed_only(models):
    _, tm = models
    streams = []
    for k in (1, 3, 8):
        _, out = _serve_port(tm, [_sampled(5)], steps_per_tick=k)
        streams.append(out[0])
    # the same seed beside other traffic, in another slot, chunked
    greedy = Request(_prompts(2)[1], max_new_tokens=9)
    _, out = _serve_port(tm, [greedy, _sampled(5)], steps_per_tick=4,
                         prefill_chunk=16)
    streams.append(out[1])
    assert all(s == streams[0] for s in streams)
    _, other = _serve_port(tm, [_sampled(6)])
    assert other[0] != streams[0]


def test_eos_and_budgets_release_every_block(models):
    _, tm = models
    prompts = _prompts(3)
    _, base = _serve_port(tm, [Request(p, max_new_tokens=6)
                               for p in prompts])
    eos = base[0][2]
    stop = base[0].index(eos) + 1
    reqs = [Request(p, max_new_tokens=6, eos_token_id=eos) for p in prompts]
    _, got = _serve_port(tm, reqs)
    assert got[0] == base[0][:stop]       # stops at the eos token
    assert reqs[0].done and stop < 6


def test_admission_limits(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="max_context"):
        eng.add_request(Request(list(range(1, 60)), max_new_tokens=8))
    small = ServingEngine(tm, device="cpu", num_blocks=2, **ENGINE)
    with pytest.raises(ValueError, match="blocks"):
        small.add_request(Request(list(range(1, 40)), max_new_tokens=8))
    assert eng.pad_ladder == (16, 32, 64)
    assert eng._pad_bucket(17) == 32 and eng._pad_bucket(64) == 64
    # an explicit ladder, clamped to the table; past its top rung the
    # power-of-two bucket, still clamped
    custom = ServingEngine(tm, device="cpu", pad_buckets=[48, 16, 100],
                           **ENGINE)
    assert custom.pad_ladder == (16, 48, 64)
    assert custom._pad_bucket(20) == 48 and custom._pad_bucket(49) == 64
    with pytest.raises(ValueError, match="positive"):
        ServingEngine(tm, device="cpu", pad_buckets=[0], **ENGINE)
