"""The port's program grid and `warmup()` against the JAX engine's, on the
CPU.

The port's `ServingEngine` runs its device programs as functions of
static buffers (`paddle_tpu_torch/inference/graphs.py`; CUDA graphs on
the card, direct calls here).  On `gpt3_tiny`, whole-prompt, chunked with
an n-gram draft and with a model draft:

* `warmup()["grid"]` equals the JAX engine's grid without its
  host-sampling `decode` entry (the `cow` block copy included);
* streams after `warmup()` equal streams without it, and the warmup
  leaves every pool block but the pad block 0 as it was;
* an engine that served traffic is freed when its last reference goes,
  without the cyclic garbage collector: its programs do not refer back to
  it, so its pools and graphs never wait for a collection (one that ran
  during another engine's capture would destroy graphs inside it).

The overlapped tick loop's streams and stats against the JAX engine's
are checked beside the loop off: the parity tests of
`test_torch_serving.py`, `test_torch_prefix_cache.py` and
`test_torch_spec.py` run with `overlap` off and on.  Each test here has a
time limit of its own (`_limit`): 1–9 s alone, up to 60 s beside five
other pytest workers on an 8-core host, so the limits are three to four
times that.
"""

import functools
import gc
import signal
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.flags import flag_guard
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny

ENGINE = dict(max_batch=3, max_context=64, block_size=16, steps_per_tick=4)
CASES = [dict(prefix_cache=False),
         dict(prefix_cache=True, prefill_chunk=16, spec_decode=True,
              spec_draft="ngram", spec_adaptive=True, spec_k_ladder="2,4"),
         dict(prefix_cache=True, spec_decode=True, spec_draft="model",
              spec_k=3)]
IDS = ["whole", "chunked-ngram", "model-draft"]


def _limit(seconds):
    """Fail the test if it runs longer than ``seconds``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expired(signum, frame):
                raise TimeoutError(f"the test ran past its limit of "
                                   f"{seconds} s")
            old = signal.signal(signal.SIGALRM, expired)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
        return run
    return deco


@pytest.fixture(scope="module")
def models():
    """The port's target and draft (random weights: nothing here compares
    them with the JAX models)."""
    return (GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1),
            GPTForCausalLM(gpt3_tiny(num_layers=1), device="cpu", seed=2))


def _engine(models, case):
    tm, td = models
    draft = td if case.get("spec_draft") == "model" else None
    return ServingEngine(tm, device="cpu", draft_model=draft, **ENGINE,
                         **case)


def _mix():
    """A repetitive prompt (n-gram hits), a random one sampled, and one
    whose budget is short of a tick; 51 tokens cross a block boundary."""
    rng = np.random.RandomState(1)
    pat = rng.randint(1, 1024, (6,)).tolist()
    return [dict(prompt_ids=(pat * 8)[:26], max_new_tokens=12),
            dict(prompt_ids=rng.randint(1, 1024, (40,)).tolist(),
                 max_new_tokens=11, do_sample=True, temperature=0.9,
                 top_k=40, top_p=0.95, seed=12),
            dict(prompt_ids=rng.randint(1, 1024, (17,)).tolist(),
                 max_new_tokens=3)]


def _run(eng):
    reqs = [eng.add_request(Request(**m)) for m in _mix()]
    eng.run()
    return [list(r.output_ids) for r in reqs]


@pytest.mark.parametrize("case", CASES, ids=IDS)
@_limit(240)
def test_warmup_grid_matches_the_jax_engine(models, case):
    paddle.seed(0)
    jdraft = JaxGPT(jax_tiny(num_layers=1)) \
        if case.get("spec_draft") == "model" else None
    with flag_guard(serving_pallas_prefill=False,
                    serving_pallas_verify=False):
        jeng = JaxEngine(JaxGPT(jax_tiny()), draft_model=jdraft, **ENGINE,
                         **case)
        want = [g for g in jeng.warmup(aot=False)["grid"]
                if g["program"] != "decode"]
    eng = _engine(models, case)
    info = eng.warmup()
    assert info["grid"] == want
    # greedy and sampled programs of every tick and spec tick, one prompt
    # program per grid entry
    ticks = sum(g["program"] in ("tick", "spec_tick") for g in want)
    assert info["programs"] == len(want) + ticks
    assert eng.warmup() is info and eng.stats()["warmup"] == info
    assert eng.stats()["graphs"] == {"enabled": False, "captured": 0,
                                     "replays": 0}


@pytest.mark.parametrize("case", CASES, ids=IDS)
@_limit(240)
def test_warmup_touches_only_the_pad_block(models, case):
    # an engine that served the mix cold, warmed afterwards: every block
    # but the pad block 0 keeps its keys and values
    eng = _engine(models, case)
    cold = _run(eng)
    pools = eng.pools + (eng.dpools or [])
    before = [(k.clone(), v.clone()) for k, v in pools]
    eng.warmup()
    for (k, v), (k0, v0) in zip(pools, before):
        assert torch.equal(k[:, 1:], k0[:, 1:])
        assert torch.equal(v[:, 1:], v0[:, 1:])
    # an engine warmed before its traffic serves the cold streams
    warm = _engine(models, case)
    warm.warmup()
    assert _run(warm) == cold


@pytest.mark.parametrize("case", CASES, ids=IDS)
@_limit(120)
def test_engine_is_freed_without_the_cyclic_collector(models, case):
    eng = _engine(models, case)
    eng.warmup()
    _run(eng)
    # chained ticks in flight held their programs (n-gram ticks never
    # chain: their proposals need the harvested tokens)
    assert (eng.stats()["overlapped_ticks"] > 0) == \
        (case.get("spec_draft") != "ngram")
    ref = weakref.ref(eng)
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
