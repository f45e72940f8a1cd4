"""Tensor-parallel serving (``inference/tp.py`` and the engine's
``tp_degree``) against the JAX package's, on the CPU.

The port's ``ServingEngine(model, tp_degree=N, device="cpu")`` starts
N - 1 worker ranks (fresh interpreters that import the port and torch,
never jax), joined over gloo; the JAX engine runs its ``shard_map``
programs on the 8-virtual-device CPU mesh (``tests/conftest.py``).  The
cases are ``tests/test_serving_tp.py``'s: a greedy and a seeded sampled
request at degree 2 and 4 give the JAX engine's streams at the same
degree and the port's degree-1 streams, token for token, with equal
``stats()``; every rank holds 1/tp of each sharded weight and pool; a
prefix hit (with chunked prefill) at degree 2 gives degree 1's miss; the
validation errors are the JAX ones.  Beyond them: each rank's shards equal
the JAX plan's slices (also quantized, with equal ``plan_stats``), a
quantized and two speculative degree-2 runs match degree 1 (and the JAX
engine's spec run), and a worker that raises or dies fails the engine
without a hang.  As in ``tests/test_torch_serving.py``, the JAX engine
runs with its Pallas prefill and verify off (the same math; its chunk
kernel's interpret mode needs ``pl.load``).
"""

import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.flags import flag_guard
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu_torch.distributed.collective import Group
from paddle_tpu_torch.inference import quant as tquant
from paddle_tpu_torch.inference import tp as ttp
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.models.kv_cache import PagedKVCache

JAX_FLAGS = dict(serving_pallas_prefill=False, serving_pallas_verify=False,
                 serving_overlap=False)
JAX_ENGINE = dict(max_batch=3, max_context=128, block_size=16,
                  steps_per_tick=2)
ENGINE = dict(JAX_ENGINE, overlap=False)


def _pair(seed, **kw):
    paddle.seed(seed)
    jm = JaxGPT(jax_tiny(**kw))
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(**kw), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(0)


def _prompts():
    rng = np.random.RandomState(0)
    return rng.randint(1, 1000, (12,)), rng.randint(1, 1000, (30,))


def _mix(req_cls):
    p1, p2 = _prompts()
    return [req_cls(p1, max_new_tokens=8),
            req_cls(p2, max_new_tokens=6, do_sample=True, temperature=0.9,
                    top_k=40, seed=77)]


def _serve_jax(jm, tp, **kw):
    with flag_guard(**JAX_FLAGS):
        eng = JaxEngine(jm, tp_degree=tp, **{**JAX_ENGINE, **kw})
        reqs = [eng.add_request(r) for r in _mix(JaxRequest)]
        eng.run()
    return [list(r.output_ids) for r in reqs], eng.stats()


def _serve(tm, tp, reqs=None, report=False, **kw):
    eng = ServingEngine(tm, tp_degree=tp, device="cpu", **{**ENGINE, **kw})
    try:
        reqs = [eng.add_request(r) for r in (reqs or _mix(Request))]
        eng.run()
        st = eng.stats()
        rep = eng.tp_report() if report else None
    finally:
        eng.shutdown()
    assert st["free_blocks"] == eng.num_blocks and st["reserved"] == 0
    return [list(r.output_ids) for r in reqs], st, rep


@pytest.fixture(scope="module")
def degree1(models):
    return _serve(models[1], 1, report=True)


def _sharded_bytes(plan):
    """(bytes of the sharded leaves, bytes of the replicated ones)."""
    flat_p = ttp.flat_shards(plan.params)
    flat_s = ttp.flat_shards(plan.specs)
    sh = sum(t.numel() * t.element_size() for k, t in flat_p.items()
             if flat_s[k] is not None)
    rep = sum(t.numel() * t.element_size() for k, t in flat_p.items()
              if flat_s[k] is None)
    return sh, rep


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_degrees_match_the_jax_engine_and_degree_1(models, degree1, tp):
    """The acceptance test: the greedy + sampled mix at degree 2 and 4
    gives the JAX engine's streams at the same degree and the port's
    degree-1 streams, token for token, with equal stats; each rank holds
    1/tp of every sharded weight and pool."""
    jm, tm = models
    s1, st1, rep1 = degree1
    got, st, rep = _serve(tm, tp, report=True)
    want, jst = _serve_jax(jm, tp)
    assert got == want == s1
    assert st["tp_degree"] == jst["tp_degree"] == tp
    drop = ("latency", "tp_degree")
    assert {k: v for k, v in st.items() if k not in drop} == \
        {k: v for k, v in st1.items() if k not in drop}
    assert {k: st[k] for k in ("steps", "ticks", "free_blocks", "reserved",
                               "prefix_cache")} == \
        {k: jst[k] for k in ("steps", "ticks", "free_blocks", "reserved",
                             "prefix_cache")}
    sharded, replicated = _sharded_bytes(ttp.build_plan(tm, tp))
    assert len(rep) == tp
    for r, rr in enumerate(rep):
        assert rr["weight_bytes"] == sharded // tp + replicated
        assert rr["pool_bytes"] * tp == rep1[0]["pool_bytes"]
        assert rr["comm_calls"] > 0
        if r:
            assert rr["modules"] == []      # no jax, no paddle_tpu
            assert rr["comm_calls"] == rep[0]["comm_calls"]


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_shards_equal_the_jax_plan(models, mode):
    """Rank by rank, the port's shards (in the plan's JAX layout) equal
    the JAX plan's shards as arrays, quantized or not, and so does
    ``plan_stats``."""
    import jax
    from jax.sharding import Mesh
    from paddle_tpu.inference import quant as jquant
    from paddle_tpu.inference import tp as jtp
    jm, tm = models
    tp = 2
    jplan, plan = jtp.build_plan(jm, tp), ttp.build_plan(tm, tp)
    if mode:
        jquant.quantize_plan(jplan, mode)
        tquant.quantize_plan(plan, mode)
        assert tquant.plan_stats(plan) == jquant.plan_stats(jplan)
    mesh = Mesh(np.array(jax.devices()[:tp]), (jtp.AXIS,))
    placed = jtp.shard_plan(jplan, mesh)
    jflat = ttp.flat_shards(placed)
    for r in range(tp):
        mine = ttp.flat_shards(ttp.shard_plan(plan, r))
        assert set(mine) == set(jflat)
        for k, arr in jflat.items():
            want = next(s.data for s in arr.addressable_shards
                        if s.device == mesh.devices[r])
            got = mine[k]
            if got.dtype == torch.bfloat16 or "float8" in str(got.dtype):
                got = got.float()
                want = np.asarray(want).astype(np.float32)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{k} rank {r}")


def test_forward_tp_at_degree_1_is_the_model(models):
    """``forward_tp`` over a one-rank plan gives the model's own logits
    and cache writes, bit for bit (the collectives are the identity)."""
    _, tm = models
    plan = ttp.build_plan(tm, 1)
    shard = ttp.TPShardModel(plan.meta, ttp.shard_plan(plan, 0),
                             Group(None, [0], rank=0), 0, "cpu")
    ids = torch.from_numpy(_prompts()[1][None, :16].astype(np.int64))
    caches = tm.init_caches(1, cache_impl="paged", block_size=16,
                            max_context=64)
    want, _ = tm.forward_with_cache(ids, caches)
    pools = [(torch.zeros_like(c.k), torch.zeros_like(c.v)) for c in caches]
    got, _ = ttp.forward_tp(shard, ids, pools, caches[0].tables,
                            caches[0].seq_lens, 0, 16, PagedKVCache)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for (k, v), c in zip(pools, caches):
        torch.testing.assert_close(k, c.k, rtol=0, atol=0)


def test_prefix_hit_with_chunks_matches_degree_1_miss(models):
    """A degree-2 engine with the prefix cache and 16-token chunks serves
    the degree-1 miss's tokens; its warmed grid is degree 1's and its
    programs run eagerly."""
    _, tm = models
    rng = np.random.RandomState(9)
    sysp = list(rng.randint(1, 1000, (32,)))
    prompt = sysp + [3, 1, 4]
    (miss,), _, _ = _serve(tm, 1, [Request(prompt, max_new_tokens=6)],
                           max_batch=2, prefix_cache=False)
    eng = ServingEngine(tm, max_batch=2, max_context=128, block_size=16,
                        tp_degree=2, prefill_chunk=16, device="cpu")
    grid1 = ServingEngine(tm, max_batch=2, max_context=128, block_size=16,
                          prefill_chunk=16, device="cpu").warmup()["grid"]
    try:
        assert eng.warmup()["grid"] == grid1
        w = eng.add_request(Request(sysp + [9, 9], max_new_tokens=3))
        eng.run()
        r = eng.add_request(Request(prompt, max_new_tokens=6))
        eng.run()
        st = eng.stats()
    finally:
        eng.shutdown()
    assert w.done and st["prefix_cache"]["hits"] >= 1
    assert r._prefix_blocks == 2 and st["prefill_chunks"] > 0
    assert st["graphs"]["enabled"] is False
    assert list(r.output_ids) == miss


def test_validation_errors_are_the_jax_ones(models):
    from paddle_tpu.inference import tp as jtp
    jm, tm = models
    for plan in (jtp.build_plan, ttp.build_plan):
        with pytest.raises(ValueError, match="divide"):
            plan(jm if plan is jtp.build_plan else tm, 3)

        class NotAGPT:
            cfg = tm.cfg
        with pytest.raises(ValueError, match="GPT-family"):
            plan(NotAGPT(), 2)

        class MoE:
            gpt = tm.gpt
            cfg = gpt3_tiny(moe_num_experts=4)
        with pytest.raises(ValueError, match="MoE"):
            plan(MoE(), 2)

        class TPModel:
            gpt = tm.gpt

            class cfg:
                moe_num_experts = 0
                tensor_parallel = True
        with pytest.raises(ValueError, match="tensor_parallel=True"):
            plan(TPModel(), 2)
    with pytest.raises(ValueError, match="divide"):
        ServingEngine(tm, tp_degree=3, device="cpu", **ENGINE)
    cuda = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="devices"):
        ttp.resolve_tp_devices(cuda, 2, None, n_cards=1)
    assert ttp.resolve_tp_devices(cuda, 2, ["cuda:0", "cuda:0"]) == \
        [cuda, cuda]
    assert ttp.resolve_tp_devices(cuda, 2, None, n_cards=2) == \
        [cuda, torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="devices"):
        ttp.resolve_tp_devices(torch.device("cpu"), 2, ["cpu"])
    with pytest.raises(ValueError, match="rank 0"):
        ttp.resolve_tp_devices(torch.device("cpu"), 2, ["cuda:0", "cpu"])


def test_quantized_host_sampling_degree_2_matches_degree_1(models):
    """int8 at degree 2: the plan quantized before sharding, each rank's
    products on the weight-only route over its column shard; with the
    host-sampling decode program (``device_sampling=False``: the
    replicated logits come to the host).  The streams, the steps and
    ``stats()["quant"]`` are degree 1's (and ``plan_stats`` the JAX
    numbers, ``test_shards_equal_the_jax_plan``)."""
    _, tm = models
    kw = dict(quant="int8", device_sampling=False)
    want, st1, _ = _serve(tm, 1, **kw)
    got, st, _ = _serve(tm, 2, **kw)
    assert got == want
    assert st["quant"] == st1["quant"]
    assert (st["steps"], st["ticks"]) == (st1["steps"], st1["ticks"])


def test_spec_at_degree_2_matches(models):
    """``build_tp_hostdraft_tick``: the n-gram verify forward over the
    ranks' shards gives the JAX engine's degree-2 streams and accept
    counts; ``build_tp_spec_tick``: a model draft, replicated on every
    rank, with the overlapped loop (chained spec ticks) gives degree 1's
    streams and counts."""
    jm, tm = models
    kw = dict(spec_decode=True, spec_k=3, prefix_cache=False)
    with flag_guard(**JAX_FLAGS):
        jeng = JaxEngine(jm, tp_degree=2, spec_draft="ngram", **JAX_ENGINE,
                         **kw)
        jreqs = [jeng.add_request(r) for r in _mix(JaxRequest)]
        jeng.run()
    got, st, _ = _serve(tm, 2, spec_draft="ngram", **kw)
    assert got == [list(r.output_ids) for r in jreqs]
    keys = ("proposed_tokens", "accepted_tokens", "ticks")
    sp, jsp = st["speculative"], jeng.stats()["speculative"]
    assert [sp[k] for k in keys] == [jsp[k] for k in keys]
    assert sp["ticks"] > 0
    _, td = _pair(5, num_layers=1)
    kw.update(spec_draft="model", draft_model=td, overlap=True)
    want, st1, _ = _serve(tm, 1, **kw)
    got, st, _ = _serve(tm, 2, **kw)
    assert got == want
    assert [st["speculative"][k] for k in keys] == \
        [st1["speculative"][k] for k in keys]
    assert st["overlapped_ticks"] == st1["overlapped_ticks"] > 0


@pytest.mark.parametrize("how", ["raises", "dies"])
def test_a_failing_worker_fails_the_engine_without_a_hang(models,
                                                          monkeypatch, how):
    _, tm = models
    if how == "raises":
        # the worker's third program run raises (chaos site tp.worker.run)
        monkeypatch.setenv("PTT_CHAOS_TP_WORKER", "3")
    eng = ServingEngine(tm, tp_degree=2, device="cpu", tick_timeout_s=20,
                        **ENGINE)
    try:
        if how == "dies":
            eng._tp_world.procs[0].kill()
            eng._tp_world.procs[0].wait()
        for r in _mix(Request):
            eng.add_request(r)
        t0 = time.monotonic()
        with pytest.raises(ttp.TPWorkerError, match="rank 1 exited"):
            eng.run()
        assert time.monotonic() - t0 < 20
    finally:
        eng.shutdown()
    assert all(p.poll() is not None for p in eng._tp_world.procs)
