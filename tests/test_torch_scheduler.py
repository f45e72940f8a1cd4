"""The port's scheduler budget, SLO shedding, request tracing and SSE
frontend against the JAX engine's, on the CPU.

`gpt3_tiny` with the same weights (`models/convert.py`) on both engines.
The JAX engine takes its settings from flags
(`serving_prefill_chunks_per_tick`, `serving_chunks_per_tick_auto`,
`serving_ttft_slo_ms`, `serving_tpot_slo_ms`, `serving_slo_shed`,
`serving_shed_queue_depth`, `serving_overlap`), the port from
`ServingEngine` arguments of the same names; the overlapped loop is off
or on, the same on both.  Side by side at a chunk budget of 2, with the
budget's controller pushed down (an impossible TPOT target) and held up
(a generous one), and with SLO shedding forced by an impossible TTFT
target:

* token streams, `steps`, `ticks`, `prefill_chunks`, `overlap_chunks`
  and `slo_sheds` are equal, and so are the shed requests and every
  outcome;
* every request's trace record has the same keys, `outcome`,
  `tokens_out`, `ticks` and `prompt_len`, and its own `rid`;
* the outcome, rejection, admission and token counters of the two
  registries are equal;
* `POST /generate` on each package's HTTP endpoint gives the same token
  frames and the same terminal frame (`done`, or `error` with reason
  `slo_shed`).

Then the fault the port's readiness evidence had: `health()`'s
`tpot_p50_s` was the unweighted median of the last 64 tick gaps, the JAX
engine's is the median of a sketch over every harvest weighted by its
tokens.  A clock that moves only at harvests, by uneven steps, on both
engines, over more than 64 harvests of uneven sizes: the old answer
differs from the JAX engine's, the port's equals it.

Decisions that read live sketches are forced by targets no run can meet
or miss (1e-6 ms, 1e6 ms); nothing here sleeps to make a decision.  The
JAX engine runs with its paged Pallas views off (`pl.load` is gone from
this jax release; the dense views are the same math).
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.flags import flag_guard
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu.observability import export as jexport
from paddle_tpu.observability import http as jhttp
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.observability import export, metrics
from paddle_tpu_torch.observability import http as obs_http

JAX_FLAGS = dict(serving_pallas_prefill=False, serving_pallas_verify=False)
ENGINE = dict(max_batch=2, max_context=96, block_size=16)
OVERLAP = pytest.mark.parametrize("overlap", [False, True],
                                  ids=["sync", "overlap"])
COUNTERS = ("serving.request_outcomes", "serving.rejections",
            "serving.admissions", "serving.tokens_out",
            "serving.slo_sheds", "serving.prefill_chunks")
TRACE_FIELDS = ("outcome", "tokens_out", "ticks", "prompt_len")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these models are tiny, and beside other
    pytest workers more threads only contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    return jm, tm


@pytest.fixture(autouse=True)
def _clean():
    for mod in (metrics, jmetrics):
        mod.reset()
    export.clear_requests()
    jexport.clear_requests()
    yield
    metrics.set_enabled(True)
    paddle.set_flags({"enable_metrics": True})
    for mod in (metrics, jmetrics):
        mod.reset()
    export.clear_requests()
    jexport.clear_requests()
    obs_http.attach_engine(None)
    jhttp.attach_engine(None)


# the JAX flag of each port argument
FLAG_OF = {"prefill_chunks_per_tick": "serving_prefill_chunks_per_tick",
           "chunks_per_tick_auto": "serving_chunks_per_tick_auto",
           "ttft_slo_ms": "serving_ttft_slo_ms",
           "tpot_slo_ms": "serving_tpot_slo_ms",
           "slo_shed": "serving_slo_shed",
           "shed_queue_depth": "serving_shed_queue_depth",
           "overlap": "serving_overlap"}
ENGINE_ARGS = ("prefill_chunk", "steps_per_tick", "prefix_cache",
               "max_batch", "max_context", "block_size")


def _engines(models, **kw):
    """A JAX engine (flags held by the caller's ``flag_guard``) and a port
    engine with the same settings."""
    jm, tm = models
    eng_kw = {**ENGINE, **{k: v for k, v in kw.items() if k in ENGINE_ARGS}}
    sched = {k: v for k, v in kw.items() if k in FLAG_OF}
    flags = {FLAG_OF[k]: v for k, v in sched.items()}
    return (flags, lambda: JaxEngine(jm, **eng_kw),
            lambda: ServingEngine(tm, device="cpu", **eng_kw, **sched))


def _mix(n=4, seed=0, budgets=(9, 7, 12, 6), lens=(37, 50, 23, 61)):
    rng = np.random.RandomState(seed)
    return [dict(prompt_ids=rng.randint(1, 1000, (lens[i % len(lens)],))
                 .tolist(), max_new_tokens=budgets[i % len(budgets)],
                 do_sample=i == 1, temperature=0.9, top_k=40, top_p=0.95,
                 seed=11 + i) for i in range(n)]


def _counters(mod):
    out = {}
    for name in COUNTERS:
        m = mod.get(name)
        out[name] = {} if m is None else {
            k: v for k, v in m._series.items()}
    return out


def _record(eng, reqs, mod):
    st = eng.stats()
    keys = ("steps", "ticks", "tokens_out", "prefill_chunks", "slo_sheds",
            "free_blocks", "reserved", "waiting", "prefilling", "running",
            "queue_depth")
    out = {k: st[k] for k in keys}
    out["overlap_chunks"] = getattr(eng, "overlap_chunks_total",
                                    getattr(eng, "overlap_chunks", None))
    out["streams"] = [list(r.output_ids) for r in reqs]
    out["outcomes"] = [r.outcome for r in reqs]
    out["shed"] = [i for i, r in enumerate(reqs) if r.shed]
    out["finished"] = [reqs.index(r) for r in eng.finished if r in reqs]
    out["traces"] = [None if r.trace is None else
                     (sorted(r.trace), r.trace["rid"] == r.rid,
                      [r.trace.get(f) for f in TRACE_FIELDS])
                     for r in reqs]
    out["counters"] = _counters(mod)
    out["latency_keys"] = sorted(st.get("latency", {}))
    return out


def _serve(make, req_cls, mix, prime=None):
    """One engine: an optional priming request run alone (it loads the
    latency sketches), then the mix enqueued at once and run."""
    eng = make()
    if prime is not None:
        eng.add_request(req_cls(**prime))
        eng.run()
    reqs = [eng.add_request(req_cls(**m)) for m in mix]
    eng.run()
    return eng, reqs


def _both(models, mix, prime=None, **kw):
    flags, make_jax, make_port = _engines(models, **kw)
    with flag_guard(**flags, **JAX_FLAGS):
        jeng, jreqs = _serve(make_jax, JaxRequest, mix, prime)
    jrec = _record(jeng, jreqs, jmetrics)
    teng, treqs = _serve(make_port, Request, mix, prime)
    trec = _record(teng, treqs, metrics)
    return jrec, trec, teng


CASES = {
    # a chunk budget of 2: two 8-token chunks per boundary
    "budget2": dict(prefill_chunk=8, prefill_chunks_per_tick=2,
                    steps_per_tick=2),
    # the controller walks down to 1 under an impossible TPOT target
    "auto_down": dict(prefill_chunk=8, prefill_chunks_per_tick=3,
                      chunks_per_tick_auto=True, tpot_slo_ms=1e-6,
                      steps_per_tick=1),
    # and holds the budget at its maximum under a generous one
    "auto_hold": dict(prefill_chunk=8, prefill_chunks_per_tick=3,
                      chunks_per_tick_auto=True, tpot_slo_ms=1e6,
                      steps_per_tick=1),
}


@pytest.mark.parametrize("case,overlap", [
    ("budget2", False), ("budget2", True), ("auto_down", False),
    ("auto_down", True), ("auto_hold", True)],
    ids=["sync-budget2", "overlap-budget2", "sync-auto_down",
         "overlap-auto_down", "overlap-auto_hold"])
def test_chunk_budget_matches_the_jax_engine(models, case, overlap):
    kw = dict(CASES[case], overlap=overlap)
    jrec, trec, teng = _both(models, _mix(4), **kw)
    assert trec == jrec
    assert trec["prefill_chunks"] > 0
    assert all(o == "finished" for o in trec["outcomes"])
    if case == "auto_down":
        assert teng._chunk_budget_now == 1
        assert teng.stats()["chunk_budget"] == 1
    if case == "auto_hold":
        assert teng._chunk_budget_now == 3
    if overlap and case == "budget2":
        assert trec["overlap_chunks"] > 0


def test_budget_spends_more_chunks_per_boundary(models):
    """At budget 2 a prompt takes half the boundaries it takes at budget
    1, with the same stream."""
    _, tm = models
    mix = _mix(1, lens=(64,), budgets=(4,))
    out = {}
    for budget in (1, 2):
        eng = ServingEngine(tm, device="cpu", prefill_chunk=8,
                            prefill_chunks_per_tick=budget, overlap=False,
                            **ENGINE)
        r = eng.add_request(Request(**mix[0]))
        n = 0
        while not r.output_ids:
            eng.step()
            n += 1
        eng.run()
        out[budget] = (n, list(r.output_ids), eng.stats()["prefill_chunks"])
    assert out[1][0] == 8 and out[2][0] == 4
    assert out[1][1:] == out[2][1:]


SHED = dict(slo_shed=True, ttft_slo_ms=1e-6, shed_queue_depth=2,
            max_batch=1, max_context=64, prefill_chunk=0)


@OVERLAP
def test_slo_shedding_matches_the_jax_engine(models, overlap):
    """One finished request primes the TTFT sketch over an impossible
    target; then 6 requests wait at once at priorities 1, 0, 0, 1, 0, 0:
    the scheduler sheds down to 2 waiting, the newest lowest-priority
    first, with the JAX engine's victims, outcomes and counters."""
    mix = _mix(6, lens=(7, 9, 12, 8, 10, 11), budgets=(3, 4, 3, 5, 3, 4))
    for i, m in enumerate(mix):
        m["priority"] = [1, 0, 0, 1, 0, 0][i]
    prime = dict(prompt_ids=list(range(1, 8)), max_new_tokens=3)
    jrec, trec, teng = _both(models, mix, prime=prime, overlap=overlap,
                             **SHED)
    assert trec == jrec
    # 6 waiting, depth 2: four shed at the first boundary (the first is
    # admitted only after), the priority-1 requests survive
    assert trec["slo_sheds"] == 4 and trec["shed"] == [1, 2, 4, 5]
    assert trec["outcomes"] == ["finished", "slo_shed", "slo_shed",
                                "finished", "slo_shed", "slo_shed"]
    for i in trec["shed"]:
        assert trec["traces"][i][2][0] == "rejected:slo_shed"
    assert "serving_slo_sheds 4" in export.render_prometheus()
    assert teng.stats()["free_blocks"] == teng.num_blocks


def test_no_shed_without_breach_and_priority_order(models):
    """Shedding needs a breach: a deep queue under a generous target
    admits everything, highest priority first (FIFO within one)."""
    _, tm = models
    eng = ServingEngine(tm, device="cpu", slo_shed=True, ttft_slo_ms=1e9,
                        shed_queue_depth=1, max_batch=1, max_context=64,
                        block_size=16)
    lo = eng.add_request(Request(np.arange(1, 8), max_new_tokens=3))
    hi = eng.add_request(Request(np.arange(2, 9), max_new_tokens=3,
                                 priority=5))
    mid = eng.add_request(Request(np.arange(3, 10), max_new_tokens=3,
                                  priority=5))
    eng.run()
    assert eng.stats()["slo_sheds"] == 0
    assert all(r.done for r in (lo, hi, mid))
    assert [r.rid for r in eng.finished] == [hi.rid, mid.rid, lo.rid]


# ------------------------------------------------------- the frontend

def _sse_frames(url, body, timeout=60):
    """POST /generate and read the stream to its terminal frame: a list
    of ``(event, payload)``, the rid taken out."""
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    frames, event = [], None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                d = json.loads(line[6:])
                d.pop("rid", None)
                frames.append((event, d))
                if event is not None:
                    break
                event = None
    return frames


def _frontend(http_mod, make, bodies, prime):
    """One package: the engine (primed by one ``run()``) behind its own
    endpoint; a client thread per body posts at once while the engine is
    idle, then ``run()`` serves them all.  Returns each body's frames."""
    eng = make()
    eng.add_request(prime)
    eng.run()
    srv = http_mod.MetricsServer(0, "127.0.0.1", engine=eng)
    out = [None] * len(bodies)
    errors = []

    def client(i):
        try:
            out[i] = _sse_frames(srv.url, bodies[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(bodies))]
    try:
        for t in threads:
            t.start()
        end = time.monotonic() + 60
        while len(eng.waiting) < len(bodies):
            assert time.monotonic() < end, "the clients never enqueued"
            time.sleep(0.01)
        eng.run()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        srv.close()
    assert not errors, errors
    return out, eng


def test_sse_frames_match_the_jax_frontend(models):
    """Four clients at distinct priorities, an impossible TTFT target,
    two may wait: the two lowest priorities are shed and end in an
    `error` frame with reason `slo_shed`, the others stream their tokens
    and end in `done`; frame for frame the JAX endpoint's."""
    mix = _mix(4, lens=(9, 14, 6, 11), budgets=(5, 4, 6, 3))
    bodies = [dict(m, priority=p, timeout_s=60)
              for m, p in zip(mix, (3, 0, 2, 1))]
    kw = dict(SHED, overlap=False)
    flags, make_jax, make_port = _engines(models, **kw)
    with flag_guard(**flags, **JAX_FLAGS):
        jframes, _ = _frontend(jhttp, make_jax,
                               bodies, JaxRequest([1, 2, 3],
                                                  max_new_tokens=3))
    tframes, eng = _frontend(obs_http, make_port, bodies,
                             Request([1, 2, 3], max_new_tokens=3))
    assert tframes == jframes
    ends = [f[-1] for f in tframes]
    assert [e[0] for e in ends] == ["done", "error", "done", "error"]
    assert ends[1][1] == {"reason": "slo_shed", "output_ids": []}
    assert [len(f) - 1 for f in tframes] == [5, 0, 6, 0]
    for frames in tframes:
        toks = [d["token"] for ev, d in frames[:-1]]
        assert toks == frames[-1][1]["output_ids"]
    assert eng.stats()["free_blocks"] == eng.num_blocks


# ------------------------------------------------- the tpot_p50_s fault

class _Clock:
    """A perf_counter that moves only when told: the harvests of both
    engines advance it by the same uneven steps."""

    def __init__(self):
        self.t = 1000.0
        self.n = 0

    def step(self):
        self.n += 1
        self.t += 0.001 * (1 + (self.n * 7) % 5)

    def perf_counter(self):
        return self.t

    monotonic = perf_counter

    @staticmethod
    def time():
        return time.time()

    @staticmethod
    def sleep(s):
        time.sleep(s)


def _clocked(monkeypatch, module, eng):
    """``eng``'s clock: its module's ``time`` replaced, and one step per
    harvest (before the harvest reads the clock)."""
    clock = _Clock()
    monkeypatch.setattr(module, "time", clock)
    materialize = eng._materialize

    def stepped(handle):
        clock.step()
        return materialize(handle)
    eng._materialize = stepped
    return clock


def _old_tpot_p50(gaps):
    """The port's answer before: the unweighted median of the last 64
    tick-level gaps (seconds per token of each harvest that yielded a
    token)."""
    recent = sorted(gaps[-64:])
    return round(recent[len(recent) // 2], 6)


def test_tpot_p50_is_the_jax_engines_weighted_sketch(models, monkeypatch):
    jm, tm = models
    # 2 slots, budgets 72 and 20: the harvests yield 2 tokens while both
    # run and 1 after, 71 ticks
    mix = [dict(prompt_ids=list(range(1, 12)), max_new_tokens=72),
           dict(prompt_ids=list(range(5, 25)), max_new_tokens=20)]
    kw = dict(max_batch=2, max_context=96, block_size=16, steps_per_tick=1)
    with flag_guard(serving_overlap=False, **JAX_FLAGS):
        jeng = JaxEngine(jm, **kw)
        _clocked(monkeypatch, jserving, jeng)
        for m in mix:
            jeng.add_request(JaxRequest(**m))
        jeng.run()
    teng = ServingEngine(tm, device="cpu", overlap=False, **kw)
    clock = _clocked(monkeypatch, tserving, teng)
    # the gap of each harvest that yielded a token: the step its clock
    # took, per decode step of the tick
    gaps, steps = [], []
    step, harvest = clock.step, teng._harvest

    def recorded_step():
        t = clock.t
        step()
        steps.append(clock.t - t)

    def recorded_harvest(pend):
        before = teng.tokens_out
        harvest(pend)
        if teng.tokens_out > before:
            gaps.append(steps[-1] / pend.k)
    clock.step = recorded_step
    teng._harvest = recorded_harvest
    for m in mix:
        teng.add_request(Request(**m))
    teng.run()
    teng._harvest = harvest
    assert teng.ticks == jeng.ticks and len(gaps) > 64
    jeng._mark_ready()
    teng._mark_ready()
    want = jeng.health()["ttft_evidence"]["tpot_p50_s"]
    got = teng.health()["ttft_evidence"]["tpot_p50_s"]
    assert got == want
    assert _old_tpot_p50(gaps) != want
    # the same sketch state, every harvest weighted by its tokens
    assert teng.telemetry_snapshot()["tpot_sketch"] == \
        jeng.telemetry_snapshot()["tpot_sketch"]
    assert teng._ev_tpot.count == teng.tokens_out - len(mix)
