"""Request tracing, the chunked scheduler and the SSE frontend of the
port's serving engine, on the CPU.

The cases of `tests/test_request_tracing.py` that do not test the JAX
compile tracker, and those of `tests/test_continuous_batching.py` from its
arrival-bound pin on (but tensor parallelism, which the port does not
have yet), run on the port's engine (`gpt3_tiny`): TTFT / TPOT / e2e /
queue-wait sketches and trace records, SLO counters, rejection records,
no tracing work with the metrics gate off, the scrape of a running
engine; a running stream fed while a long prompt is absorbed in chunks,
shedding and priorities, cancellation (running, waiting, mid-chunk),
chunk counters in the flight ring, `POST /generate` (a stream, a
disconnect, a timeout, the terminal error frame of a drain), and chunked
streams equal to whole-prompt ones (with speculation, Llama, and across
ladders and chunk sizes).  The same engines against the JAX engine's are
in `tests/test_torch_scheduler.py`.  Every HTTP call has a timeout and
every thread is joined with one.
"""

import http.client
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.observability import export, flight_recorder, metrics
from paddle_tpu_torch.observability import http as obs_http


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these models are tiny, and beside other
    pytest workers more threads only contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def model():
    return GPTForCausalLM(gpt3_tiny(), device="cpu", seed=0).eval()


@pytest.fixture(autouse=True)
def _clean():
    metrics.reset()
    export.clear_requests()
    flight_recorder.default_recorder().clear()
    yield
    metrics.set_enabled(True)
    metrics.reset()
    export.clear_requests()
    obs_http.attach_engine(None)
    obs_http.stop()


def _engine(model, **kw):
    kw = {"max_batch": 2, "max_context": 64, "block_size": 16, **kw}
    return ServingEngine(model, device="cpu", **kw)


def _mk(rng, plen, n):
    return Request(rng.randint(1, 1000, (plen,)), max_new_tokens=n)


# ------------------------------------------------------ request tracing

def test_ttft_tpot_e2e_traces(model):
    eng = _engine(model, max_context=128, steps_per_tick=2)
    rng = np.random.RandomState(0)
    reqs = [eng.add_request(_mk(rng, 10 + i, 6)) for i in range(3)]
    eng.run()
    assert all(r.done for r in reqs)
    assert metrics.get("serving.ttft_seconds").count() == 3
    assert metrics.get("serving.e2e_seconds").count() == 3
    assert metrics.get("serving.queue_wait_seconds").count() == 3
    # 6 tokens per request: 1 from prefill, 5 decode -> 5 TPOT samples
    assert metrics.get("serving.tpot_seconds").count() == 15
    lat = eng.stats()["latency"]
    for key in ("ttft", "tpot", "e2e", "queue_wait"):
        assert set(lat[key]) == {"p50", "p90", "p99"}
        assert lat[key]["p50"] <= lat[key]["p99"]
    assert lat["ttft"]["p50"] > 0 and lat["e2e"]["p50"] > 0
    assert lat["e2e"]["p99"] >= lat["ttft"]["p50"]
    recs = export.recent_requests()
    assert [r["rid"] for r in recs] == [r.rid for r in reqs]
    for req, rec in zip(reqs, recs):
        assert req.trace["outcome"] == "finished"
        assert rec["tokens_out"] == 6 and rec["ticks"] == 3
        assert rec["ttft_s"] >= rec["queue_wait_s"] >= 0
        assert rec["e2e_s"] >= rec["ttft_s"] > 0
        assert rec["prefill_s"] > 0 and rec["tpot_mean_s"] > 0
        json.dumps(rec)
    flight = [e for e in flight_recorder.default_recorder().events()
              if e["kind"] == "request"]
    assert {e["rid"] for e in flight} == {r.rid for r in reqs}


def test_queue_wait_under_forced_deferral(model):
    # 3 blocks: each request reserves 2, so the second waits for the first
    eng = _engine(model, num_blocks=3)
    rng = np.random.RandomState(1)
    r1 = eng.add_request(_mk(rng, 10, 20))
    r2 = eng.add_request(_mk(rng, 10, 20))
    assert metrics.get("serving.queue_depth").value() == 2
    assert metrics.get("serving.waiting").value() == 2
    eng.step()       # admits r1 only; r2 deferred (pool exhausted)
    assert r2.slot is None
    assert metrics.get("serving.running").value() == 1
    assert metrics.get("serving.waiting").value() == 1
    assert metrics.get("serving.rejections").value(
        reason="pool_exhausted") == 1
    eng.run()
    assert r1.done and r2.done
    assert r2.trace["queue_wait_s"] > r1.trace["queue_wait_s"]
    assert r2.trace["queue_wait_s"] > 10 * max(r1.trace["queue_wait_s"],
                                               1e-6)
    st = eng.stats()
    assert st["queue_depth"] == 0 and st["running"] == 0
    assert metrics.get("serving.queue_depth").value() == 0


def test_slo_violation_counters(model):
    rng = np.random.RandomState(2)
    eng = _engine(model)
    eng.add_request(_mk(rng, 8, 4))
    eng.run()
    slo = metrics.get("serving.slo_violations")
    assert slo.value(metric="ttft") == 0 and slo.value(metric="tpot") == 0
    eng = _engine(model, ttft_slo_ms=1e-6, tpot_slo_ms=1e-6)
    eng.add_request(_mk(rng, 8, 4))
    eng.run()
    assert slo.value(metric="ttft") == 1
    assert slo.value(metric="tpot") == 3      # every decode token
    assert eng.telemetry_snapshot()["slo_violations_ttft"] == 1


def test_rejection_trace_records(model):
    eng = _engine(model)
    with pytest.raises(ValueError):
        eng.add_request(Request(np.arange(1, 60), max_new_tokens=30))
    recs = export.recent_requests()
    assert recs and recs[-1]["outcome"] == "rejected:over_context"


def test_tracing_off_does_zero_work(model):
    """With the metrics gate off: no trace stamps, no sketch samples, no
    trace records, no flight records of requests or ticks."""
    eng = _engine(model, prefill_chunk=8)
    rng = np.random.RandomState(3)
    metrics.set_enabled(False)
    try:
        r = eng.add_request(_mk(rng, 20, 4))
        eng.run()
    finally:
        metrics.set_enabled(True)
    assert r.done
    assert r._t_enqueue is None and r._t_first is None
    assert r._t_admit is None and r._t_last is None
    assert r.trace is None
    assert export.recent_requests() == []
    assert metrics.get("serving.ttft_seconds").count() == 0
    assert metrics.snapshot() == {}
    rec = flight_recorder.default_recorder()
    assert rec.steps() == [] and not [e for e in rec.events()
                                      if e["kind"] in ("request",
                                                       "prefill_chunk")]
    # the always-on evidence stays: health() and the telemetry snapshot
    ev = eng.telemetry_snapshot()
    assert ev["outcomes"] == {"finished": 1} and ev["finished_tokens"] == 4
    assert ev["tpot_sketch"]["count"] == 3


def test_engine_scrape_acceptance(model):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    eng = _engine(model, metrics_port=port)
    rng = np.random.RandomState(5)
    eng.add_request(_mk(rng, 8, 4))
    eng.run()                     # starts the endpoint
    srv = obs_http.current()
    assert srv is not None and srv.port == port
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    assert 'serving_ttft_seconds{quantile="0.5"}' in body
    assert 'serving_ttft_seconds{quantile="0.99"}' in body
    assert 'serving_tpot_seconds{quantile="0.99"}' in body
    assert "serving_ttft_seconds_count 1" in body
    assert "serving_queue_depth 0" in body
    reqs = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/requests", timeout=10).read())
    assert reqs[-1]["outcome"] == "finished"


# ------------------------------------------------- the chunked scheduler

def test_long_arrival_bounds_running_stream(model):
    """While a 60-token prompt is absorbed, a chunked engine feeds the
    running stream every boundary; a whole-prompt engine absorbs it in
    one boundary, and the stream advances at most once meanwhile."""
    rng = np.random.RandomState(3)
    long_p = rng.randint(1, 1000, (60,))
    short_p = rng.randint(1, 1000, (6,))

    def drive(chunk):
        eng = _engine(model, max_context=96, prefill_chunk=chunk,
                      prefix_cache=False)
        s = eng.add_request(Request(short_p, max_new_tokens=40))
        eng.step()
        eng.step()
        lr = eng.add_request(Request(long_p, max_new_tokens=3))
        grew = 0
        while not lr.output_ids:
            n0 = len(s.output_ids)
            if not eng.step():
                break
            if len(s.output_ids) > n0:
                grew += 1
        eng.run()
        assert eng.stats()["free_blocks"] == eng.num_blocks
        return grew, lr

    grew_c, lr_c = drive(10)
    assert lr_c._prefill_chunks == 6          # ceil(60 / 10)
    assert grew_c >= 5
    grew_m, lr_m = drive(0)
    assert lr_m._prefill_chunks == 0
    assert grew_m <= 1


def test_slo_shed_rejects_newest_lowest_priority(model):
    eng = _engine(model, max_batch=1, slo_shed=True, ttft_slo_ms=1e-4,
                  shed_queue_depth=2)
    eng.add_request(Request(np.arange(1, 8), max_new_tokens=3))
    eng.run()                     # loads the (breaching) TTFT sketch
    rng = np.random.RandomState(4)
    reqs = [eng.add_request(Request(rng.randint(1, 1000, (7,)),
                                    max_new_tokens=3,
                                    priority=(1 if i == 0 else 0)))
            for i in range(6)]
    eng.run()
    st = eng.stats()
    assert st["slo_sheds"] == 4
    served = [r for r in reqs if r.done]
    shed = [r for r in reqs if r.shed]
    assert len(served) == 2 and len(shed) == 4
    assert reqs[0] in served and reqs[1] in served
    for r in shed:
        assert r.trace["outcome"] == "rejected:slo_shed"
        assert r.outcome == "slo_shed" and not r.output_ids
    snap = metrics.snapshot()
    rej = {dict(s["labels"])["reason"]: s["value"]
           for s in snap["serving.rejections"]["series"]}
    assert rej["slo_shed"] == 4
    assert snap["serving.slo_sheds"]["series"][0]["value"] == 4
    assert "serving_slo_sheds 4" in export.render_prometheus()
    assert st["free_blocks"] == eng.num_blocks


def test_cancel_running_and_waiting_releases_everything(model):
    eng = _engine(model, max_batch=1)
    running = eng.add_request(Request(np.arange(1, 9), max_new_tokens=30))
    queued = eng.add_request(Request(np.arange(2, 10), max_new_tokens=4))
    eng.step()
    eng.step()
    running.cancel()
    queued.cancel()
    eng.run()
    assert not running.done and len(running.output_ids) < 30
    assert not queued.done and not queued.output_ids
    assert running in eng.finished and queued in eng.finished
    st = eng.stats()
    assert st["free_blocks"] == eng.num_blocks and st["reserved"] == 0
    assert running.trace["outcome"] == "cancelled"
    assert queued.trace["outcome"] == "cancelled"


def test_cancel_mid_chunked_prefill_aborts_and_releases(model):
    eng = _engine(model, max_context=96, prefill_chunk=8,
                  prefix_cache=False)
    r = eng.add_request(Request(np.arange(1, 61), max_new_tokens=4))
    eng.step()                       # first chunk only (budget 1/tick)
    assert r._prefilling and r._prefill_chunks >= 1
    r.cancel()
    eng.run()
    assert not r.output_ids and not r.done and r.outcome == "cancelled"
    st = eng.stats()
    assert st["free_blocks"] == eng.num_blocks and st["reserved"] == 0
    assert st["prefilling"] == 0


def test_chunk_counters_traces_and_flight_records(model):
    eng = _engine(model, prefill_chunk=8, prefix_cache=False)
    r = eng.add_request(Request(np.arange(1, 21), max_new_tokens=4))
    eng.run()
    assert r.trace["prefill_chunks"] == 3     # ceil(20 / 8)
    snap = metrics.snapshot()
    assert snap["serving.prefill_chunks"]["series"][0]["value"] == 3
    assert "serving_prefill_chunks 3" in export.render_prometheus()
    rec = flight_recorder.default_recorder()
    chunk_events = [e for e in rec.events()
                    if e.get("kind") == "prefill_chunk"]
    assert len(chunk_events) == 3
    assert chunk_events[-1]["done"] is True
    assert chunk_events[0]["start"] == 0 and chunk_events[0]["tokens"] == 8
    tick_recs = [s for s in rec.steps()
                 if s.get("timeline") == "serving"
                 and s.get("prefill_chunks")]
    assert sum(s["prefill_chunks"] for s in tick_recs) == 3
    for s in rec.steps():
        assert set(s["phases"]) == {
            "schedule_ms", "chunk_prefill_ms", "dispatch_ms",
            "harvest_wait_ms", "emit_ms", "host_ms", "device_wait_ms"}


# ------------------------------------------------------- SSE endpoint

def _sse_events(resp):
    event = None
    for raw in resp:
        line = raw.decode().rstrip("\n")
        if line.startswith("event: "):
            event = line[7:]
        elif line.startswith("data: "):
            yield event, json.loads(line[6:])
            event = None


def _conn(srv):
    return http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)


def _post(conn, path, body=None):
    conn.request("POST", path, body=None if body is None
                 else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    return conn.getresponse()


def test_sse_generate_stream_and_disconnect_cancels(model):
    eng = _engine(model, prefill_chunk=8)
    stop = threading.Event()
    obs_http.attach_engine(eng)
    assert obs_http.current_engine() is eng
    srv = obs_http.MetricsServer(0, "127.0.0.1")
    t = threading.Thread(target=eng.serve_forever, args=(stop,),
                         daemon=True)
    t.start()
    try:
        conn = _conn(srv)
        resp = _post(conn, "/generate", {"prompt_ids": list(range(1, 10)),
                                         "max_new_tokens": 6})
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "text/event-stream"
        toks, done = [], None
        for event, d in _sse_events(resp):
            if event == "done":
                done = d
                break
            if event is None and "token" in d:
                toks.append(d["token"])
        conn.close()
        assert done["outcome"] == "finished"
        assert done["output_ids"] == toks and len(toks) == 6
        ref = _engine(model)
        rr = ref.add_request(Request(list(range(1, 10)), max_new_tokens=6))
        ref.run()
        assert rr.output_ids == toks
        # malformed body -> 400, engine unharmed
        conn = _conn(srv)
        assert _post(conn, "/generate", {}).status == 400
        conn.close()
        # disconnect mid-stream -> cancel -> eviction + block release
        conn = _conn(srv)
        resp = _post(conn, "/generate", {"prompt_ids": list(range(1, 9)),
                                         "max_new_tokens": 50})
        resp.read(40)                 # a few tokens, then hang up
        conn.close()
        deadline = time.time() + 20
        while time.time() < deadline:
            st = eng.stats()
            if st["free_blocks"] == eng.num_blocks and st["active"] == 0 \
                    and st["prefilling"] == 0:
                break
            time.sleep(0.05)
        st = eng.stats()
        assert st["free_blocks"] == eng.num_blocks and st["active"] == 0
    finally:
        stop.set()
        t.join(timeout=10)
        srv.close()
    assert not t.is_alive()


def test_sse_timeout_cancels_and_reports(model):
    """The engine loop is not running, so the request cannot produce a
    token before its deadline: an ``error`` frame, and the next ``run()``
    drops the cancelled request."""
    eng = _engine(model, max_batch=1)
    obs_http.attach_engine(eng)
    srv = obs_http.MetricsServer(0, "127.0.0.1")
    try:
        conn = _conn(srv)
        resp = _post(conn, "/generate", {"prompt_ids": list(range(1, 9)),
                                         "max_new_tokens": 8,
                                         "timeout_s": 0.3})
        err = next((d for ev, d in _sse_events(resp) if ev == "error"),
                   None)
        conn.close()
        assert err is not None and err["error"] == "timeout"
        assert len(eng.waiting) == 1 and eng.waiting[0].cancelled
        eng.run()
        st = eng.stats()
        assert st["free_blocks"] == eng.num_blocks
        assert st["waiting"] == 0 and st["active"] == 0
    finally:
        srv.close()


def test_serving_http_port_gate(model):
    """``http_port`` 0 (the default) starts nothing."""
    eng = _engine(model)
    assert eng.http_port == 0 and eng.metrics_port == 0
    eng.add_request(Request([1, 2, 3], max_new_tokens=2))
    eng.run()
    assert obs_http.serving_server() is None and obs_http.current() is None


def test_sse_terminal_error_frame_format(model):
    """A stream the engine ends closes with ``event: error`` and exactly
    ``{"rid", "reason", "output_ids"}``; a finished one with ``done``.
    Through a drain: A (admitted) finishes inside the deadline, B
    (waiting behind A's slot) ends ``drained``; POST /drain answers 202
    and /healthz flips to 503 draining."""
    eng = _engine(model, max_batch=1)
    stop = threading.Event()
    obs_http.attach_engine(eng)
    srv = obs_http.MetricsServer(0, "127.0.0.1")
    t = threading.Thread(target=eng.serve_forever, args=(stop,),
                         daemon=True)
    t.start()
    try:
        conn_a = _conn(srv)
        resp_a = _post(conn_a, "/generate", {"prompt_ids": [1, 2, 3],
                                             "max_new_tokens": 56})
        assert resp_a.status == 200
        events_a = _sse_events(resp_a)
        first = next(d for ev, d in events_a if ev is None)
        assert "token" in first
        conn_b = _conn(srv)
        resp_b = _post(conn_b, "/generate", {"prompt_ids": [4, 5, 6],
                                             "max_new_tokens": 4})
        assert resp_b.status == 200
        conn_d = _conn(srv)
        resp_d = _post(conn_d, "/drain")
        assert resp_d.status == 202
        assert json.loads(resp_d.read())["draining"] is True
        conn_d.close()
        ev_b, frame_b = next((e, d) for e, d in _sse_events(resp_b)
                             if e is not None)
        conn_b.close()
        assert ev_b == "error"
        assert frame_b == {"rid": frame_b["rid"], "reason": "drained",
                           "output_ids": []}
        done_a = next(d for ev, d in events_a if ev == "done")
        conn_a.close()
        assert done_a["outcome"] == "finished"
        assert len(done_a["output_ids"]) == 56
        conn_h = _conn(srv)
        conn_h.request("GET", "/healthz")
        resp_h = conn_h.getresponse()
        doc = json.loads(resp_h.read())
        conn_h.close()
        assert resp_h.status == 503 and doc["reason"] == "draining"
        t.join(timeout=30)
        assert not t.is_alive()
        assert eng.stats()["free_blocks"] == eng.num_blocks
    finally:
        stop.set()
        srv.close()


# ----------------------------------- chunked streams equal whole-prompt

def _streams(model, prompts, budgets, chunk, **kw):
    eng = _engine(model, max_context=96, prefill_chunk=chunk, **kw)
    reqs = [eng.add_request(Request(p, max_new_tokens=b))
            for p, b in zip(prompts, budgets)]
    eng.run()
    assert eng.stats()["free_blocks"] == eng.num_blocks
    assert eng.stats()["reserved"] == 0
    return eng, [list(r.output_ids) for r in reqs]


def test_chunked_spec_decode_parity(model):
    draft = GPTForCausalLM(gpt3_tiny(num_layers=1), device="cpu",
                           seed=4).eval()
    rng = np.random.RandomState(7)
    prompts = (rng.randint(1, 1000, (22,)), rng.randint(1, 1000, (10,)))
    _, base = _streams(model, prompts, (9, 9), 0)
    eng, got = _streams(model, prompts, (9, 9), 8, draft_model=draft,
                        spec_decode=True, spec_k=3,
                        prefill_chunks_per_tick=2)
    assert got == base
    assert eng.stats()["speculative"]["ticks"] > 0
    assert eng.stats()["prefill_chunks"] > 0


def test_chunked_llama_parity():
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
    m = LlamaForCausalLM(llama_tiny(), device="cpu", seed=2).eval()
    rng = np.random.RandomState(9)
    prompts = (rng.randint(1, 500, (21,)), rng.randint(1, 500, (9,)))
    _, base = _streams(m, prompts, (6, 5), 0)
    _, got = _streams(m, prompts, (6, 5), 8, prefill_chunks_per_tick=2)
    assert got == base


@pytest.mark.parametrize("ladder", [None, (16, 48, 96)],
                         ids=["default", "custom"])
def test_chunked_parity_across_buckets_and_chunk_sizes(model, ladder):
    rng = np.random.RandomState(8)
    prompts = tuple(rng.randint(1, 1000, (L,)) for L in (7, 18, 40, 61))
    budgets = (5, 5, 5, 5)
    _, base = _streams(model, prompts, budgets, 0, pad_buckets=ladder)
    # 96 >= every prompt: the single-chunk-per-admission edge
    for chunk, per_tick in ((3, 1), (8, 2), (32, 3), (96, 1)):
        _, got = _streams(model, prompts, budgets, chunk,
                          pad_buckets=ladder,
                          prefill_chunks_per_tick=per_tick)
        assert got == base, (ladder, chunk, per_tick)
