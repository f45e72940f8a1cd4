"""The port's observability modules against the JAX package's, on the CPU.

`paddle_tpu_torch/observability/` keeps its own copies of the JAX
package's pure-Python metrics registry (`metrics.py`, `descriptions.py`),
quantile sketch (`quantiles.py`), Prometheus exporter and request ring
(`export.py`), trace context (`tracing.py`, `chrome.py`) and HTTP endpoint
(`http.py`).  Here:

* the registry's and the span's cases of `tests/test_observability.py`
  and every case of `tests/test_scrape_surface.py` but the dump CLI's,
  run on the port's modules;
* the same sequence of instrument calls made on a JAX registry and on a
  port registry gives the same `snapshot()` and byte for byte the same
  `render_prometheus()`; a sketch's quantiles, merge and wire state are
  the JAX sketch's, and within its relative error bound of numpy's;
* the serving engine's instruments on `gpt3_tiny` with the same weights
  (`models/convert.py`): counters, rejections and the Prometheus lines
  equal the JAX engine's;
* the flight recorder's dump carries the registry, and two engines with
  recorders of their own do not interleave their records;
* the HTTP endpoint's smoke and readiness cases on port 0.

The gate is the JAX flag `enable_metrics` there and
`metrics.set_enabled` here; each test leaves both on and both registries
empty.  The JAX engine runs with its paged Pallas views off (`pl.load` is
gone from this jax release; the dense views are the same math).
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.flags import flag_guard
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu.observability import chrome as jchrome
from paddle_tpu.observability import descriptions as jdesc
from paddle_tpu.observability import export as jexport
from paddle_tpu.observability import flight_recorder as jflight
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import quantiles as jquant
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.observability import chrome, descriptions, export
from paddle_tpu_torch.observability import flight_recorder, metrics
from paddle_tpu_torch.observability import http as obs_http
from paddle_tpu_torch.observability import quantiles, tracing

JAX_FLAGS = dict(serving_pallas_prefill=False, serving_pallas_verify=False)


@pytest.fixture(autouse=True)
def _clean():
    metrics.reset()
    jmetrics.reset()
    export.clear_requests()
    yield
    metrics.set_enabled(True)
    paddle.set_flags({"enable_metrics": True})
    metrics.reset()
    jmetrics.reset()
    export.clear_requests()
    obs_http.attach_engine(None)
    obs_http.stop()


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


# ------------------------------------------------------ the registry

def test_counter_semantics():
    c = metrics.counter("t.counter", "help text")
    c.inc()
    c.inc(2)
    c.inc(op="add")
    c.inc(3, op="add")
    c.inc(op="mul")
    assert c.value() == 3
    assert c.value(op="add") == 4
    assert c.value(op="mul") == 1
    assert c.total() == 8
    snap = metrics.snapshot()["t.counter"]
    assert snap["type"] == "counter" and snap["help"] == "help text"
    assert {"labels": {"op": "mul"}, "value": 1} in snap["series"]


def test_counter_get_or_create_idempotent():
    a = metrics.counter("t.same")
    b = metrics.counter("t.same")
    assert a is b
    with pytest.raises(ValueError):
        metrics.gauge("t.same")


def test_gauge_semantics():
    g = metrics.gauge("t.gauge")
    assert g.value() is None
    g.set(0.5)
    g.set(0.75)
    assert g.value() == 0.75
    g.inc(0.25)
    g.dec(0.5)
    assert abs(g.value() - 0.5) < 1e-9
    g.set(3, slot="a")
    assert g.value(slot="a") == 3


def test_histogram_semantics():
    h = metrics.histogram("t.hist", buckets=[0.1, 1.0, 10.0])
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    assert h.count() == 4
    assert abs(h.sum() - 55.55) < 1e-9
    val = metrics.snapshot()["t.hist"]["series"][0]["value"]
    assert val["count"] == 4
    assert val["min"] == 0.05 and val["max"] == 50.0
    assert val["buckets"] == {"0.1": 1, "1.0": 1, "10.0": 1, "+inf": 1}
    assert abs(val["mean"] - 55.55 / 4) < 1e-9


def test_label_cardinality_overflow():
    c = metrics.counter("t.cardinality")
    limit = type(c).MAX_SERIES
    for i in range(limit + 10):
        c.inc(rid=i)
    snap = metrics.snapshot()["t.cardinality"]["series"]
    assert len(snap) == limit + 1          # capped + one overflow series
    overflow = [s for s in snap if s["labels"] == {"__overflow__": "true"}]
    assert overflow and overflow[0]["value"] == 10


def test_disabled_mode_is_noop():
    c = metrics.counter("t.disabled")
    h = metrics.histogram("t.disabled_h")
    assert metrics.set_enabled(False) is True
    assert not metrics.enabled()
    c.inc()
    c.inc_key((("op", "x"),))
    h.observe(1.0)
    metrics.gauge("t.disabled_g").set(5)
    metrics.quantile("t.disabled_q").observe(1.0)
    assert metrics.snapshot() == {}
    assert metrics.set_enabled(True) is False
    assert metrics.enabled()
    c.inc()
    assert c.total() == 1


def test_reset_keeps_definitions():
    c = metrics.counter("t.reset")
    c.inc(5)
    metrics.reset()
    assert metrics.counter("t.reset") is c
    assert c.total() == 0
    assert "t.reset" not in metrics.snapshot()  # no data -> omitted


def test_export_json(tmp_path):
    metrics.counter("t.export").inc(7, kind="x")
    path = tmp_path / "metrics.json"
    text = metrics.export_json(str(path))
    doc = json.loads(path.read_text())
    assert json.loads(text) == doc
    assert doc["schema"] == "paddle_tpu_torch.metrics/v1"
    assert doc["metrics"]["t.export"]["series"][0]["value"] == 7


def test_span_histogram_and_profiler_range():
    with obs.span("outside_profiler"):
        pass
    h = metrics.get("spans.seconds")
    assert h.count(name="outside_profiler") == 1
    # inside a recording profiler the span is a range on its host timeline
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("inside_profiler"):
            sum(range(100))
    assert h.count(name="inside_profiler") == 1
    assert any(e.name == "inside_profiler" for e in prof.events())
    # begin()/end() without a profiler, and end() twice
    sp = obs.span("manual").begin()
    assert sp.end() >= 0 and sp.end() is None


# ----------------------------------------- the same calls, both packages

def _instrument_calls(mod):
    """One sequence of instrument calls on a fresh registry of ``mod``
    (either package's metrics module)."""
    reg = mod.Registry()
    c = reg.counter("req.total", 'reqs with "quotes" and \n')
    c.inc(2, path='a"b\\c\nd')
    c.inc(1, path="plain")
    c.inc_key((("path", "plain"),), 4)
    g = reg.gauge("g.jobs", "test gauge")
    g.set(3)
    g.inc(0.5, pool="x")
    g.dec(2, pool="x")
    h = reg.histogram("lat.hist", "latencies", buckets=(0.1, 1.0))
    for v in (0.05, 0.3, 0.5, 5.0, 0.1):
        h.observe(v)
    h.observe(0.7, route="b")
    q = reg.quantile("ttft.q", "ttft sketch")
    rng = np.random.RandomState(5)
    for v in rng.exponential(0.05, 300):
        q.observe(float(v), engine="e1")
    q.observe(0.0, weight=3, engine="e2")
    q.observe(0.02, weight=7.5, engine="e2")
    reg.counter("nohelp.total").inc(4)
    reg.counter("never.written", "no series")
    return reg


def test_snapshot_and_prometheus_equal_the_jax_modules():
    jreg, treg = _instrument_calls(jmetrics), _instrument_calls(metrics)
    assert treg.snapshot() == jreg.snapshot()
    assert export.render_prometheus(treg) == jexport.render_prometheus(jreg)
    assert export.render_prometheus(treg, "fleet_") == \
        jexport.render_prometheus(jreg, "fleet_")
    # the histogram's percentile query too
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        assert treg.get("lat.hist").percentile(q) == \
            jreg.get("lat.hist").percentile(q)
    # the mergeable wire state of /metrics/snapshot
    from paddle_tpu.observability import federation
    assert export.registry_state(treg) == federation.registry_state(jreg)


@pytest.mark.parametrize("stream", ["exponential", "gamma", "decades"])
def test_sketch_equals_the_jax_sketch(stream):
    rng = np.random.RandomState(7)
    vals = {"exponential": lambda: rng.exponential(0.05, 3000),
            "gamma": lambda: rng.gamma(2.0, 0.01, 3000),
            "decades": lambda: 10.0 ** rng.uniform(-9, 3, 3000)}[stream]()
    weights = rng.randint(1, 5, len(vals)).astype(float)
    bins = 64 if stream == "decades" else 2048
    ours = quantiles.QuantileSketch(alpha=0.01, max_bins=bins)
    theirs = jquant.QuantileSketch(alpha=0.01, max_bins=bins)
    for v, w in zip(vals, weights):
        ours.add(v, w)
        theirs.add(v, w)
    assert ours.to_state() == theirs.to_state()
    for q in (0.01, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    # the error bound against numpy's weighted order statistics (with 64
    # bins, 12 decades collapse their low bins: the top keeps its bound)
    order = np.argsort(vals)
    cum = np.cumsum(weights[order])
    for q in ((0.99,) if stream == "decades" else (0.5, 0.9, 0.99)):
        true = vals[order][np.searchsorted(cum, q * cum[-1])]
        assert abs(ours.quantile(q) - true) / true < 0.02
    # merge and the wire round trip, against the JAX sketch's
    a, b = quantiles.QuantileSketch(), quantiles.QuantileSketch()
    ja, jb = jquant.QuantileSketch(), jquant.QuantileSketch()
    for v in vals[:1000]:
        a.add(v)
        ja.add(v)
    for v in vals[1000:2000]:
        b.add(v)
        jb.add(v)
    a.merge(b)
    ja.merge(jb)
    assert a.to_state() == ja.to_state()
    back = quantiles.QuantileSketch.from_state(json.loads(json.dumps(
        ja.to_state())))
    assert back.to_state() == a.to_state()
    assert a.to_dict() == ja.to_dict()


# -------------------------------------------------------- the sketches

def test_sketch_relative_error_bound():
    rng = np.random.RandomState(0)
    vals = rng.exponential(0.05, 10000)
    sk = quantiles.QuantileSketch(alpha=0.01)
    for v in vals:
        sk.add(v)
    assert sk.count == 10000
    np.testing.assert_allclose(sk.sum, vals.sum(), rtol=1e-9)
    for q in (0.5, 0.9, 0.99):
        true = np.quantile(vals, q)
        assert abs(sk.quantile(q) - true) / true < 0.02, q


def test_sketch_merge_equals_combined_stream():
    rng = np.random.RandomState(1)
    vals = rng.gamma(2.0, 0.01, 4000)
    a, b, whole = (quantiles.QuantileSketch(), quantiles.QuantileSketch(),
                   quantiles.QuantileSketch())
    for v in vals[:2000]:
        a.add(v)
        whole.add(v)
    for v in vals[2000:]:
        b.add(v)
        whole.add(v)
    a.merge(b)
    for q in (0.1, 0.5, 0.99):
        assert a.quantile(q) == whole.quantile(q)
    assert a.count == whole.count
    assert a.sum == pytest.approx(whole.sum)   # float summation order
    with pytest.raises(ValueError):
        a.merge(quantiles.QuantileSketch(alpha=0.02))


def test_sketch_memory_bound_preserves_upper_quantiles():
    sk = quantiles.QuantileSketch(alpha=0.01, max_bins=64)
    rng = np.random.RandomState(2)
    vals = 10.0 ** rng.uniform(-9, 3, 5000)
    for v in vals:
        sk.add(v)
    assert len(sk._bins) <= 64
    true = np.quantile(vals, 0.99)
    assert abs(sk.quantile(0.99) - true) / true < 0.05


def test_sketch_zero_and_weighted_observations():
    sk = quantiles.QuantileSketch()
    sk.add(0.0)                  # a queue wait can be exactly zero
    sk.add(0.010, weight=99)     # TPOT imputes one gap to k tokens
    assert sk.count == 100
    assert sk.quantile(0.001) == 0.0
    assert abs(sk.quantile(0.9) - 0.010) / 0.010 < 0.01


def test_quantile_metric_is_gated_and_labelled():
    qm = metrics.quantile("t.q_gate", "gate test")
    metrics.set_enabled(False)
    qm.observe(1.0, route="a")
    assert qm.count(route="a") == 0
    metrics.set_enabled(True)
    qm.observe(1.0, route="a")
    qm.observe(3.0, route="b")
    assert qm.count(route="a") == 1 and qm.count(route="b") == 1
    snap = metrics.snapshot()["t.q_gate"]
    assert snap["type"] == "quantile"
    by = {tuple(s["labels"].items()): s["value"] for s in snap["series"]}
    assert by[(("route", "a"),)]["quantiles"]["0.5"] == 1.0
    json.dumps(snap)


def test_histogram_percentile_interpolation():
    h = metrics.histogram("t.hist_pct", "h", buckets=(1.0, 2.0, 4.0))
    assert h.percentile(0.5) is None        # no data
    for v in (0.5, 1.5, 3.0, 8.0):
        h.observe(v)
    assert h.percentile(0.5) == pytest.approx(2.0)
    assert h.percentile(0.75) == pytest.approx(4.0)
    assert 4.0 < h.percentile(0.99) <= 8.0
    assert h.percentile(1.0) == pytest.approx(8.0)
    assert h.percentile(0.0) == pytest.approx(0.5)


# ------------------------------------------------ the exporter (golden)

GOLDEN = """\
# HELP g_jobs test gauge
# TYPE g_jobs gauge
g_jobs 3
# HELP lat_hist latencies
# TYPE lat_hist histogram
lat_hist_bucket{le="0.1"} 1
lat_hist_bucket{le="1"} 3
lat_hist_bucket{le="+Inf"} 4
lat_hist_sum 5.85
lat_hist_count 4
# TYPE nohelp_total counter
nohelp_total 4
# HELP req_total reqs with "quotes" and \\n
# TYPE req_total counter
req_total{path="a\\"b\\\\c\\nd"} 2
req_total{path="plain"} 1
# HELP ttft_q ttft sketch
# TYPE ttft_q summary
ttft_q{engine="e1",quantile="0.5"} 0.25
ttft_q{engine="e1",quantile="0.9"} 0.25
ttft_q{engine="e1",quantile="0.99"} 0.25
ttft_q_sum{engine="e1"} 0.25
ttft_q_count{engine="e1"} 1
# HELP zz_described described via the metric-description registry
# TYPE zz_described gauge
zz_described 1
"""


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_prometheus_golden_rendering(package):
    """Byte-exact exposition from both packages' modules: name
    sanitisation, label escaping, cumulative buckets closed by +Inf,
    summary lines, and `# HELP` from the description registry (a metric
    with no description gets a bare `# TYPE`)."""
    mod, exp, desc = ((metrics, export, descriptions) if package == "torch"
                      else (jmetrics, jexport, jdesc))
    reg = mod.Registry()
    c = reg.counter("req.total", 'reqs with "quotes" and \n')
    c.inc(2, path='a"b\\c\nd')
    c.inc(1, path="plain")
    g = reg.gauge("g.jobs", "test gauge")
    g.set(3)
    h = reg.histogram("lat.hist", "latencies", buckets=(0.1, 1.0))
    for v in (0.05, 0.3, 0.5, 5.0):
        h.observe(v)
    q = reg.quantile("ttft.q", "ttft sketch")
    q.observe(0.25, engine="e1")
    reg.counter("nohelp.total").inc(4)
    desc.describe("zz.described",
                  "described via the metric-description registry")
    reg.gauge("zz.described").set(1)
    assert exp.render_prometheus(reg) == GOLDEN
    assert desc.lookup("g.jobs") == "test gauge"
    assert desc.lookup("nohelp.total") is None


def test_prometheus_skips_empty_instruments():
    reg = metrics.Registry()
    reg.counter("never.written", "no series")
    assert export.render_prometheus(reg) == ""


def test_request_ring_and_trace_helpers():
    export.record_request({"rid": 1, "outcome": "finished"})
    export.record_request({"rid": 2, "outcome": "cancelled"})
    assert [r["rid"] for r in export.recent_requests(1)] == [2]
    assert export.recent_requests(0) == []
    # trace headers, clock sync and the chrome documents: the JAX modules'
    for hdr in ("0123456789abcdef-89abcdef", "0123456789ABCDEF", "zz",
                "01234567-zz", None, ""):
        assert tracing.parse_header(hdr) == jtracing.parse_header(hdr)
    assert tracing.format_header("ab" * 8, "cd" * 4) == \
        jtracing.format_header("ab" * 8, "cd" * 4)
    assert len(tracing.mint_trace_id()) == 16
    a, b = tracing.ClockSync(), jtracing.ClockSync()
    for t0, srv, t1 in ((1.0, 5.2, 1.4), (2.0, 6.1, 2.1), (3.0, 7.0, 3.5)):
        assert a.update(t0, srv, t1) == b.update(t0, srv, t1)
    assert a.view() == b.view()
    doc = {"schema": "x", "pid": 1, "reason": "manual", "steps": [
        {"timeline": "serving", "step": 3, "t_unix": 100.0, "wall_s": 0.01,
         "tokens": 4, "phases": {"schedule_ms": 1.0, "dispatch_ms": 2.0,
                                 "harvest_wait_ms": 3.0, "emit_ms": 1.0}}],
        "events": [
            {"kind": "request", "outcome": "finished", "rid": 7,
             "unix_time": 101.0, "e2e_s": 0.5, "queue_wait_s": 0.1,
             "prefill_s": 0.2, "trace_id": "ab" * 8},
            {"kind": "prefill_chunk", "rid": 7, "unix_time": 100.7,
             "start": 0, "tokens": 8, "done": True},
            {"kind": "span", "cat": "router", "name": "plan",
             "start_s": 99.0, "end_s": 99.5, "trace_id": "ab" * 8},
            {"kind": "replica_meta", "replica": "r0"}]}
    # the same documents under the port's schema names
    def schema(d):
        d["otherData"]["schema"] = d["otherData"]["schema"].replace(
            "paddle_tpu_torch.", "paddle_tpu.")
        return d
    assert schema(chrome.trace_from_flight(doc)) == \
        jchrome.trace_from_flight(doc)
    assert schema(tracing.fleet_trace([doc, doc])) == \
        jtracing.fleet_trace([doc, doc])


# --------------------------------------------------- the serving engine

def _serve_both(models, prompts, budgets, **kw):
    jm, tm = models
    rng_reqs = list(zip(prompts, budgets))
    with flag_guard(**JAX_FLAGS):
        jeng = JaxEngine(jm, **kw)
        for p, b in rng_reqs:
            jeng.add_request(JaxRequest(p, max_new_tokens=b))
        jeng.run()
    teng = ServingEngine(tm, device="cpu", **kw)
    for p, b in rng_reqs:
        teng.add_request(Request(p, max_new_tokens=b))
    teng.run()
    return jeng, teng


COUNTERS = ("serving.admissions", "serving.tokens_out", "serving.ticks",
            "serving.rejections", "serving.request_outcomes",
            "serving.prefix_misses", "serving.prefix_hits",
            "serving.overlap_dispatches", "serving.prefill_chunks")


def _counter_series(snap):
    return {n: snap[n]["series"] for n in COUNTERS if n in snap}


def test_serving_instrumentation_and_export(models, tmp_path):
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, 100, (8,))
    _serve_both(models, [prompt], [4], max_batch=2, max_context=64,
                block_size=16)
    snap, jsnap = metrics.snapshot(), jmetrics.snapshot()
    assert snap["serving.admissions"]["series"][0]["value"] == 1
    assert snap["serving.tokens_out"]["series"][0]["value"] == 4
    assert snap["serving.ticks"]["series"][0]["value"] >= 1
    assert "serving.pool_occupancy" in snap
    assert "serving.tokens_per_sec" in snap
    assert _counter_series(snap) == _counter_series(jsnap)
    # the same series of the same instruments (values aside: seconds)
    names = {n for n in jsnap if n.startswith("serving.")}
    assert {n for n in snap if n.startswith("serving.")} == names
    doc = json.loads(metrics.export_json(str(tmp_path / "m.json")))
    assert doc["metrics"]["serving.tokens_out"]["series"][0]["value"] == 4
    # the counters' Prometheus lines are the JAX engine's
    lines = [ln for ln in export.render_prometheus().splitlines()
             if ln.startswith(("serving_admissions", "serving_tokens_out",
                               "serving_ticks ", "serving_ttft_seconds_count",
                               "serving_request_outcomes"))]
    jlines = [ln for ln in jexport.render_prometheus().splitlines()
              if ln.startswith(("serving_admissions", "serving_tokens_out",
                                "serving_ticks ",
                                "serving_ttft_seconds_count",
                                "serving_request_outcomes"))]
    assert lines == jlines and len(lines) >= 5


def test_serving_rejection_metrics(models):
    jm, tm = models
    for mod, eng_cls, req_cls, model, kw in (
            (metrics, ServingEngine, Request, tm, dict(device="cpu")),
            (jmetrics, JaxEngine, JaxRequest, jm, {})):
        eng = eng_cls(model, max_batch=1, max_context=32, block_size=16,
                      **kw)
        with pytest.raises(ValueError):
            eng.add_request(req_cls(np.arange(1, 30), max_new_tokens=16))
        rej = mod.get("serving.rejections")
        assert rej.value(reason="over_context") == 1
        eng2 = eng_cls(model, max_batch=1, max_context=64, block_size=16,
                       num_blocks=2, **kw)
        with pytest.raises(ValueError):
            eng2.add_request(req_cls(np.arange(1, 17), max_new_tokens=40))
        assert rej.value(reason="capacity") == 1
        assert eng2.telemetry_snapshot()["outcomes"] == \
            {"rejected:capacity": 1}
    assert metrics.get("serving.request_outcomes").value(
        outcome="rejected:over_context") == 1
    recs = export.recent_requests()
    assert [r["outcome"] for r in recs] == ["rejected:over_context",
                                           "rejected:capacity"]


# --------------------------------------------------- the flight recorder

def test_flight_dump_carries_the_registry(tmp_path):
    metrics.counter("t.flight").inc(3)
    rec = flight_recorder.FlightRecorder(capacity=4)
    rec.record_step({"step": 1})
    rec.record_span("plan", "router", 1.0, 1.5, trace_id="ab" * 8)
    doc = rec.dump(str(tmp_path / "f.json"))
    assert doc["metrics"]["t.flight"]["series"][0]["value"] == 3
    assert doc["metrics"] == json.loads((tmp_path / "f.json").read_text())[
        "metrics"]
    assert doc["events"][0]["kind"] == "span"
    assert doc["events"][0]["dur_s"] == 0.5
    # the JAX recorder's span event, field for field
    jrec = jflight.FlightRecorder(capacity=4)
    jrec.record_span("plan", "router", 1.0, 1.5, trace_id="ab" * 8)
    assert {k: v for k, v in jrec.events()[0].items() if k != "unix_time"} \
        == {k: v for k, v in doc["events"][0].items() if k != "unix_time"}
    rec.clear()
    assert rec.steps() == [] and rec.events() == []


def test_engines_with_their_own_recorders_do_not_interleave(models):
    _, tm = models
    recs = [flight_recorder.FlightRecorder(capacity=256) for _ in range(2)]
    default = flight_recorder.default_recorder()
    default.clear()
    engs = [ServingEngine(tm, device="cpu", max_batch=2, max_context=64,
                          block_size=16, prefill_chunk=8, flight_recorder=r)
            for r in recs]
    rng = np.random.RandomState(3)
    reqs = [[e.add_request(Request(rng.randint(1, 500, (20,)),
                                   max_new_tokens=4)) for _ in range(2)]
            for e in engs]
    # the two engines take turns, boundary by boundary
    while any(e.step() for e in engs):
        pass
    for rec, rs in zip(recs, reqs):
        rids = {r.rid for r in rs}
        events = rec.events()
        assert {e["rid"] for e in events if e["kind"] == "request"} == rids
        assert {e["rid"] for e in events
                if e["kind"] == "prefill_chunk"} == rids
        assert all(s["timeline"] == "serving" for s in rec.steps())
        assert sum(s.get("prefill_chunks", 0) for s in rec.steps()) == 6
    assert not [e for e in default.events()
                if e["kind"] in ("request", "prefill_chunk")]
    assert not default.steps()


# ------------------------------------------------------------ the HTTP

def test_http_endpoint_smoke():
    c = metrics.counter("t.http_smoke", "known counter")
    c.inc(7, kind="x")
    export.record_request({"rid": 1, "outcome": "finished",
                           "ttft_s": 0.01})
    srv = obs_http.serve(0)
    try:
        assert srv.port > 0 and srv.host == "127.0.0.1"
        r = urllib.request.urlopen(srv.url + "/metrics", timeout=10)
        assert r.status == 200
        assert r.headers["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        body = r.read().decode()
        assert 't_http_smoke{kind="x"} 7' in body
        r = urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        assert r.headers["Content-Type"] == "application/json"
        doc = json.loads(r.read())
        assert doc["ok"] is True and doc["pid"] == os.getpid()
        r = urllib.request.urlopen(srv.url + "/requests?n=5", timeout=10)
        reqs = json.loads(r.read())
        assert reqs and reqs[-1]["rid"] == 1
        assert reqs[-1]["outcome"] == "finished"
        assert json.loads(urllib.request.urlopen(
            srv.url + "/requests?n=0", timeout=10).read()) == []
        snap = json.loads(urllib.request.urlopen(
            srv.url + "/metrics/snapshot", timeout=10).read())
        assert snap["registry"]["t.http_smoke"]["series"] == [
            {"labels": [["kind", "x"]], "value": 7.0}]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url + "/nope", timeout=10)
        assert urllib.request.urlopen(srv.url + "/healthz",
                                      timeout=10).status == 200
        assert obs_http.serve(0) is srv
    finally:
        obs_http.stop()
    assert obs_http.current() is None


def test_healthz_is_a_readiness_probe():
    class _Stub:
        def __init__(self):
            self.doc = {"ready": False, "reason": "warmup"}

        def health(self):
            return self.doc

    stub = _Stub()
    srv = obs_http.serve(0)
    try:
        obs_http.attach_engine(stub)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        assert ei.value.code == 503
        doc = json.loads(ei.value.read())
        assert doc["ready"] is False and doc["reason"] == "warmup"
        assert doc["ok"] is True
        stub.doc = {"ready": True, "queue_depth": 3, "running": 1,
                    "waiting": 2, "uptime_s": 1.5,
                    "warmup": {"warmup_s": 0.2, "programs": 7}}
        r = urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        assert r.status == 200
        doc = json.loads(r.read())
        assert doc["ready"] is True and doc["queue_depth"] == 3
        assert doc["warmup"]["programs"] == 7
        obs_http.attach_engine(None)
        doc = json.loads(urllib.request.urlopen(
            srv.url + "/healthz", timeout=10).read())
        assert doc["ok"] is True and "ready" not in doc
    finally:
        obs_http.attach_engine(None)
        obs_http.stop()


def test_start_is_gated_by_the_ports():
    assert obs_http.start_metrics(0) is None
    assert obs_http.start_serving(0) is None
    assert obs_http.current() is None and obs_http.serving_server() is None


def test_engine_ports_start_the_endpoints(models):
    """``metrics_port`` and ``http_port``: ``run()`` starts the scrape and
    serve endpoints on loopback and attaches the engine."""
    import socket
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    _, tm = models
    eng = ServingEngine(tm, device="cpu", max_batch=2, max_context=64,
                        block_size=16, metrics_port=ports[0],
                        http_port=ports[1])
    try:
        eng.add_request(Request(np.arange(1, 9), max_new_tokens=4))
        eng.run()
        assert obs_http.current().port == ports[0]
        assert obs_http.serving_server().port == ports[1]
        assert obs_http.serving_server().host == "127.0.0.1"
        assert obs_http.current_engine() is eng
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{ports[0]}/metrics",
            timeout=10).read().decode()
        assert 'serving_ttft_seconds{quantile="0.5"}' in body
        assert "serving_ttft_seconds_count 1" in body
        assert "serving_queue_depth 0" in body
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{ports[1]}/healthz", timeout=10).read())
        assert doc["ready"] is True
        snap = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{ports[0]}/metrics/snapshot",
            timeout=10).read())
        assert snap["engine"]["outcomes"] == {"finished": 1}
        assert snap["engine"]["tpot_sketch"]["count"] == 3
    finally:
        obs_http.stop()
