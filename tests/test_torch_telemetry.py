"""The port's StepTimeline against the JAX package's, on the CPU.

The record's keys and ``summary()``'s keys equal the JAX package's, with
MFU and without, with a mode and custom annotations; the null bracket
when the metrics gate is off; ``compile_s`` from the time the port
spends building kernels and capturing graphs inside a step; ``comm_*`` at
0 on one card; every record in the flight recorder's ring.  Numbers are
host-clock numbers of this CPU and only their relations are checked.
"""

import pytest
import torch

from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import telemetry as jtel
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import flops as tflops
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import telemetry as ttel


@pytest.fixture
def registries():
    jmetrics.reset()
    tmetrics.reset()
    jfr.default_recorder().clear()
    tfr.default_recorder().clear()
    yield
    jmetrics.set_enabled(True)
    tmetrics.set_enabled(True)
    jmetrics.reset()
    tmetrics.reset()


def _steps(mod, n=3, **kw):
    tl = mod.StepTimeline(**kw)
    for i in range(n):
        with tl.step(tokens=64, mode="train" if i else None) as st:
            st.annotate(lr=0.1 * i)
        st.annotate(loss=1.0 / (i + 1))
    return tl


@pytest.mark.parametrize("mfu", [False, True])
def test_record_and_summary_keys_equal_jax(registries, mfu):
    kw = dict(flops_per_token=1e9, peak_flops=1e14) if mfu else {}
    t, j = _steps(ttel, **kw), _steps(jtel, **kw)
    for tr, jr in zip(t.records, j.records):
        assert set(tr) == set(jr)
        assert set(tr["fractions"]) == set(jr["fractions"])
        assert tr["step"] == jr["step"] and tr["tokens"] == jr["tokens"]
        assert tr["loss"] == jr["loss"] and tr["lr"] == jr["lr"]
        assert tr.get("mode") == jr.get("mode")
        assert abs(sum(tr["fractions"].values()) - 1.0) < 1e-3
    ts, js = t.summary(), j.summary()
    assert set(ts) == set(js)
    assert set(ts["step_seconds"]) == set(js["step_seconds"])
    assert ts["steps"] == js["steps"] == 3 and ts["tokens"] == js["tokens"]
    assert ts["loss_last"] == js["loss_last"]
    assert ttel.TELEMETRY_SCHEMA.endswith("telemetry/v1")
    if mfu:
        r = t.records[-1]
        assert r["mfu"] == pytest.approx(
            r["tokens_per_sec"] * 1e9 / 1e14, rel=1e-3, abs=1e-4)


def test_empty_and_disabled_timelines_equal_jax(registries):
    assert set(ttel.StepTimeline().summary()) == \
        set(jtel.StepTimeline().summary())
    tmetrics.set_enabled(False)
    jmetrics.set_enabled(False)
    t, j = ttel.StepTimeline(), jtel.StepTimeline()
    ts, js = t.step(tokens=8), j.step(tokens=8)
    assert type(ts).__name__ == type(js).__name__ == "_NullStep"
    with ts as st:
        st.annotate(loss=1.0)
        st.tokens = 5                          # tolerated, ignored
    assert ts.end() is None and t.records == []
    assert t.summary()["steps"] == 0


def test_compile_seconds_comm_and_the_flight_ring(registries):
    """A kernel build or graph capture inside the bracket is its
    compile_s, and makes the step unsteady; no collectives: comm 0."""
    tl = ttel.StepTimeline(name="cut")
    with tl.step(tokens=10):
        ttel.observe_compile("kernel_build", 0.25)
        ttel.observe_compile("graph_capture", 0.5)
    with tl.step(tokens=10):
        pass
    first, second = tl.records
    assert first["compile_s"] == pytest.approx(0.75)
    assert second["compile_s"] == 0.0
    assert first["fractions"]["host"] > 0
    assert first["comm_bytes"] == 0 and first["comm_calls"] == 0
    assert first["comm_s_est"] == 0.0
    s = tl.summary()
    assert s["steady_steps"] == 1 and s["compile_s"] == pytest.approx(0.75)
    ring = tfr.default_recorder().steps()
    assert [r["step"] for r in ring[-2:]] == [0, 1]
    assert ring[-1] is second
    assert tl.annotate_last(loss=2.0)["loss"] == 2.0
    tl.reset()
    assert tl.records == [] and tl.summary()["steps"] == 0


def test_mfu_reads_the_card_peak_and_the_default_timeline(registries):
    assert tflops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tflops.peak_flops(None) == 2e12
    assert tflops.mfu(1000.0, 1e9, peak=1e12) == 1.0
    tl = ttel.StepTimeline(flops_per_token=2e9,
                           device_kind="NVIDIA H100 80GB HBM3")
    assert tl.peak_flops == 989e12
    tl.configure(flops_per_token=3e9, device_kind="cpu")
    assert tl.flops_per_token == 3e9 and tl.peak_flops == 2e12
    assert ttel.default_timeline() is ttel.default_timeline()
    assert ttel.default_timeline().name == jtel.default_timeline().name


def test_a_training_loop_records_every_step(registries):
    """The tiny GPT's train step on the CPU, one record per step with its
    loss, the step synchronised (the CPU has nothing to wait for)."""
    model = GPTForCausalLM(gpt3_tiny(), device="cpu")
    opt = toptim.AdamW(learning_rate=1e-3,
                       parameters=model.named_parameters())
    tl = ttel.StepTimeline(flops_per_token=model.flops_per_token(16))
    ids = torch.randint(0, 1024, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    for _ in range(3):
        with tl.step(tokens=ids.numel()) as st:
            loss = model.compute_loss(ids, ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            st.annotate(loss=loss.item(), synced=True)
    recs = tl.records
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(r["synced"] and r["tokens_per_sec"] > 0 for r in recs)
    assert recs[-1]["loss"] < recs[0]["loss"]
    assert tl.summary()["synced_steps"] == 3
