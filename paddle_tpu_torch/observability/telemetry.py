"""Step-level training telemetry: the StepTimeline.  Counterpart of
``paddle_tpu/observability/telemetry.py``.

A ``StepTimeline`` brackets each training step, diffs the registry's
streams across the bracket, and emits ONE schema-stable record per step
(the JAX package's keys, ``TELEMETRY_SCHEMA``) with

* wall seconds and the host gap since the previous step,
* compile seconds charged to this step: the ``compile.seconds``
  histogram's growth, which the port feeds with the time it spends
  building the CUDA kernels (``ops/_build.py``, first use) and capturing
  CUDA graphs (``inference/graphs.py``) inside the bracket,
* collective calls and bytes (``collective.calls`` / ``.bytes``; the port
  has no collectives yet, so on one card they read 0) and the estimated
  communication time,
* compute / comm / host fractions of the step period (they sum to 1),
* tokens/s and MFU from :mod:`.flops` (6N + 12LHS over the card's bf16
  peak, ``peak_flops(torch.cuda.get_device_name())``).

The wall time is the host's: a record is an upper bound on tokens/s
unless the caller synchronised inside the bracket and says so
(``annotate(synced=True)``).  Every record also goes to the flight
recorder's ring (:mod:`.flight_recorder`).  ``summary()`` aggregates the
steps (steady state = steps without compile time).  With the metrics gate
off (``metrics.set_enabled(False)``) a bracket is a shared no-op.

Usage::

    from paddle_tpu_torch.observability import telemetry

    tl = telemetry.StepTimeline(flops_per_token=model.flops_per_token(S),
                                device_kind=torch.cuda.get_device_name())
    for batch in loader:
        with tl.step(tokens=B * S) as st:
            loss = train_step(batch)
        st.annotate(loss=float(loss))
    print(tl.summary())
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from . import flops as _flops
from . import metrics as _metrics
from . import flight_recorder as _fr

__all__ = ["StepTimeline", "default_timeline", "TELEMETRY_SCHEMA",
           "observe_compile"]

TELEMETRY_SCHEMA = "paddle_tpu_torch.telemetry/v1"

# Payload bandwidth for the comm-time estimate: NVLink 4, 450 GB/s each
# way between the cards of an H100 host (NVIDIA's data sheet).
_DEFAULT_LINK_BW = 450e9

# the port's compile time: kernel builds and CUDA graph captures
_COMPILE_SECONDS = _metrics.histogram(
    "compile.seconds",
    "time spent building kernels and capturing CUDA graphs "
    "(what=kernel_build|graph_capture)")


def observe_compile(what: str, seconds: float) -> None:
    """Charge ``seconds`` of kernel building or graph capture to the step
    in progress (``compile_s``)."""
    _COMPILE_SECONDS.observe(seconds, what=what)


def _counter_total(name: str) -> float:
    m = _metrics.get(name)
    return m.total() if isinstance(m, _metrics.Counter) else 0.0


def _hist_totals(name: str):
    m = _metrics.get(name)
    if isinstance(m, _metrics.Histogram):
        return m.total_count(), m.total_sum()
    return 0, 0.0


class _NullStep:
    """The disabled-metrics bracket: every operation is a no-op."""

    __slots__ = ()
    tokens = 0
    loss = None
    index = -1
    synced = False

    def annotate(self, **kv) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NullStep":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setattr__(self, name, value):  # tolerate `st.tokens = n` callers
        pass


_NULL_STEP = _NullStep()


class _Step:
    """One open step bracket; `end()` (or context exit) seals the record.

    ``synced`` marks that the caller forced a host materialization inside
    the bracket: on async backends an unsynced record's ``wall_s`` is
    ENQUEUE time (the device may still be running), so readers must treat
    tokens/sec and MFU from unsynced records as upper bounds.
    """

    __slots__ = ("_tl", "index", "tokens", "loss", "mode", "synced",
                 "_t0", "_gap_s", "_compile0", "_bytes0", "_calls0",
                 "_record", "_pending")

    def __init__(self, tl: "StepTimeline", index: int, tokens: int,
                 mode: Optional[str]):
        self._tl = tl
        self.index = index
        self.tokens = tokens
        self.loss: Optional[float] = None
        self.mode = mode
        self.synced = False
        self._pending: Dict[str, Any] = {}
        self._record: Optional[Dict[str, Any]] = None
        now = time.perf_counter()
        self._gap_s = (now - tl._last_end) if tl._last_end is not None else 0.0
        _, self._compile0 = _hist_totals("compile.seconds")
        self._bytes0 = _counter_total("collective.bytes")
        self._calls0 = _counter_total("collective.calls")
        self._t0 = now

    def annotate(self, **kv) -> None:
        """Attach late measurements (loss lands after the step returns);
        before `end()` they seed the record, after it they update it in
        place — the flight ring holds the same dict, so dumps see them.
        Recording only: the NaN/Inf watchdog probe is the CALLER's
        `flight_recorder.check_finite`, which stays armed even when the
        metrics registry (and with it this timeline) is disabled."""
        if self._record is not None:
            self._record.update(kv)
            return
        for k, v in kv.items():
            if k in ("tokens", "loss", "mode", "synced"):
                setattr(self, k, v)
            else:
                # custom annotations (grad_norm, lr, ...) made inside
                # the bracket merge into the record when it seals
                self._pending[k] = v

    def end(self) -> Optional[Dict[str, Any]]:
        if self._record is not None:
            return self._record
        t1 = time.perf_counter()
        tl = self._tl
        tl._last_end = t1
        wall = max(t1 - self._t0, 1e-9)
        _, compile1 = _hist_totals("compile.seconds")
        compile_s = max(compile1 - self._compile0, 0.0)
        comm_bytes = max(_counter_total("collective.bytes") - self._bytes0, 0)
        comm_calls = max(_counter_total("collective.calls") - self._calls0, 0)
        comm_est = comm_bytes / tl.ici_bandwidth if tl.ici_bandwidth else 0.0
        # fractions over the step PERIOD (gap + wall): host = data/input
        # gap + compile attributed to this step; comm = the analytic
        # estimate; compute = the remainder.  Clamped so they sum to 1.
        period = wall + self._gap_s
        host_s = min(self._gap_s + compile_s, period)
        comm_s = min(comm_est, period - host_s)
        compute_s = period - host_s - comm_s
        tps = self.tokens / wall if self.tokens else 0.0
        rec: Dict[str, Any] = {
            "schema": TELEMETRY_SCHEMA,
            "timeline": tl.name,
            "step": self.index,
            "wall_s": round(wall, 6),
            "gap_s": round(self._gap_s, 6),
            "compile_s": round(compile_s, 6),
            "comm_bytes": comm_bytes,
            "comm_calls": comm_calls,
            "comm_s_est": round(comm_s, 6),
            "tokens": self.tokens,
            "tokens_per_sec": round(tps, 1),
            "synced": bool(self.synced),
            "loss": self.loss,
            "fractions": {
                "compute": round(compute_s / period, 4),
                "comm": round(comm_s / period, 4),
                "host": round(host_s / period, 4),
            },
        }
        if self.mode is not None:
            rec["mode"] = self.mode
        if tl.flops_per_token and tl.peak_flops and self.tokens:
            rec["mfu"] = round(_flops.mfu(tps, tl.flops_per_token,
                                          peak=tl.peak_flops), 4)
        rec.update(self._pending)
        self._record = rec
        tl._append(rec)
        return rec

    def __enter__(self) -> "_Step":
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        # a raising step still seals its record (partial evidence beats
        # none — the flight dump shows how far the step got)
        self.end()
        return False


class StepTimeline:
    """Per-step telemetry aggregator (see module docstring)."""

    def __init__(self, name: str = "train",
                 flops_per_token: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 device_kind: Optional[str] = None,
                 max_steps: int = 512,
                 ici_bandwidth: float = _DEFAULT_LINK_BW,
                 recorder: Optional[_fr.FlightRecorder] = None):
        self.name = name
        self.flops_per_token = flops_per_token
        if peak_flops is None and device_kind is not None:
            peak_flops = _flops.peak_flops(device_kind)
        self.peak_flops = peak_flops
        self.device_kind = device_kind
        self.max_steps = max(int(max_steps), 1)
        self.ici_bandwidth = ici_bandwidth
        self._recorder = recorder
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []
        self._count = 0
        self._last_end: Optional[float] = None

    def configure(self, *, flops_per_token: Optional[float] = None,
                  peak_flops: Optional[float] = None,
                  device_kind: Optional[str] = None) -> "StepTimeline":
        """Late-bind the MFU inputs (the model/device are often known
        only after the timeline's consumers started feeding it)."""
        if flops_per_token is not None:
            self.flops_per_token = flops_per_token
        if device_kind is not None:
            self.device_kind = device_kind
            if peak_flops is None:
                peak_flops = _flops.peak_flops(device_kind)
        if peak_flops is not None:
            self.peak_flops = peak_flops
        return self

    # ------------------------------------------------------------ recording
    def step(self, tokens: int = 0, mode: Optional[str] = None):
        """Open a step bracket (context manager or explicit ``end()``).
        Returns a shared no-op object when metrics are disabled."""
        if not _metrics.enabled():
            return _NULL_STEP
        with self._lock:
            idx = self._count
            self._count += 1
        return _Step(self, idx, tokens, mode)

    def _append(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._records.append(rec)
            del self._records[:-self.max_steps]
        recorder = self._recorder if self._recorder is not None \
            else _fr.default_recorder()
        recorder.record_step(rec)

    def annotate_last(self, **kv) -> Optional[Dict[str, Any]]:
        """Update the newest sealed record in place (loss etc. arriving
        after the bracket closed); returns that record so callers can
        anchor watchdog probes to its step index.  Recording only — the
        NaN/Inf probe is the caller's `check_finite`, kept independent
        of the metrics gate."""
        with self._lock:
            rec = self._records[-1] if self._records else None
        if rec is None:
            return None
        rec.update(kv)
        return rec

    # -------------------------------------------------------------- readout
    @property
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._count = 0
            self._last_end = None

    def summary(self) -> Dict[str, Any]:
        """Aggregate the recorded steps: step-seconds stats, weighted
        fractions, steady-state tokens/sec and MFU (steady = steps with
        no compile charged, falling back to all steps)."""
        recs = self.records
        if not recs:
            # schema-stable zeros: a metrics-off run (the timeline is a
            # no-op) must not KeyError consumers reading the summary
            return {"schema": TELEMETRY_SCHEMA, "timeline": self.name,
                    "steps": 0, "steady_steps": 0, "synced_steps": 0,
                    "wall_s": 0.0,
                    "compile_s": 0.0, "comm_bytes": 0, "tokens": 0,
                    "tokens_per_sec": 0.0,
                    "step_seconds": {"mean": 0.0, "min": 0.0, "max": 0.0,
                                     "p50": 0.0},
                    "fractions": {"compute": 0.0, "comm": 0.0,
                                  "host": 0.0},
                    "loss_last": None}
        steady = [r for r in recs if r["compile_s"] < 1e-3] or recs
        walls = sorted(r["wall_s"] for r in steady)
        n = len(walls)
        period = sum(r["wall_s"] + r["gap_s"] for r in recs) or 1e-9
        frac = {k: round(sum(r["fractions"][k] * (r["wall_s"] + r["gap_s"])
                             for r in recs) / period, 4)
                for k in ("compute", "comm", "host")}
        tokens = sum(r["tokens"] for r in steady)
        wall_steady = sum(walls) or 1e-9
        tps = tokens / wall_steady
        out: Dict[str, Any] = {
            "schema": TELEMETRY_SCHEMA,
            "timeline": self.name,
            "steps": len(recs),
            "steady_steps": n,
            # async-step attribution: an unsynced record's wall_s is
            # ENQUEUE time (flag-spaced loss sync leaves the loss on
            # device), so tokens/sec from a mostly-unsynced timeline is
            # an upper bound — this count is the caveat's denominator
            "synced_steps": sum(1 for r in recs if r.get("synced")),
            "wall_s": round(sum(r["wall_s"] for r in recs), 6),
            "compile_s": round(sum(r["compile_s"] for r in recs), 6),
            "step_seconds": {"mean": round(wall_steady / n, 6),
                             "min": round(walls[0], 6),
                             "max": round(walls[-1], 6),
                             "p50": round(walls[n // 2], 6)},
            "comm_bytes": sum(r["comm_bytes"] for r in recs),
            "tokens": tokens,
            "tokens_per_sec": round(tps, 1),
            "fractions": frac,
            "loss_last": next((r["loss"] for r in reversed(recs)
                               if r.get("loss") is not None), None),
        }
        if self.flops_per_token and self.peak_flops:
            out["flops_per_token"] = self.flops_per_token
            out["peak_flops"] = self.peak_flops
            out["mfu"] = round(_flops.mfu(tps, self.flops_per_token,
                                          peak=self.peak_flops), 4)
        rec = self._recorder if self._recorder is not None \
            else _fr.default_recorder()
        if rec.first_nonfinite is not None:
            out["first_nonfinite"] = dict(rec.first_nonfinite)
        return out


# The process-default timeline; chip_smoke.py and tests build their own.
_default: Optional[StepTimeline] = None
_default_lock = threading.Lock()


def default_timeline() -> StepTimeline:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = StepTimeline(name="train")
    return _default
