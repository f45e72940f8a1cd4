"""Flight recorder: a bounded ring of recent step records and events, and
a NaN/Inf watchdog that turns a dying run into a JSON post-mortem.

Counterpart of ``paddle_tpu/observability/flight_recorder.py``.  The last
K step records and named events are kept in memory (deque appends) and
dumped to a JSON document on demand (``default_recorder().dump(path)``),
on an exception inside an instrumented region (:class:`guard`) or when
the watchdog trips (:func:`check_finite` records which site first went
non-finite).

The watchdog is the JAX flag ``enable_nan_watchdog``: process-wide, off
by default, set here with :func:`set_enabled`.  Off, :func:`check_finite`
and :class:`guard` are one boolean check and never touch their value (no
host sync); on, each check reads its value on the host.  A dump carries
the metrics registry's snapshot (``"metrics"``).  A serving engine writes
into the recorder it was given (``ServingEngine(flight_recorder=)``), the
process's default one otherwise: engines that share a process keep their
rings apart.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import metrics as _metrics

__all__ = ["FlightRecorder", "default_recorder", "check_finite", "guard",
           "enabled", "set_enabled", "FLIGHT_SCHEMA"]

FLIGHT_SCHEMA = "paddle_tpu_torch.flight/v1"
CAPACITY = 64                  # the JAX flag flight_recorder_steps' default
DUMP_DIR = "flight_dumps"      # unattended dumps, relative to the cwd

_ENABLED = False


def enabled() -> bool:
    return _ENABLED


def set_enabled(value: bool) -> bool:
    """Turn the NaN/Inf watchdog on or off for the process; returns the
    previous setting."""
    global _ENABLED
    old, _ENABLED = _ENABLED, bool(value)
    return old


class FlightRecorder:
    """Bounded in-memory evidence; ``dump()`` is the readout.
    ``record_step`` keeps its dict by reference, so a caller may annotate
    the last record after the fact."""

    def __init__(self, capacity: int = CAPACITY):
        self._lock = threading.Lock()
        self.first_nonfinite: Optional[Dict[str, Any]] = None
        self.dump_count = 0
        self.capacity = max(int(capacity), 1)
        self._steps: deque = deque(maxlen=self.capacity)
        self._events: deque = deque(maxlen=self.capacity)

    def record_step(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._steps.append(record)

    def record_event(self, kind: str, **info) -> None:
        with self._lock:
            self._events.append(dict(info, kind=kind,
                                     unix_time=round(time.time(), 3)))

    def record_span(self, name: str, cat: str, start_s: float,
                    end_s: float, **info) -> None:
        """One completed span as a ``kind="span"`` event: explicit start
        and end unix seconds (the chrome exporter draws a slice on a row
        per ``cat``), plus any trace context."""
        self.record_event("span", name=name, cat=cat,
                          start_s=round(float(start_s), 6),
                          end_s=round(float(end_s), 6),
                          dur_s=round(float(end_s) - float(start_s), 6),
                          **info)

    def note_nonfinite(self, site: str, step: Optional[int] = None,
                       value: Optional[float] = None) -> bool:
        """Record a non-finite observation; only the first of a run is
        kept as ``first_nonfinite``.  True when this call was the first."""
        with self._lock:
            first = self.first_nonfinite is None
            if first:
                self.first_nonfinite = {
                    "site": site, "step": step, "value": repr(value),
                    "unix_time": round(time.time(), 3)}
        self.record_event("nonfinite", site=site, step=step,
                          value=repr(value))
        return first

    def steps(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._steps)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._steps.clear()
            self._events.clear()
            self.first_nonfinite = None

    def snapshot(self, reason: str = "manual") -> Dict[str, Any]:
        return {"schema": FLIGHT_SCHEMA,
                "unix_time": round(time.time(), 3),
                "pid": os.getpid(), "reason": reason,
                "capacity": self.capacity,
                "first_nonfinite": self.first_nonfinite,
                "steps": self.steps(), "events": self.events(),
                "metrics": _metrics.snapshot()}

    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> Dict[str, Any]:
        """Write the snapshot as JSON (when ``path`` is given); return it."""
        doc = self.snapshot(reason)
        if path is not None:
            dirname = os.path.dirname(path)
            if dirname:
                os.makedirs(dirname, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, indent=1, default=repr)
        return doc


_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def default_recorder() -> FlightRecorder:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = FlightRecorder()
    return _default


def _auto_dump(rec: FlightRecorder, reason: str) -> Optional[str]:
    """An unattended dump (a watchdog trip, an exception) into
    ``DUMP_DIR``; never raises."""
    rec.dump_count += 1
    tag = "".join(c if c.isalnum() or c in "-_" else "_"
                  for c in reason)[:48]
    path = os.path.join(
        DUMP_DIR, f"flight_{tag}_{os.getpid()}_{rec.dump_count}.json")
    try:
        rec.dump(path, reason)
        return path
    except Exception:  # noqa: BLE001 - evidence is best-effort
        return None


def check_finite(value, site: str, step: Optional[int] = None,
                 recorder: Optional[FlightRecorder] = None) -> bool:
    """The watchdog's probe.  Off: True without touching ``value``.  On:
    ``float(value)``; a NaN/Inf records the site and step (the first trip
    also writes a dump) and returns False."""
    if not _ENABLED:
        return True
    try:
        v = float(value)
    except (TypeError, ValueError):     # not a scalar: not checkable
        return True
    if math.isfinite(v):
        return True
    rec = recorder if recorder is not None else default_recorder()
    if rec.note_nonfinite(site, step, v):
        _auto_dump(rec, reason=f"nonfinite_{site}")
    return False


class guard:
    """Context manager: an exception inside the region is recorded and,
    with the watchdog on, dumped before it propagates."""

    __slots__ = ("site",)

    def __init__(self, site: str):
        self.site = site

    def __enter__(self) -> "guard":
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        if exc is not None and _ENABLED and not isinstance(
                exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
            rec = default_recorder()
            rec.record_event("exception", site=self.site,
                             error=f"{type(exc).__name__}: {exc}"[:300])
            _auto_dump(rec, reason=f"exception_{self.site}")
        return False
