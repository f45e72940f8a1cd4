"""Cross-process request tracing.

Counterpart of ``paddle_tpu/observability/tracing.py``.  A request that
crosses processes (a router, then a replica) would leave flight-recorder
fragments with no shared id and no shared clock.  Three pieces join
them:

* **trace context** — a 16-hex ``trace_id`` minted once per ``/generate``
  plus an 8-hex per-hop ``span_id``, carried on the wire as the
  ``X-Graft-Trace: <trace_id>-<span_id>`` header and threaded into
  ``Request`` objects so every lifecycle / flight / handoff record tags
  itself with the same id;

* **clock alignment** — :class:`ClockSync` estimates a remote process's
  clock offset from a ``/healthz`` round-trip (the reply embeds the
  server's ``unix_time``).  The estimate is ``server_time - midpoint``
  of the round-trip with error bound ``rtt / 2``; the minimum-RTT sample
  wins, the classic NTP-style filter;

* **timeline merge** — :func:`fleet_trace` folds one flight dump per
  process into a single chrome://tracing document: each process becomes
  its own ``pid`` row group, replica clocks are shifted into router time
  using the recorded ``clock_sync`` events, and every span keeps its
  ``trace_id`` so chrome's flow highlighting follows one request across
  router, prefill engine and decode engine.

Everything here is stdlib-only and runs identically with metrics
disabled: minting an id is two ``os.urandom`` calls, and the header
parse is a regex match.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import chrome as _chrome

TRACE_HEADER = "X-Graft-Trace"

_TRACE_RE = re.compile(r"^[0-9a-f]{8,32}$")
_SPAN_RE = re.compile(r"^[0-9a-f]{4,16}$")


def mint_trace_id() -> str:
    """A fresh 16-hex trace id (64 random bits)."""
    return os.urandom(8).hex()


def new_span_id() -> str:
    """A fresh 8-hex span id (32 random bits)."""
    return os.urandom(4).hex()


def format_header(trace_id: str, span_id: Optional[str] = None) -> str:
    """Wire form of a trace context: ``trace_id`` or ``trace_id-span``."""
    if span_id:
        return f"{trace_id}-{span_id}"
    return trace_id


def parse_header(value: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """Parse an ``X-Graft-Trace`` header into ``(trace_id, parent_span)``.

    Accepts ``<trace>`` or ``<trace>-<span>`` where trace is 8-32 lowercase
    hex chars and span 4-16.  Anything malformed yields ``(None, None)`` —
    a bad header must never break request handling.
    """
    if not value or not isinstance(value, str):
        return None, None
    value = value.strip().lower()
    trace, sep, span = value.partition("-")
    if not _TRACE_RE.match(trace):
        return None, None
    if not sep:
        return trace, None
    if not _SPAN_RE.match(span):
        return trace, None
    return trace, span


class ClockSync:
    """Minimum-RTT clock-offset estimate for one remote process.

    ``update(t0, server_unix, t1)`` feeds one round-trip: local send time
    ``t0``, the server's self-reported ``unix_time``, local receive time
    ``t1``.  The offset estimate is ``server_unix - (t0 + t1) / 2`` and
    its error is bounded by half the round-trip; the sample with the
    smallest RTT is kept because its bound is tightest.
    """

    __slots__ = ("offset_s", "err_s", "rtt_s")

    def __init__(self) -> None:
        self.offset_s: Optional[float] = None
        self.err_s: Optional[float] = None
        self.rtt_s: Optional[float] = None

    def update(self, t0: float, server_unix: float, t1: float) -> bool:
        """Feed one round-trip; returns True if the estimate improved."""
        rtt = t1 - t0
        if rtt < 0:
            return False
        if self.rtt_s is not None and rtt >= self.rtt_s:
            return False
        self.rtt_s = rtt
        self.offset_s = server_unix - (t0 + t1) / 2.0
        self.err_s = rtt / 2.0
        return True

    def view(self) -> Dict[str, Optional[float]]:
        return {"offset_s": self.offset_s, "err_s": self.err_s,
                "rtt_s": self.rtt_s}


# ------------------------------------------------------- timeline merge


def _doc_process_name(doc: Dict[str, Any], fallback: str) -> str:
    """A flight doc self-identifies via its ``replica_meta`` event."""
    for ev in doc.get("events", ()):
        if ev.get("kind") == "replica_meta" and ev.get("replica"):
            return str(ev["replica"])
    return fallback


def _collect_offsets(docs: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    """Per-process clock offsets from ``clock_sync`` events.

    The router records one ``clock_sync`` event per replica poll with
    ``{replica, offset_s, err_s, rtt_s}``; the smallest-error estimate
    per replica wins (same min-RTT rule as :class:`ClockSync`).
    """
    best: Dict[str, Tuple[float, float]] = {}
    for doc in docs:
        for ev in doc.get("events", ()):
            if ev.get("kind") != "clock_sync":
                continue
            name = ev.get("replica")
            off = ev.get("offset_s")
            if name is None or off is None:
                continue
            err = float(ev.get("err_s") or 0.0)
            cur = best.get(name)
            if cur is None or err < cur[1]:
                best[str(name)] = (float(off), err)
    return {k: v[0] for k, v in best.items()}


def _collect_trace_ids(doc: Dict[str, Any]) -> List[str]:
    seen: List[str] = []
    for rec in list(doc.get("events", ())) + list(doc.get("steps", ())):
        tid = rec.get("trace_id")
        if tid and tid not in seen:
            seen.append(tid)
    return seen


def fleet_trace(docs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge flight dumps from several processes into one chrome trace.

    Each doc becomes its own chrome process (pid = position + 1) named
    after its ``replica_meta`` event (falling back to ``proc<i>``).
    Replica clocks are shifted into the first doc's (router's) timebase
    by subtracting the recorded ``clock_sync`` offset — the router
    measured ``offset = replica_clock - router_clock``, so replica
    timestamps move by ``-offset``.
    """
    offsets = _collect_offsets(docs)
    merged: List[Dict[str, Any]] = []
    processes: List[Dict[str, Any]] = []
    trace_ids: List[str] = []
    for i, doc in enumerate(docs):
        name = _doc_process_name(doc, f"proc{i}")
        off = offsets.get(name, 0.0)
        sub = _chrome.trace_from_flight(doc, pid=i + 1,
                                        clock_offset_s=-off,
                                        process_name=name)
        merged.extend(sub["traceEvents"])
        processes.append({"pid": i + 1, "name": name,
                          "clock_offset_s": round(off, 6),
                          "source_pid": doc.get("pid")})
        for tid in _collect_trace_ids(doc):
            if tid not in trace_ids:
                trace_ids.append(tid)
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": "paddle_tpu_torch.fleet_trace/v1",
            "processes": processes,
            "trace_ids": trace_ids,
        },
    }
