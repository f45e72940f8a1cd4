"""chrome://tracing export of serving flight documents.

Counterpart of ``paddle_tpu/observability/chrome.py``:
:func:`trace_from_flight` converts a flight-recorder document (the
in-memory snapshot or a ``flight_*.json`` dump) into a chrome://tracing
JSON object; load it at ``chrome://tracing`` or in Perfetto.

Rows (tids under one "serving" process group):

* **ticks** — one slice per flight-record tick (``t_unix`` - ``wall_s``
  .. ``t_unix``) with its phase breakdown nested underneath: schedule /
  chunk-prefill / dispatch laid out from the tick's start (their
  dispatch-time order), harvest-wait + emit ending at the harvest.
  Phases are host brackets: device work overlaps them by design, so the
  gap between dispatch and harvest-wait is the overlap the
  double-buffered loop buys.
* **request <rid>** — one row per finished request, reconstructed from
  its lifecycle record (enqueue = finish - ``e2e_s``): the whole request
  span with queue-wait / prefill / decode children, plus an instant
  marker per prefill chunk event.
* **spans** — one row per span category for explicit ``kind="span"``
  flight events; each slice keeps its ``trace_id`` in args.

Timestamps are wall-clock unix seconds scaled to microseconds, so tick
and request rows share one timeline.  For multi-process merges
(:func:`..tracing.fleet_trace`) callers pass a distinct ``pid`` per
process, a ``process_name`` label and a ``clock_offset_s`` shift into the
merge's common timebase.  Records missing their timing fields (the
metrics gate off at record time) are skipped, not guessed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["trace_from_flight"]

_TICK_TID = 0


def trace_from_flight(doc: Dict[str, Any], *, pid: int = 1,
                      clock_offset_s: float = 0.0,
                      process_name: Optional[str] = None) -> Dict[str, Any]:
    """A flight-recorder document -> chrome://tracing JSON object."""

    def _x(name: str, cat: str, start_s: float, dur_s: float, tid: int,
           args: Dict[str, Any] = None) -> Dict[str, Any]:
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round((start_s + clock_offset_s) * 1e6, 3),
              "dur": round(max(dur_s, 0.0) * 1e6, 3),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        return ev

    def _thread_name(tid: int, name: str) -> Dict[str, Any]:
        return {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name}}

    def _tick_events(rec: Dict[str, Any]) -> List[Dict[str, Any]]:
        end = float(rec["t_unix"])
        wall = float(rec.get("wall_s", 0.0))
        start = end - wall
        args = {k: rec[k] for k in ("tokens", "active", "decode_steps",
                                    "overlap", "spec_k", "spec_kind",
                                    "prefill_chunks") if k in rec}
        out = [_x(f"tick {rec.get('step')}", "tick", start, wall,
                  _TICK_TID, args)]
        ph = rec.get("phases")
        if not ph:
            return out
        ms = lambda k: float(ph.get(k, 0.0)) / 1e3  # noqa: E731
        # dispatch-time phases from the start, in their real order
        t = start
        for key, label in (("schedule_ms", "schedule"),
                           ("chunk_prefill_ms", "chunk_prefill"),
                           ("dispatch_ms", "dispatch")):
            d = ms(key)
            if d > 0:
                out.append(_x(label, "phase", t, d, _TICK_TID))
                t += d
        # harvest phases back from the end (the overlap gap sits between)
        emit, wait = ms("emit_ms"), ms("harvest_wait_ms")
        if wait > 0:
            out.append(_x("harvest_wait", "phase",
                          max(end - emit - wait, t), wait, _TICK_TID))
        if emit > 0:
            out.append(_x("emit", "phase", max(end - emit, t), emit,
                          _TICK_TID))
        return out

    events: List[Dict[str, Any]] = [_thread_name(_TICK_TID, "ticks")]
    if process_name:
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": process_name}})
    for rec in doc.get("steps", []) or []:
        if rec.get("timeline") == "serving" and "t_unix" in rec:
            events.extend(_tick_events(rec))
    # request rows: one tid per rid, finished lifecycles first, then
    # the chunk instants of any rid seen (mid-prefill casualties too)
    tids: Dict[Any, int] = {}

    def tid_of(rid) -> int:
        tid = tids.get(rid)
        if tid is None:
            tid = tids[rid] = len(tids) + 1
            events.append(_thread_name(tid, f"request {rid}"))
        return tid

    flight_events = doc.get("events", []) or []
    for e in flight_events:
        if e.get("kind") != "request" or e.get("outcome") != "finished" \
                or "e2e_s" not in e or "unix_time" not in e:
            continue
        rid = e.get("rid")
        tid = tid_of(rid)
        fin = float(e["unix_time"])
        e2e = float(e["e2e_s"])
        enq = fin - e2e
        qwait = float(e.get("queue_wait_s", 0.0))
        prefill = float(e.get("prefill_s", 0.0))
        first = enq + float(e.get("ttft_s", qwait + prefill))
        events.append(_x(f"request {rid}", "request", enq, e2e, tid,
                         {k: e[k] for k in ("prompt_len", "tokens_out",
                                            "ticks", "prefix_blocks",
                                            "prefill_chunks",
                                            "spec_accept_rate",
                                            "trace_id", "parent_span")
                          if k in e}))
        if qwait > 0:
            events.append(_x("queue_wait", "lifecycle", enq, qwait, tid))
        events.append(_x("prefill", "lifecycle", enq + qwait, prefill,
                         tid))
        events.append(_x("decode", "lifecycle", first,
                         max(fin - first, 0.0), tid))
    for e in flight_events:
        if e.get("kind") != "prefill_chunk" or "unix_time" not in e:
            continue
        events.append({
            "name": f"chunk@{e.get('start')}", "cat": "lifecycle",
            "ph": "i",
            "ts": round((float(e["unix_time"]) + clock_offset_s) * 1e6, 3),
            "pid": pid, "tid": tid_of(e.get("rid")), "s": "t",
            "args": {k: e[k] for k in ("tokens", "slot", "done")
                     if k in e}})
    # explicit span events: one row per span category, each
    # slice carrying its trace context in args
    span_tids: Dict[str, int] = {}
    for e in flight_events:
        if e.get("kind") != "span" or "start_s" not in e \
                or "end_s" not in e:
            continue
        cat = str(e.get("cat", "span"))
        tid = span_tids.get(cat)
        if tid is None:
            tid = span_tids[cat] = 1000 + len(span_tids)
            events.append(_thread_name(tid, cat))
        start = float(e["start_s"])
        dur = max(float(e["end_s"]) - start, 0.0)
        args = {k: e[k] for k in e
                if k not in ("kind", "cat", "name", "start_s", "end_s",
                             "dur_s", "unix_time")}
        events.append(_x(str(e.get("name", "span")), cat, start, dur,
                         tid, args or None))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": "paddle_tpu_torch.chrome_trace/v1",
                          "source": doc.get("schema"),
                          "pid": doc.get("pid"),
                          "reason": doc.get("reason")}}
