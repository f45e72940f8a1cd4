"""Scrape and serve endpoint: a stdlib HTTP daemon serving ``/metrics``,
``/metrics/snapshot``, ``/healthz``, ``/requests``, a streaming
``POST /generate`` and ``POST /drain``.

Counterpart of ``paddle_tpu/observability/http.py``.  One
``http.server.ThreadingHTTPServer`` on a daemon thread; nothing on the
serving loop's path (a handler reads the registry under its locks, as
``snapshot()`` does).  Handler threads never touch torch: ``/generate``
enqueues a request and reads the token queue the engine loop fills at its
harvests.

* ``GET /metrics`` — the registry in Prometheus text exposition format
  (:func:`.export.render_prometheus`), ``text/plain; version=0.0.4``.
* ``GET /metrics/snapshot`` — the registry's mergeable state and the
  engine's always-on evidence (:func:`.export.local_snapshot`).
* ``GET /healthz`` — liveness JSON; with a serving engine attached, its
  ``health()`` document and 503 while it warms up or drains.
* ``GET /requests`` — the last request trace records (``?n=``, default
  64).
* ``POST /generate`` — a JSON body (``prompt_ids`` and the ``Request``
  sampling arguments, ``priority``, ``timeout_s``) answered as a
  Server-Sent Events stream: ``data: {"token": id, "n": i}`` per token,
  then ``event: done`` with the whole output when the request finished
  or was cancelled, or ``event: error`` with ``{"rid", "reason",
  "output_ids"}`` when the engine ended it (``error``, ``poisoned``,
  ``slo_shed``, ``drained``).  A client that hangs up (the keepalive
  write fails) or a ``timeout_s`` that expires cancels the request
  (``Request.cancel()``): the engine evicts it at its next boundary.  An
  ``X-Graft-Trace`` header carries the request's trace id.
* ``POST /drain`` — asks the attached engine to drain
  (``request_drain()``) and answers 202 at once.

The server binds loopback (``127.0.0.1``) unless a caller names another
host.  A ``ServingEngine`` started with ``metrics_port`` > 0 starts the
scrape endpoint, one with ``http_port`` > 0 the serve endpoint, on
loopback only (the serve route accepts work); both attach the engine.
:func:`serve` with port 0 binds an ephemeral port.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from . import export as _export
from . import metrics as _metrics

__all__ = ["MetricsServer", "serve", "start_metrics", "stop", "current",
           "attach_engine", "current_engine", "start_serving",
           "serving_server"]


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle_tpu_torch_metrics/1.0"

    def _engine(self):
        """The serving engine THIS server fronts: the per-server binding
        (``MetricsServer(engine=...)`` — one frontend per replica in an
        in-process fleet) wins over the process-global
        :func:`attach_engine` registration."""
        ref = getattr(self.server, "_engine_ref", None)
        eng = ref() if ref is not None else None
        return eng if eng is not None else current_engine()

    def _send(self, code: int, content_type: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        try:
            url = urlparse(self.path)
            if url.path == "/metrics":
                body = _export.render_prometheus().encode()
                self._send(200,
                           "text/plain; version=0.0.4; charset=utf-8",
                           body)
            elif url.path == "/metrics/snapshot":
                # mergeable registry state and the engine's evidence:
                # counters and gauges as numbers, quantile instruments as
                # sketch bucket states (merged by bucket addition)
                doc = _export.local_snapshot(engine=self._engine())
                self._send(200, "application/json",
                           json.dumps(doc, default=repr).encode())
            elif url.path == "/healthz":
                doc = {"ok": True, "pid": os.getpid(),
                       "unix_time": round(time.time(), 3),
                       "metrics_enabled": _metrics.enabled()}
                # readiness: with a serving engine attached, 503 with
                # {"ready": false, "reason": "warmup"} until warmup ended
                # and admission opened (and "draining" once a drain was
                # asked for), then the engine's evidence.  With no engine
                # it stays the liveness check.
                eng = self._engine()
                if eng is not None:
                    try:
                        doc.update(eng.health())
                    except Exception:  # noqa: BLE001 - probe must answer
                        pass
                code = 503 if doc.get("ready") is False else 200
                self._send(code, "application/json",
                           json.dumps(doc).encode())
            elif url.path == "/requests":
                try:
                    n = int(parse_qs(url.query).get("n", ["64"])[0])
                except (ValueError, IndexError):
                    n = 64
                body = json.dumps(_export.recent_requests(n),
                                  default=repr).encode()
                self._send(200, "application/json", body)
            else:
                self._send(404, "text/plain; charset=utf-8",
                           b"not found; endpoints: /metrics /healthz "
                           b"/requests\n")
        except BrokenPipeError:  # scraper hung up mid-response
            pass

    # ------------------------------------------ POST /generate (SSE)
    def do_POST(self) -> None:  # noqa: N802 - http.server API
        try:
            url = urlparse(self.path)
            if url.path == "/generate":
                self._generate()
            elif url.path == "/drain":
                self._drain()
            else:
                self._send(404, "text/plain; charset=utf-8",
                           b"not found; POST endpoints: /generate "
                           b"/drain\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up; _generate already propagated cancel

    def _drain(self) -> None:
        eng = self._engine()
        if eng is None:
            self._send(503, "application/json",
                       b'{"error": "no serving engine attached"}')
            return
        eng.request_drain()
        self._send(202, "application/json", json.dumps(
            {"draining": True,
             "running": eng.B - len(eng.free_slots),
             "waiting": len(eng.waiting)}).encode())

    def _sse(self, payload: dict, event: Optional[str] = None) -> None:
        head = f"event: {event}\n" if event else ""
        self.wfile.write(
            (head + "data: " + json.dumps(payload) + "\n\n").encode())
        self.wfile.flush()

    def _generate(self) -> None:
        eng = self._engine()
        if eng is None:
            self._send(503, "application/json",
                       b'{"error": "no serving engine attached"}')
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt_ids = [int(t) for t in body["prompt_ids"]]
        except (KeyError, TypeError, ValueError) as e:
            self._send(400, "application/json", json.dumps(
                {"error": f"bad request body: {e!r}"}).encode())
            return
        from ..inference.serving import Request
        from . import tracing as _tracing
        # trace context: a client (or a router) ships `X-Graft-Trace:
        # <trace_id>-<span_id>`; the id threads into the Request so every
        # lifecycle and flight record of it carries the trace
        trace_id, parent_span = _tracing.parse_header(
            self.headers.get(_tracing.TRACE_HEADER))
        req = Request(
            prompt_ids,
            max_new_tokens=int(body.get("max_new_tokens", 32)),
            eos_token_id=body.get("eos_token_id"),
            do_sample=bool(body.get("do_sample", False)),
            temperature=float(body.get("temperature", 1.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            seed=body.get("seed"),
            priority=int(body.get("priority", 0)),
            trace_id=trace_id, parent_span=parent_span)
        timeout_s = float(body.get("timeout_s", 120.0))
        # the stream queue must exist BEFORE enqueue: the engine thread
        # may emit the first token between add_request and our loop
        req._stream_q = _queue.Queue()
        try:
            eng.add_request(req)
        except ValueError as e:
            if eng._draining or eng._drain_requested:
                # not the client's fault: this server is going away; 503
                # (not 400) so a router fails the request over to the
                # next replica
                self._send(503, "application/json", json.dumps(
                    {"error": str(e), "reason": "draining",
                     "rid": req.rid}).encode())
                return
            # over_context / capacity rejection: authoritative
            self._send(400, "application/json", json.dumps(
                {"error": str(e), "rid": req.rid}).encode())
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        deadline = time.monotonic() + timeout_s
        i = 0
        try:
            while True:
                try:
                    tok = req._stream_q.get(timeout=0.05)
                except _queue.Empty:
                    if time.monotonic() > deadline:
                        req.cancel()
                        self._sse({"error": "timeout", "rid": req.rid,
                                   "output_ids": list(req.output_ids)},
                                  event="error")
                        return
                    # keepalive comment: also our disconnect probe — a
                    # gone client raises here and the except below
                    # propagates the cancel to the engine
                    self.wfile.write(b": ping\n\n")
                    self.wfile.flush()
                    continue
                if tok is None:         # terminal sentinel
                    outcome = req.outcome or (
                        "finished" if req.done else
                        "slo_shed" if req.shed else "cancelled")
                    if outcome in ("error", "poisoned", "slo_shed",
                                   "drained"):
                        # the engine ended the stream, not the client: a
                        # terminal error frame names why
                        self._sse({"rid": req.rid, "reason": outcome,
                                   "output_ids": list(req.output_ids)},
                                  event="error")
                    else:
                        self._sse({"rid": req.rid, "outcome": outcome,
                                   "output_ids": list(req.output_ids)},
                                  event="done")
                    return
                self._sse({"token": int(tok), "n": i})
                i += 1
        except (BrokenPipeError, ConnectionResetError):
            req.cancel()            # client went away mid-stream

    def log_message(self, format, *args):  # noqa: A002 - http.server API
        pass  # scrapes every few seconds must not spam stderr


class MetricsServer:
    """One running scrape endpoint; ``port`` is the BOUND port (useful
    when constructed with port 0).  ``engine`` binds a specific serving
    engine to THIS server's /generate, /drain and /healthz routes
    (weakly, like :func:`attach_engine`) — the per-replica frontend an
    in-process fleet needs, where the process-global attachment can
    only name one engine."""

    def __init__(self, port: int, host: str = "127.0.0.1", engine=None):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd._engine_ref = (
            weakref.ref(engine) if engine is not None else None)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="paddle-tpu-torch-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def bind_engine(self, engine) -> None:
        """Swap the engine behind this server's routes.  A fleet replica
        keeps ONE frontend for its whole life — the port is the router's
        stable address — while restarts replace the engine behind it."""
        self._httpd._engine_ref = (
            weakref.ref(engine) if engine is not None else None)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_lock = threading.Lock()
_server: Optional[MetricsServer] = None


def serve(port: int, host: str = "127.0.0.1") -> MetricsServer:
    """Start (or return) the process's scrape endpoint.  Idempotent: a
    second call returns the running server regardless of arguments."""
    global _server
    with _lock:
        if _server is None:
            _server = MetricsServer(port, host)
        return _server


def start_metrics(port: int) -> Optional[MetricsServer]:
    """Start the scrape endpoint on loopback when ``port`` > 0 (a serving
    engine's ``metrics_port``), else nothing.  Never raises: a busy port
    must not take down serving."""
    if _server is not None:
        return _server
    if int(port) <= 0:
        return None
    try:
        return serve(int(port))
    except Exception:  # noqa: BLE001 - observability must not kill the job
        return None


def current() -> Optional[MetricsServer]:
    return _server


# The serve endpoint's engine is attached as a weak reference: a
# registered engine must not outlive its owner because a server exists.
_engine_ref = None
_serving_server: Optional[MetricsServer] = None


def attach_engine(engine) -> None:
    """Register the serving engine ``POST /generate`` enqueues into (and
    ``/healthz`` reads readiness from).  ``ServingEngine.run()`` and
    ``serve_forever()`` call it; the last attached engine wins (one
    process, one front door).  ``attach_engine(None)`` detaches."""
    global _engine_ref
    _engine_ref = weakref.ref(engine) if engine is not None else None


def current_engine():
    ref = _engine_ref
    return ref() if ref is not None else None


def start_serving(port: int) -> Optional[MetricsServer]:
    """Start the serve endpoint on ``127.0.0.1:port`` when ``port`` > 0 (a
    serving engine's ``http_port``), else nothing.  Loopback only: the
    route accepts work.  Idempotent; never raises, so a busy port does not
    take down the engine loop."""
    global _serving_server
    if _serving_server is not None:
        return _serving_server
    if int(port) <= 0:
        return None
    try:
        with _lock:
            if _serving_server is None:
                _serving_server = MetricsServer(int(port), "127.0.0.1")
            return _serving_server
    except Exception:  # noqa: BLE001 - the frontend must not kill serving
        return None


def serving_server() -> Optional[MetricsServer]:
    return _serving_server


def stop() -> None:
    global _server, _serving_server
    with _lock:
        if _server is not None:
            _server.close()
            _server = None
        if _serving_server is not None:
            _serving_server.close()
            _serving_server = None
