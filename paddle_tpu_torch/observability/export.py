"""Scrape surface: Prometheus text exposition + the request-trace ring.

Counterpart of ``paddle_tpu/observability/export.py``: render the live
metrics registry (counters, gauges, histograms with cumulative buckets
incl. ``+Inf``, quantile sketches as summaries) in Prometheus text
exposition format 0.0.4, which :mod:`.http` serves at ``/metrics``.

Renaming rules: metric names here use dots (``serving.ttft_seconds``);
Prometheus names must match ``[a-zA-Z_:][a-zA-Z0-9_:]*``, so dots (and
anything else illegal) become underscores — ``serving_ttft_seconds``.
Label values are escaped per the exposition spec (backslash, double
quote, newline).

This module also keeps the bounded ring of per-request serving trace
records (:func:`record_request` / :func:`recent_requests`) that
``/requests`` serves — the scrape-surface twin of the flight recorder's
``kind="request"`` events — and the mergeable registry state that
``/metrics/snapshot`` serves (:func:`local_snapshot`: counters and gauges
as numbers, quantile sketches as their bucket states, the JAX package's
``federation.local_snapshot`` wire form).
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import descriptions as _descriptions
from . import metrics as _metrics

__all__ = ["render_prometheus", "record_request", "recent_requests",
           "clear_requests", "registry_state", "local_snapshot"]

SNAPSHOT_SCHEMA = "paddle_tpu_torch.metrics_snapshot/v1"

# the exposition TYPE keyword per registry kind (quantile sketches
# render as Prometheus summaries); unknown kinds are skipped entirely
_TYPE_OF = {"counter": "counter", "gauge": "gauge",
            "histogram": "histogram", "quantile": "summary"}

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(v: Any) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v: Any) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: Dict[str, Any],
                extra: Optional[List[Tuple[str, str]]] = None) -> str:
    pairs = [(sanitize_name(str(k)), escape_label_value(v))
             for k, v in sorted(labels.items())]
    pairs += [(k, v) for k, v in (extra or [])]
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def _series_of(metric) -> List[Tuple[Dict[str, Any], Any]]:
    """Per-kind series snapshot taken UNDER the metric lock: histogram
    raw lists and quantile sketches are live mutable state — a scrape
    racing the serving thread must not tuple-unpack or iterate them
    unlocked (a mid-render _collapse would KeyError the handler)."""
    with metric._lock:
        items = sorted(metric._series.items(), key=lambda kv: repr(kv[0]))
        if metric.kind == "histogram":
            return [(dict(k), (v[0], v[1], v[2], v[3], list(v[4])))
                    for k, v in items]
        if metric.kind == "quantile":
            return [(dict(k), {"quantiles": [(q, v.quantile(q))
                                             for q in metric.quantiles],
                               "sum": v.sum, "count": v.count})
                    for k, v in items]
        return [(dict(k), v) for k, v in items]


def render_prometheus(registry: Optional[_metrics.Registry] = None,
                      name_prefix: str = "") -> str:
    """The registry in text exposition format.  Instruments with no
    recorded series are omitted (same contract as ``snapshot()``).
    ``name_prefix`` is prepended to every sanitized metric name — the
    fleet federation renders its merged registry as ``fleet_*``."""
    if registry is None:
        registry = _metrics._default
    with registry._lock:
        metrics = [registry._metrics[n] for n in sorted(registry._metrics)]
    lines: List[str] = []
    for m in metrics:
        kind = _TYPE_OF.get(m.kind)
        if kind is None:
            continue    # unknown kinds must not emit invalid lines
        series = _series_of(m)
        if not series:
            continue
        name = sanitize_name(name_prefix + m.name)
        # `# HELP` comes from the metric-description registry (explicit
        # describe() wins, instrument help is the auto-registered
        # default); a metric with NO description gets a bare `# TYPE`,
        # never a malformed trailing-space HELP line
        help_text = _descriptions.lookup(m.name) or m.help
        if help_text:
            help_line = help_text.replace("\\", "\\\\") \
                .replace("\n", "\\n")
            lines.append(f"# HELP {name} {help_line}")
        lines.append(f"# TYPE {name} {kind}")
        if m.kind == "counter":
            for labels, v in series:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(v)}")
        elif m.kind == "gauge":
            for labels, v in series:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(v)}")
        elif m.kind == "histogram":
            for labels, raw in series:
                count, total, _mn, _mx, bucket_counts = raw
                cum = 0
                for i, bound in enumerate(m.buckets):
                    cum += bucket_counts[i]
                    le = _fmt_value(bound)
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, [('le', le)])} "
                        f"{_fmt_value(cum)}")
                # the +Inf bucket closes the cumulative series at _count
                lines.append(
                    f"{name}_bucket{_fmt_labels(labels, [('le', '+Inf')])}"
                    f" {_fmt_value(count)}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} {_fmt_value(total)}")
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} "
                    f"{_fmt_value(count)}")
        elif m.kind == "quantile":
            for labels, snap in series:
                for q, val in snap["quantiles"]:
                    if val is None:
                        continue
                    lines.append(
                        f"{name}"
                        f"{_fmt_labels(labels, [('quantile', _fmt_value(q))])}"
                        f" {_fmt_value(val)}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(snap['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{_fmt_value(snap['count'])}")
    return "\n".join(lines) + ("\n" if lines else "")


# -------------------------------------------------------- request ring

_REQ_CAPACITY = 256
_req_lock = threading.Lock()
_requests: deque = deque(maxlen=_REQ_CAPACITY)


def record_request(record: Dict[str, Any]) -> None:
    """Append one finished/rejected request's trace record (serving
    engine calls this at request finalization; gated there on
    the metrics gate)."""
    with _req_lock:
        _requests.append(dict(record, unix_time=round(time.time(), 3)))


def recent_requests(n: int = 64) -> List[Dict[str, Any]]:
    """Last ``n`` request trace records, newest last (the ``/requests``
    endpoint's payload)."""
    n = int(n)
    if n <= 0:
        return []        # items[-0:] would be the WHOLE ring
    with _req_lock:
        items = list(_requests)
    return items[-n:]


def clear_requests() -> None:
    with _req_lock:
        _requests.clear()


# ------------------------------------------------------ mergeable state

def registry_state(registry: Optional[_metrics.Registry] = None
                   ) -> Dict[str, Any]:
    """The registry's mergeable wire state: per metric, its kind, help and
    every series (counters and gauges as numbers, quantiles as sketch
    states).  Histograms are left out: fixed-bucket counts carry no
    mergeable rank bound, and the sketches cover the latencies."""
    if registry is None:
        registry = _metrics._default
    with registry._lock:
        metrics = [registry._metrics[n] for n in sorted(registry._metrics)]
    out: Dict[str, Any] = {}
    for m in metrics:
        if m.kind not in ("counter", "gauge", "quantile"):
            continue
        with m._lock:
            items = list(m._series.items())
        if not items:
            continue
        series = []
        for key, val in items:
            labels = [[str(k), str(v)] for k, v in key]
            if m.kind == "quantile":
                series.append({"labels": labels, "sketch": val.to_state()})
            else:
                series.append({"labels": labels, "value": float(val)})
        out[m.name] = {"kind": m.kind, "help": m.help, "series": series}
    return out


def local_snapshot(engine=None) -> Dict[str, Any]:
    """What ``/metrics/snapshot`` serves: the registry's mergeable state
    and, with a serving engine, its always-on evidence
    (``telemetry_snapshot()``)."""
    doc = {"schema": SNAPSHOT_SCHEMA,
           "unix_time": round(time.time(), 3),
           "pid": os.getpid(),
           "registry": registry_state()}
    if engine is not None:
        try:
            doc["engine"] = engine.telemetry_snapshot()
        except Exception:  # noqa: BLE001 - evidence is best-effort
            pass
    return doc
