"""Process-wide runtime metrics: Counter / Gauge / Histogram with labels.

Counterpart of ``paddle_tpu/observability/metrics.py``: one process-global
registry, instruments created once at import time by the modules that
emit them (the serving engine's ``serving.*``, the span histogram), read
by anyone through :func:`snapshot`, :func:`export_json` or the Prometheus
exporter (``export.py``).

* **Near-zero cost when disabled.**  :func:`set_enabled` (the JAX flag
  ``enable_metrics``; on by default) flips one module-global boolean;
  every write path (``inc`` / ``set`` / ``observe``) checks it first and
  returns.
* **Thread-safe.**  Every series changes under one registry lock: the
  serving loop writes while the HTTP handlers read.  The lock is never
  held across a device synchronisation: values are plain Python numbers,
  never tensors, so reading metrics cannot wait for the card.
* **Bounded label cardinality.**  Each metric keeps at most
  ``MAX_SERIES`` distinct label sets; further combinations collapse into
  one ``__overflow__`` series.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "counter", "gauge", "histogram", "quantile",
    "snapshot", "reset", "export_json",
    "enabled", "set_enabled",
]

# The one process-wide switch.  Reads are a plain global load: the whole
# cost of a disabled instrument.
_ENABLED = True


def enabled() -> bool:
    return _ENABLED


def set_enabled(value: bool) -> bool:
    """Turn every instrument of the process on or off; returns the
    previous setting."""
    global _ENABLED
    old, _ENABLED = _ENABLED, bool(value)
    return old


_OVERFLOW_KEY = (("__overflow__", "true"),)


class _Metric:
    """Base: named instrument with labeled series."""

    kind = "metric"
    # the op corpus alone is 300+ names; cap well above it so only true
    # cardinality bugs (e.g. a per-request label) hit the overflow series
    MAX_SERIES = 1024

    def __init__(self, name: str, help: str, lock: threading.RLock):  # noqa: A002
        self.name = name
        self.help = help
        self._lock = lock
        self._series: Dict[Tuple[Tuple[str, Any], ...], Any] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
        if not labels:
            return ()
        key = tuple(sorted(labels.items()))
        if key not in self._series and len(self._series) >= self.MAX_SERIES:
            return _OVERFLOW_KEY
        return key

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    # subclasses: _snapshot_value(raw) -> json-able
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            series = [{"labels": dict(k), "value": self._snapshot_value(v)}
                      for k, v in self._series.items()]
        return {"type": self.kind, "help": self.help, "series": series}

    def _snapshot_value(self, raw):
        return raw


class Counter(_Metric):
    """Monotonically increasing count (ops dispatched, bytes moved...)."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if not _ENABLED:
            return
        with self._lock:
            k = self._key(labels)
            self._series[k] = self._series.get(k, 0) + n

    def inc_key(self, key: Tuple[Tuple[str, Any], ...], n: float = 1) -> None:
        """Hot-path increment with a PRE-FROZEN label key (a sorted tuple
        of (name, value) pairs, as `_key` would build).  Skips kwargs
        construction and the cardinality guard — only for instruments
        whose label sets are statically bounded (the dispatch hot loop
        caches one key per op name)."""
        if not _ENABLED:
            return
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(tuple(sorted(labels.items())), 0)

    def total(self) -> float:
        """Sum over every label series."""
        with self._lock:
            return sum(self._series.values())


class Gauge(_Metric):
    """Point-in-time value (pool occupancy, tokens/sec of the last tick)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._series[self._key(labels)] = v

    def inc(self, n: float = 1, **labels) -> None:
        if not _ENABLED:
            return
        with self._lock:
            k = self._key(labels)
            self._series[k] = self._series.get(k, 0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._series.get(tuple(sorted(labels.items())))


class Histogram(_Metric):
    """Distribution of observations (step seconds, compile seconds).

    Fixed cumulative-style buckets chosen for latencies in seconds; each
    series keeps (count, sum, min, max, per-bucket counts) — enough for
    rate/mean/percentile-band readouts without storing observations.
    """

    kind = "histogram"
    DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                       0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                       10.0, 30.0, 120.0)

    def __init__(self, name, help, lock, buckets=None):  # noqa: A002
        super().__init__(name, help, lock)
        self.buckets: Tuple[float, ...] = tuple(
            sorted(buckets if buckets is not None else self.DEFAULT_BUCKETS))

    def observe(self, v: float, **labels) -> None:
        if not _ENABLED:
            return
        with self._lock:
            k = self._key(labels)
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = [0, 0.0, float("inf"), float("-inf"),
                                       [0] * (len(self.buckets) + 1)]
            s[0] += 1
            s[1] += v
            s[2] = min(s[2], v)
            s[3] = max(s[3], v)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s[4][i] += 1
                    break
            else:
                s[4][-1] += 1

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(tuple(sorted(labels.items())))
            return s[0] if s else 0

    def sum(self, **labels) -> float:  # noqa: A003
        with self._lock:
            s = self._series.get(tuple(sorted(labels.items())))
            return s[1] if s else 0.0

    def percentile(self, q: float, **labels) -> Optional[float]:
        """Percentile estimate by linear interpolation inside the bucket
        holding rank ``q`` (one query API across the fixed-bucket
        histograms and the quantile sketches).  Bucket edges
        are clamped to the observed [min, max], which also gives the
        ``+Inf`` bucket a finite upper edge."""
        with self._lock:
            s = self._series.get(tuple(sorted(labels.items())))
            if s is None or not s[0]:
                return None
            count, _, mn, mx, bucket_counts = s
            bucket_counts = list(bucket_counts)
        rank = min(max(float(q), 0.0), 1.0) * count
        cum = 0.0
        for i, c in enumerate(bucket_counts):
            if not c:
                continue
            lo = self.buckets[i - 1] if i > 0 else mn
            hi = self.buckets[i] if i < len(self.buckets) else mx
            lo = min(max(lo, mn), mx)
            hi = min(max(hi, mn), mx)
            if cum + c >= rank:
                return lo + (hi - lo) * ((rank - cum) / c)
            cum += c
        return mx

    def total_count(self) -> int:
        """Observation count over every label series (telemetry diffs
        this across a step bracket)."""
        with self._lock:
            return sum(s[0] for s in self._series.values())

    def total_sum(self) -> float:
        """Sum of observed values over every label series."""
        with self._lock:
            return sum(s[1] for s in self._series.values())

    def _snapshot_value(self, raw):
        count, total, mn, mx, bucket_counts = raw
        return {"count": count, "sum": total,
                "min": mn if count else None,
                "max": mx if count else None,
                "mean": (total / count) if count else None,
                "buckets": {("+inf" if i == len(self.buckets) else
                             repr(self.buckets[i])): c
                            for i, c in enumerate(bucket_counts) if c}}


class Registry:
    """Named instrument store.  ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent, so module-level instruments survive
    re-imports); a name collision across kinds raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, **kw):  # noqa: A002
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = cls(name, help, self._lock, **kw)
            self._metrics[name] = m
        # the metric-description registry: the exporter's
        # `# HELP` lines read from one process-wide map, not each
        # instrument — registered outside the registry lock
        if help:
            from . import descriptions as _descriptions
            _descriptions.default(name, help)
        return m

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:  # noqa: A002
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",  # noqa: A002
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def quantile(self, name: str, help: str = "",  # noqa: A002
                 alpha: float = 0.01,
                 quantiles: Optional[Sequence[float]] = None):
        """Streaming quantile-sketch instrument (TTFT/TPOT percentiles —
        see :mod:`.quantiles`); rendered as a Prometheus summary."""
        from .quantiles import DEFAULT_QUANTILES, Quantile
        return self._get_or_create(
            Quantile, name, help, alpha=alpha,
            quantiles=tuple(quantiles) if quantiles is not None
            else DEFAULT_QUANTILES)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """All metrics with at least one recorded series (definitions with
        no data are omitted, so "non-empty snapshot" means data flowed)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics if m._series}

    def reset(self) -> None:
        """Clear every series; instrument definitions survive."""
        with self._lock:
            for m in self._metrics.values():
                m.clear()

    def export_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        doc = {"schema": "paddle_tpu_torch.metrics/v1",
               "unix_time": time.time(),
               "metrics": self.snapshot()}
        text = json.dumps(doc, indent=indent, sort_keys=True, default=str)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


# ------------------------------------------------------------ default registry
_default = Registry()


def counter(name: str, help: str = "") -> Counter:  # noqa: A002
    return _default.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:  # noqa: A002
    return _default.gauge(name, help)


def histogram(name: str, help: str = "",  # noqa: A002
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _default.histogram(name, help, buckets)


def quantile(name: str, help: str = "", alpha: float = 0.01,  # noqa: A002
             quantiles: Optional[Sequence[float]] = None):
    return _default.quantile(name, help, alpha, quantiles)


def get(name: str) -> Optional[_Metric]:
    return _default.get(name)


def snapshot() -> Dict[str, Any]:
    return _default.snapshot()


def reset() -> None:
    _default.reset()


def export_json(path: Optional[str] = None, indent: int = 2) -> str:
    return _default.export_json(path, indent)

