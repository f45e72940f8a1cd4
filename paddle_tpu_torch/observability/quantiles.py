"""Streaming quantile sketches for the serving latency surface.

Counterpart of ``paddle_tpu/observability/quantiles.py``, and the same
arithmetic: "what is p99 TTFT right now?" needs a percentile
over an unbounded stream of per-request latencies, readable at any
moment, with O(1) memory and no stored observations.  The structure here
is a fixed-relative-error rank sketch in the DDSketch family (PAPERS.md
production-monitoring idiom; the same shape Datadog/OpenTelemetry ship):

* values land in logarithmic buckets of ratio ``gamma = (1+a)/(1-a)``,
  so any quantile estimate is within relative error ``a`` (default 1%)
  of a true order statistic — a 10 ms p99 is reported in [9.9, 10.1] ms;
* memory is bounded by ``max_bins`` (default 2048 — covers 1 ns..1 h of
  latency at 1% error several times over); overflow collapses the LOWEST
  bins together, preserving accuracy exactly where SLOs look (p90/p99);
* sketches **merge** by bucket-count addition, so per-shard or per-rung
  sketches can be combined without losing the error bound (the property
  P² lacks, and the reason this is the rank-sketch variant).

:class:`Quantile` wraps the sketch as a registry instrument (one sketch
per label set) with the same gate (``metrics.set_enabled``) and lock
discipline as Counter/Gauge/Histogram; the Prometheus exporter renders
it as a `summary` with ``quantile=`` labels.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

from . import metrics as _metrics

__all__ = ["QuantileSketch", "Quantile", "DEFAULT_QUANTILES"]

DEFAULT_QUANTILES = (0.5, 0.9, 0.99)


class QuantileSketch:
    """Mergeable fixed-relative-error quantile sketch (DDSketch-style).

    ``add`` is O(1); ``quantile`` is O(#bins); memory is O(max_bins)
    regardless of stream length.  Values below ``_MIN_VALUE`` (including
    0 — a queue wait can be exactly zero) count in a dedicated zero
    bucket and report as 0.0.
    """

    __slots__ = ("alpha", "gamma", "_log_gamma", "max_bins",
                 "_bins", "_zeros", "count", "sum", "min", "max")

    _MIN_VALUE = 1e-9

    def __init__(self, alpha: float = 0.01, max_bins: int = 2048):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.max_bins = max(int(max_bins), 8)
        self._bins: Dict[int, float] = {}
        self._zeros = 0.0
        self.count = 0.0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -------------------------------------------------------------- update
    def add(self, value: float, weight: float = 1.0) -> None:
        """Record ``value`` with multiplicity ``weight`` (the serving
        harvest imputes one inter-token gap to k tokens at once)."""
        v = float(value)
        w = float(weight)
        if w <= 0 or not math.isfinite(v):
            return
        self.count += w
        self.sum += v * w
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v < self._MIN_VALUE:
            self._zeros += w
            return
        idx = math.ceil(math.log(v) / self._log_gamma)
        self._bins[idx] = self._bins.get(idx, 0.0) + w
        if len(self._bins) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        # fold the lowest bins into one: upper quantiles (where SLOs
        # live) keep the full error bound, the far-left tail degrades
        keys = sorted(self._bins)
        cut = keys[len(keys) - self.max_bins + 1]
        spill = 0.0
        for k in keys:
            if k >= cut:
                break
            spill += self._bins.pop(k)
        self._bins[cut] = self._bins.get(cut, 0.0) + spill

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (same alpha required); returns self."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with alpha {self.alpha} vs "
                f"{other.alpha}")
        for k, w in other._bins.items():
            self._bins[k] = self._bins.get(k, 0.0) + w
        self._zeros += other._zeros
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        while len(self._bins) > self.max_bins:
            self._collapse()
        return self

    # ------------------------------------------------------------- readout
    def quantile(self, q: float) -> Optional[float]:
        """Value at rank ``q`` in [0, 1], within ``alpha`` relative error
        (clamped to the observed [min, max])."""
        if self.count <= 0:
            return None
        q = min(max(float(q), 0.0), 1.0)
        rank = q * self.count
        cum = self._zeros
        if rank <= cum and self._zeros > 0:
            return 0.0
        for idx in sorted(self._bins):
            cum += self._bins[idx]
            if cum >= rank:
                # log-space midpoint of (gamma^(i-1), gamma^i]
                v = 2.0 * self.gamma ** idx / (self.gamma + 1.0)
                return min(max(v, self.min), self.max)
        return self.max

    @property
    def mean(self) -> Optional[float]:
        return (self.sum / self.count) if self.count else None

    # ------------------------------------------------- wire serialization
    def to_state(self) -> Dict[str, object]:
        """JSON-able wire form for cross-process merge (fleet federation).

        Bucket indices become string keys (JSON objects can't have int
        keys); ``from_state(to_state())`` round-trips exactly, so merging
        shipped states preserves the rank-error bound."""
        empty = self.count <= 0
        return {"alpha": self.alpha, "max_bins": self.max_bins,
                "bins": {str(k): w for k, w in self._bins.items()},
                "zeros": self._zeros, "count": self.count, "sum": self.sum,
                "min": None if empty else self.min,
                "max": None if empty else self.max}

    @classmethod
    def from_state(cls, state: Dict[str, object]) -> "QuantileSketch":
        """Rebuild a sketch from :meth:`to_state` output."""
        sk = cls(alpha=float(state.get("alpha", 0.01)),
                 max_bins=int(state.get("max_bins", 2048)))
        for k, w in dict(state.get("bins") or {}).items():
            sk._bins[int(k)] = float(w)
        sk._zeros = float(state.get("zeros", 0.0))
        sk.count = float(state.get("count", 0.0))
        sk.sum = float(state.get("sum", 0.0))
        mn, mx = state.get("min"), state.get("max")
        sk.min = math.inf if mn is None else float(mn)
        sk.max = -math.inf if mx is None else float(mx)
        while len(sk._bins) > sk.max_bins:
            sk._collapse()
        return sk

    def to_dict(self, quantiles: Sequence[float] = DEFAULT_QUANTILES
                ) -> Dict[str, object]:
        empty = self.count <= 0
        return {"count": self.count, "sum": self.sum,
                "min": None if empty else self.min,
                "max": None if empty else self.max,
                "mean": None if empty else self.sum / self.count,
                "quantiles": {repr(float(q)): self.quantile(q)
                              for q in quantiles}}


class Quantile(_metrics._Metric):
    """Registry instrument: one :class:`QuantileSketch` per label set.

    Same contract as the other instruments — ``observe`` is a no-op
    behind the metrics gate, series mutate under the registry
    lock, snapshots are plain JSON-able numbers."""

    kind = "quantile"

    def __init__(self, name, help, lock, alpha: float = 0.01,  # noqa: A002
                 quantiles: Sequence[float] = DEFAULT_QUANTILES):
        super().__init__(name, help, lock)
        self.alpha = alpha
        self.quantiles = tuple(quantiles)

    def observe(self, v: float, weight: float = 1.0, **labels) -> None:
        if not _metrics._ENABLED:
            return
        with self._lock:
            k = self._key(labels)
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = QuantileSketch(self.alpha)
            s.add(v, weight)

    def quantile(self, q: float, **labels) -> Optional[float]:
        with self._lock:
            s = self._series.get(tuple(sorted(labels.items())))
            return s.quantile(q) if s is not None else None

    def count(self, **labels) -> float:
        with self._lock:
            s = self._series.get(tuple(sorted(labels.items())))
            return s.count if s is not None else 0.0

    def sum(self, **labels) -> float:  # noqa: A003
        with self._lock:
            s = self._series.get(tuple(sorted(labels.items())))
            return s.sum if s is not None else 0.0

    def _snapshot_value(self, raw):
        return raw.to_dict(self.quantiles)
