"""Runtime observability of the port: the metrics registry, quantile
sketches, timing spans, the flight recorder and the scrape surface.

Counterpart of ``paddle_tpu/observability/``, the parts the serving engine
is built on:

* :mod:`.metrics` — the process-wide Counter / Gauge / Histogram /
  Quantile registry with labels; ``snapshot()`` / ``export_json()`` read
  it; ``metrics.set_enabled(False)`` turns every instrument into one
  boolean check (on by default, as the JAX flag ``enable_metrics``).
* :mod:`.quantiles` — the mergeable fixed-relative-error sketch behind the
  TTFT / TPOT / e2e / queue-wait percentiles.
* :func:`span` — a user-labelled timing span, observed into the
  ``spans.seconds`` histogram; while a ``torch.profiler`` records, it is
  also a ``torch.profiler.record_function`` range on the host timeline
  (the JAX package's ``_HostTracer`` event).
* :mod:`.flight_recorder` — the bounded ring of recent tick records and
  events, dumped as JSON with the registry's snapshot.
* :mod:`.export` (Prometheus text, the ``/requests`` ring, the mergeable
  snapshot), :mod:`.http` (the ``/metrics`` and ``POST /generate``
  endpoint), :mod:`.tracing` and :mod:`.chrome` (trace ids and
  chrome://tracing documents) load on first use.

    from paddle_tpu_torch import observability as obs
    with obs.span("tokenize"):
        ...
    obs.metrics.snapshot()
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from . import descriptions  # noqa: F401
from . import flight_recorder  # noqa: F401
from . import flops  # noqa: F401
from . import metrics  # noqa: F401
from . import quantiles  # noqa: F401
from .metrics import (  # noqa: F401
    counter, export_json, gauge, histogram, quantile, reset, snapshot,
)

__all__ = ["metrics", "descriptions", "quantiles", "flight_recorder",
           "flops", "span", "export", "http", "tracing", "chrome",
           "counter", "gauge", "histogram", "quantile", "snapshot",
           "reset", "export_json"]

_SPAN_SECONDS = metrics.histogram(
    "spans.seconds", "wall time of observability.span regions")


class span:
    """Timing span: a context manager (or ``begin()`` / ``end()``) that
    records wall time into the ``spans.seconds`` histogram, labelled by
    name, and, while a ``torch.profiler`` records, marks the region on
    its host timeline."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self._t0: Optional[float] = None
        self._range = None

    def begin(self) -> "span":
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def end(self) -> Optional[float]:
        if self._t0 is None:
            return None
        t0, self._t0 = self._t0, None
        t1 = time.perf_counter()
        _SPAN_SECONDS.observe(t1 - t0, name=self.name)
        rng, self._range = self._range, None
        if rng is not None:
            rng.__exit__(None, None, None)
        return t1 - t0

    def __enter__(self) -> "span":
        return self.begin()

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


def __getattr__(name):
    # leaf modules only the scrape and trace paths need, loaded lazily
    if name in ("export", "http", "chrome", "tracing"):
        import importlib
        return importlib.import_module("." + name, __name__)
    raise AttributeError(name)
