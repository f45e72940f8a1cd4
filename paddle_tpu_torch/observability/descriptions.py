"""Metric-description registry: the ONE name -> description map behind
the Prometheus exporter's ``# HELP`` lines.  A copy of
``paddle_tpu/observability/descriptions.py``.

Two sources, explicit wins:

* :func:`default` — every instrument created with a non-empty help
  string auto-registers it here (``metrics.Registry._get_or_create``),
  so the exporter and any future surface (docs generator, a /metrics
  index page) read descriptions from one place instead of each
  instrument object.
* :func:`describe` — an explicit operator/override registration, e.g.
  for derived series whose instrument help is empty or wrong.

The exporter emits ``# HELP`` only when :func:`lookup` returns text —
a metric with no description gets a bare ``# TYPE`` line, never a
malformed trailing-space HELP.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["describe", "default", "lookup", "known"]

_lock = threading.Lock()
_defaults: Dict[str, str] = {}
_overrides: Dict[str, str] = {}


def describe(name: str, text: str) -> None:
    """Explicitly register (or override) a metric's description."""
    with _lock:
        _overrides[name] = str(text)


def default(name: str, text: str) -> None:
    """Instrument-creation help; first registration wins (idempotent
    get-or-create instruments re-register on re-import)."""
    if not text:
        return
    with _lock:
        _defaults.setdefault(name, str(text))


def lookup(name: str) -> Optional[str]:
    with _lock:
        text = _overrides.get(name)
        if text is None:
            text = _defaults.get(name)
    return text or None


def known() -> Dict[str, str]:
    """Every described metric (defaults merged under overrides)."""
    with _lock:
        out = dict(_defaults)
        out.update(_overrides)
    return out
